"""Fault injection and uplink quarantine primitives (pure mask/plane math).

Counterpart of ``repro.core.faults`` on the flat plane: the payload is
the cohort's ``(C, P)`` delta plane (the per-leaf tree forms are the tree
path, ROADMAP A.16).  The fault model lives in
``repro_torch.configs.base.FaultConfig``; this module turns it into masks
and planes, which the engine splices between the local steps and the fold.

Draws come from ``repro_torch.utils.draws``, keyed by ``(fault.seed,
absolute round t, stream, client id)`` with the reference's streams: 1 drop,
2 deadline, 3 corruption, 4 corruption noise.  A client's fate therefore
does not depend on its cohort slot, and a resumed run replays it.  Every
draw can be injected instead (``u_drop``, ``z_deadline``, ``u_corrupt``,
``z_noise``), which is how the parity tests hand the port the reference's
threefry draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.utils import draws

CORRUPT_MODES = ("nan", "inf", "noise")
STREAM_DROP, STREAM_DEADLINE, STREAM_CORRUPT, STREAM_NOISE = 1, 2, 3, 4


class FaultPlan(NamedTuple):
    """Per-(round, client) fault draws for one cohort.

    drop: (C,) bool — uplink lost (drop_rate) or past the deadline
    corrupt: (C,) bool — payload arrives corrupted
    noise: (C, P) f32 standard normals under corrupt_mode "noise", else None
    """

    drop: torch.Tensor
    corrupt: torch.Tensor
    noise: Optional[torch.Tensor]


def fault_masks(fault, t, ids: torch.Tensor, size: int = 0, *, noise_ids=None,
                u_drop=None, z_deadline=None, u_corrupt=None, z_noise=None) -> FaultPlan:
    """Reproducible per-client fault draws for absolute round ``t`` (a
    device tensor).  ``size`` is the plane length P the "noise" mode draws
    over, for the rows of ``noise_ids`` (default ``ids``; a cohort shard
    draws its own rows only).  An injected draw replaces the hash's:
    ``u_drop`` / ``u_corrupt`` (C,) uniforms, ``z_deadline`` (C,) normals,
    ``z_noise`` the noise rows' normals."""
    C, dev = ids.shape[0], ids.device
    drop = torch.zeros((C,), dtype=torch.bool, device=dev)
    if fault.drop_rate > 0.0:
        u = u_drop if u_drop is not None else draws.uniform(fault.seed, t, STREAM_DROP, ids)
        drop = u < fault.drop_rate
    if fault.deadline > 0.0:
        # round time ~ LogNormal(0, σ) in units of the median client
        z = z_deadline if z_deadline is not None else \
            draws.normal(fault.seed, t, STREAM_DEADLINE, ids)
        drop = drop | (torch.exp(fault.straggler_sigma * z) > fault.deadline)
    corrupt = torch.zeros((C,), dtype=torch.bool, device=dev)
    noise = None
    if fault.corrupt_rate > 0.0:
        u = u_corrupt if u_corrupt is not None else \
            draws.uniform(fault.seed, t, STREAM_CORRUPT, ids)
        corrupt = u < fault.corrupt_rate
        if fault.corrupt_mode == "noise":
            noise = z_noise if z_noise is not None else draws.normal(
                fault.seed, t, STREAM_NOISE, ids if noise_ids is None else noise_ids, size)
    return FaultPlan(drop=drop, corrupt=corrupt, noise=noise)


def corrupt_uplink(fault, cmask: torch.Tensor, noise: Optional[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Corrupt the rows of the ``(C, P)`` plane ``x`` where ``cmask`` is
    True; other rows pass through bitwise."""
    mode = fault.corrupt_mode
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt_mode {mode!r}; known: nan | inf | noise")
    cm = cmask[:, None]
    if mode in ("nan", "inf"):
        fill = torch.full((), float("nan") if mode == "nan" else float("inf"),
                          dtype=x.dtype, device=x.device)
        return torch.where(cm, fill, x)
    noisy = x + (fault.noise_scale * torch.abs(x.to(torch.float32)) * noise).to(x.dtype)
    return torch.where(cm, noisy, x)


def rows_finite(x: torch.Tensor) -> torch.Tensor:
    """(C,) bool: is every element of client c's row finite?"""
    return torch.isfinite(x).all(dim=1)


def rows_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """(C,) f32: squared L2 norm of each client's row."""
    return torch.square(x.to(torch.float32)).sum(dim=1)


def zero_rows(x: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Set quarantined rows to exact zeros.  Zeroing (not only a zero
    weight) is load-bearing: 0·NaN = NaN in the fold, while an exact-zero
    row adds ±0, which leaves the sum bitwise."""
    return torch.where(bad[:, None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def nanmedian_midpoint(v: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of the 1-D ``v``, with an even count
    taking the mean of the two middle values — numpy's and
    ``jnp.nanmedian``'s definition (``torch.nanmedian`` takes the lower
    one).  NaN when every entry is NaN.  Stays on the device."""
    s = torch.sort(v).values  # NaN sorts last
    n = (~torch.isnan(v)).sum()
    lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
    hi = torch.clamp(n // 2, max=v.shape[0] - 1).reshape(1)
    return ((s.index_select(0, lo) + s.index_select(0, hi)) * 0.5).reshape(())
