"""Fault injection and uplink quarantine primitives (pure mask/plane math).

Counterpart of ``repro.core.faults``: the payload is the cohort's ``(C, P)``
delta plane, or on the per-leaf tree path a tree of ``(C, …)`` leaves (a
plane is a one-leaf tree).  The fault model lives in
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

from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.utils import draws
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten

CORRUPT_MODES = ("nan", "inf", "noise")
STREAM_DROP, STREAM_DEADLINE, STREAM_CORRUPT, STREAM_NOISE = 1, 2, 3, 4


class FaultPlan(NamedTuple):
    """Per-(round, client) fault draws for one cohort.

    drop: (C,) bool — uplink lost (drop_rate) or past the deadline
    corrupt: (C,) bool — payload arrives corrupted
    noise: (C, P) f32 standard normals under corrupt_mode "noise", or, for a
        share of the plane, a callable giving leaf i's ``(C, n_i)``; else None
    """

    drop: torch.Tensor
    corrupt: torch.Tensor
    noise: Optional[Union[torch.Tensor, Callable[[int], torch.Tensor]]]


def fault_masks(fault, t, ids: torch.Tensor, size: int = 0, *, noise_ids=None, columns=None,
                u_drop=None, z_deadline=None, u_corrupt=None, z_noise=None) -> FaultPlan:
    """Reproducible per-client fault draws for absolute round ``t`` (a
    device tensor).  ``size`` is the plane length P the "noise" mode draws
    over, for the rows of ``noise_ids`` (default ``ids``; a cohort shard
    draws its own rows only).  ``columns`` (a model group's share of the
    plane, ``core.flat.GroupPlane.columns``: leaf i → its whole-plane
    column indices) makes the noise a callable that draws leaf i's columns
    of the whole rows when asked, a row at a time (``draws.normal_at``), so
    no whole row and no ``(C, P_r)`` index exists.  An injected draw
    replaces the hash's: ``u_drop`` / ``u_corrupt`` (C,) uniforms,
    ``z_deadline`` (C,) normals, ``z_noise`` the noise rows' normals (the
    whole rows under ``columns``, of which each leaf takes its columns)."""
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
        rows = ids if noise_ids is None else noise_ids
        if fault.corrupt_mode == "noise" and columns is None:
            noise = z_noise if z_noise is not None else draws.normal(
                fault.seed, t, STREAM_NOISE, rows, size)
        elif fault.corrupt_mode == "noise":
            def noise(i: int) -> torch.Tensor:
                cols = columns(i)
                if z_noise is not None:
                    return z_noise.index_select(1, cols)
                return torch.cat([draws.normal_at(fault.seed, t, STREAM_NOISE, rows[c:c + 1], cols)
                                  for c in range(rows.shape[0])])
    return FaultPlan(drop=drop, corrupt=corrupt, noise=noise)


def row_size(x) -> int:
    """Elements of one client's payload: ``P`` of a ``(C, P)`` plane, the
    sum over leaves of a tree of ``(C, …)`` leaves."""
    return sum(l[0].numel() for l in tree_leaves(x))


def corrupt_uplink(fault, cmask: torch.Tensor, noise: Optional[torch.Tensor], x):
    """Corrupt the rows of the payload ``x`` (a ``(C, P)`` plane or a tree
    of ``(C, …)`` leaves) where ``cmask`` is True; other rows pass through
    bitwise.  Under "noise" ``noise`` is ``(C, row_size(x))``: a tree's
    leaves take its columns in leaf order; or a callable giving leaf i's
    ``(C, n_i)`` (``fault_masks(..., columns=)``)."""
    mode = fault.corrupt_mode
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt_mode {mode!r}; known: nan | inf | noise")
    leaves, treedef = tree_flatten_with_path(x)
    out, off = [], 0
    for i, (_, leaf) in enumerate(leaves):
        cm = cmask.reshape(-1, *([1] * (leaf.dim() - 1)))
        if mode in ("nan", "inf"):
            fill = torch.full((), float("nan") if mode == "nan" else float("inf"),
                              dtype=leaf.dtype, device=leaf.device)
            out.append(torch.where(cm, fill, leaf))
            continue
        n = leaf[0].numel()
        z = (noise(i) if callable(noise) else noise[:, off:off + n]).reshape(leaf.shape)
        off += n
        noisy = leaf + (fault.noise_scale * torch.abs(leaf.to(torch.float32)) * z).to(leaf.dtype)
        out.append(torch.where(cm, noisy, leaf))
    return tree_unflatten(treedef, out)


def rows_finite(x) -> torch.Tensor:
    """(C,) bool: is every element of client c's payload finite?"""
    ok = None
    for leaf in tree_leaves(x):
        f = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def rows_sqnorm(x) -> torch.Tensor:
    """(C,) f32: squared L2 norm of each client's payload."""
    s = None
    for leaf in tree_leaves(x):
        q = torch.square(leaf.to(torch.float32)).reshape(leaf.shape[0], -1).sum(dim=1)
        s = q if s is None else s + q
    return s


def zero_rows(x, bad: torch.Tensor):
    """Set quarantined rows to exact zeros in every leaf.  Zeroing (not
    only a zero weight) is load-bearing: 0·NaN = NaN in the fold, while an
    exact-zero row adds ±0, which leaves the sum bitwise."""
    return tree_map(lambda leaf: torch.where(
        bad.reshape(-1, *([1] * (leaf.dim() - 1))),
        torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf), x)


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
