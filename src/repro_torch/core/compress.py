"""Uplink compression as plane transforms, between local steps and fold.

Counterpart of ``repro.core.compress`` on the sync resident flat path.
``repro_torch.configs.base.CompressionConfig`` selects the wire format:

* ``"int8"`` → :class:`QPlane`: per-row absmax scaling (``scale =
  max|row| / 127``, zero rows get scale 1) and stochastic rounding
  ``q = clip(floor(x/scale + u), −127, 127)`` with ``u`` uniform in
  [0, 1).  Unbiased: ``E[q·scale] = x``.  1 byte/element + one f32 scale
  per client row on the wire.
* ``"bf16"`` → a bfloat16 ``(C, P)`` plane (round to nearest even); the
  fold takes it as a :class:`QPlane` with unit scales (``as_qplane``).
* ``"topk"`` → :class:`TopKPlane`: per-row magnitude top-k of the delta
  plane with error feedback — what a client does not send accumulates in
  its residual row (``FedState.residuals``, ``(N, P)`` f32) and is added
  to its next uplink.  8 bytes per kept element (f32 value + int32 index).

Quantizing and sparsifying are plain PyTorch (the reference's are jnp,
outside any Pallas kernel); the int8 and bf16 planes reach the fold
compressed, where the ``dequant_update`` kernel dequantizes them in
registers.  The rounding draw ``u`` comes from ``repro_torch.utils.draws``
keyed by ``(comp.seed, absolute round t, COMPRESS_STREAM + plane index,
client id)``; a caller may inject it instead (the parity tests hand in the
reference's threefry draw).

``torch.topk`` breaks ties differently from ``jax.lax.top_k``: on data
with equal magnitudes at the k-th place the two may send different
elements (ROADMAP queue C).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# plane name → stream index of its rounding draw
PLANE_STREAMS = {"delta": 0, "state_delta": 1, "extra": 2}
# the rounding streams sit above the fault streams (1–4), so a compression
# seed equal to the fault seed still draws independently
COMPRESS_STREAM = 8

INT8_LEVELS = 127.0
KINDS = ("int8", "bf16", "topk")


class QPlane(NamedTuple):
    """Stochastic-rounded int8 representation of an f32 ``(C, P)`` plane;
    also the carrier of a bf16 plane into the dequant fold (``q`` bf16,
    ``scale`` all ones: an f32 multiply by 1.0 is exact)."""

    q: torch.Tensor  # int8 (or bf16) (C, P)
    scale: torch.Tensor  # f32 (C, 1) per-row dequant scale


class TopKPlane(NamedTuple):
    """Top-k sparsified representation of an f32 ``(C, P)`` plane."""

    values: torch.Tensor  # f32 (C, k)
    idx: torch.Tensor  # int64 (C, k) element indices into the plane


def validate_compression(comp) -> None:
    """Raise ValueError on a malformed CompressionConfig."""
    if comp.kind not in KINDS:
        raise ValueError(f"unknown compression kind {comp.kind!r} — expected one of {KINDS}")
    if comp.kind == "topk" and not (0.0 < comp.topk_frac <= 1.0):
        raise ValueError(f"topk_frac must be in (0, 1], got {comp.topk_frac}")


def carries_residuals(comp) -> bool:
    """True when the wire format keeps error-feedback residual rows (top-k)."""
    return comp is not None and comp.kind == "topk"


def init_residuals(comp, num_clients: int, size: int, device=None) -> Optional[torch.Tensor]:
    """The residual rows a run starts with: ``(N, P)`` f32 zeros under
    top-k, None otherwise."""
    if not carries_residuals(comp):
        return None
    return torch.zeros((num_clients, size), dtype=torch.float32, device=device)


def topk_k(comp, n: int) -> int:
    """Kept elements per row under ``kind='topk'``."""
    return max(1, min(n, int(round(comp.topk_frac * n))))


# ---------------------------------------------------------------- int8


def quantize_int8(plane: torch.Tensor, u: torch.Tensor) -> QPlane:
    """Per-row absmax-scaled stochastic rounding to int8; ``u`` is the
    ``(C, P)`` f32 uniform draw in [0, 1)."""
    amax = torch.amax(torch.abs(plane), dim=-1, keepdim=True)
    # zero rows (dropped / quarantined clients) get scale 1 → q stays 0
    one = torch.ones((), dtype=torch.float32, device=plane.device)
    scale = torch.where(amax > 0, amax / INT8_LEVELS, one).to(torch.float32)
    q = torch.clamp(torch.floor(plane / scale + u), -INT8_LEVELS, INT8_LEVELS)
    return QPlane(q=q.to(torch.int8), scale=scale)


def dequantize(rep: QPlane) -> torch.Tensor:
    """QPlane → dense f32 plane."""
    return rep.q.to(torch.float32) * rep.scale


def quantize_bf16(plane: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even bfloat16 (2 bytes/element on the wire)."""
    return plane.to(torch.bfloat16)


def as_qplane(rep) -> QPlane:
    """A dense compressed plane as the dequant fold's operand: a bf16
    plane gets unit scales."""
    if isinstance(rep, QPlane):
        return rep
    return QPlane(q=rep, scale=torch.ones((rep.shape[0], 1), dtype=torch.float32,
                                          device=rep.device))


# ---------------------------------------------------------------- topk


def sparsify_topk(plane: torch.Tensor, k: int) -> TopKPlane:
    """Per-row magnitude top-k."""
    idx = torch.topk(torch.abs(plane), k, dim=-1).indices
    return TopKPlane(values=torch.gather(plane, -1, idx), idx=idx)


def densify_topk(rep: TopKPlane, n: int) -> torch.Tensor:
    """TopKPlane → dense f32 ``(C, n)`` (top-k indices never collide)."""
    out = torch.zeros((rep.values.shape[0], n), dtype=torch.float32,
                      device=rep.values.device)
    return out.scatter(-1, rep.idx, rep.values)


def error_feedback_topk(comp, plane, residual_rows, active, n: int):
    """One error-feedback round for the cohort's delta plane.

    ``plane`` (C, n) is the raw uplink, ``residual_rows`` (C, n) the
    cohort's residuals, ``active`` (C,) the post-fault weight row (a client
    that did not transmit keeps its residual).  Returns ``(rep, recon,
    new_residual_rows)``: ``recon`` is the dense plane the server folds
    (what arrived on the wire) and ``new_residual_rows = accumulated −
    sent`` for active rows."""
    acc = plane + residual_rows
    rep = sparsify_topk(acc, topk_k(comp, n))
    recon = densify_topk(rep, n)
    keep = (active > 0)[:, None]
    new_rows = torch.where(keep, acc - recon, residual_rows)
    # inactive rows fold as zeros, not as their stale accumulator
    recon = torch.where(keep, recon, torch.zeros((), dtype=recon.dtype, device=recon.device))
    return rep, recon, new_rows


# ------------------------------------------------------------ dispatch


def compress_plane(comp, plane: torch.Tensor, u: Optional[torch.Tensor] = None):
    """Dense f32 plane → wire representation (int8 / bf16 kinds); ``u`` is
    the int8 rounding draw."""
    if comp.kind == "int8":
        if u is None:
            raise ValueError("int8 compression needs the (C, P) uniform draw u")
        return quantize_int8(plane, u)
    if comp.kind == "bf16":
        return quantize_bf16(plane)
    raise ValueError(f"compress_plane does not handle kind {comp.kind!r}")


def decompress_plane(rep, n: Optional[int] = None) -> torch.Tensor:
    """Wire representation → dense f32 plane (any kind)."""
    if isinstance(rep, QPlane):
        return dequantize(rep)
    if isinstance(rep, TopKPlane):
        if n is None:
            raise ValueError("densifying a TopKPlane needs the plane length")
        return densify_topk(rep, n)
    return rep.to(torch.float32)


def is_compressed(rep) -> bool:
    """True when ``rep`` is a wire representation rather than dense f32."""
    return (isinstance(rep, (QPlane, TopKPlane))
            or getattr(rep, "dtype", None) == torch.bfloat16)


# ---------------------------------------------------------- accounting


def wire_plane_bytes(comp, size: int, nbytes: int) -> int:
    """Bytes one compressed ``(P,)`` uplink plane costs on the wire;
    ``size`` is the element count, ``nbytes`` the uncompressed byte count
    (returned as it is when ``comp`` is None)."""
    if comp is None:
        return nbytes
    if comp.kind == "bf16":
        return 2 * size
    if comp.kind == "int8":
        return size + 4  # 1 byte/elem + one f32 row scale
    if comp.kind == "topk":
        return topk_k(comp, size) * 8  # f32 value + int32 index per kept
    raise ValueError(f"unknown compression kind {comp.kind!r}")


def uplink_bytes_per_client(comp, wire_planes, size: int, nbytes: int) -> int:
    """Uplink bytes per client per round over a spec's wire planes; under
    ``topk`` only the delta plane is sparsified, others ride f32."""
    total = 0
    for name in wire_planes:
        if comp is not None and comp.kind == "topk" and name != "delta":
            total += nbytes
        else:
            total += wire_plane_bytes(comp, size, nbytes)
    return total
