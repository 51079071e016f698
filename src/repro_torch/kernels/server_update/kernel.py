"""ctypes bindings of ``csrc/server_update.cu``: masked cohort mean, momentum
EMA and server step in one pass over the ``(C, P)`` uplink plane.

``server_update_flat`` folds a dense f32/bf16 delta plane and replaces
``repro/kernels/server_update/kernel.py :: server_update_flat``;
``dequant_update_flat`` folds a compressed int8/bf16 plane with its per-row
scales, dequantizing in registers, and replaces ``:: dequant_update_flat``.
Both entry points share one CUDA source and one build; each has its own
``NativeKernel``, so their launches are counted apart.

``fold_plan`` is the kernel's launch plan (column tile, rows per ring
stage, stages, grid, dynamic shared bytes), computed here from the plane's
shape and the card's SM count and shared-memory limit, and passed to the C
entry points, which check it and launch it.  ``row_window`` is the
kernel's rule for the bytes of a plane row that a bulk copy may read."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import is_fake
from repro_torch.kernels.build import NativeKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = NativeKernel(
    "server_update", "server_update_launch",
    # mean, new_x, new_m, deltas, wn, x, m, coefs | C, P | d_bf16, m_bf16,
    # x_bf16, write_x, write_m | tile, rows, stages, grid, smem_bytes |
    # device | stream
    [_P] * 8 + [_I, _L] + [_I] * 5 + [_I] * 5 + [_I, _P],
)
DEQUANT_KERNEL = NativeKernel(
    "dequant_update", "dequant_update_launch",
    # mean, new_x, new_m, q, scale, wn, x, m, coefs | C, P | q_bf16, m_bf16,
    # x_bf16, write_x, write_m | tile, rows, stages, grid, smem_bytes |
    # device | stream
    [_P] * 9 + [_I, _L] + [_I] * 5 + [_I] * 5 + [_I, _P],
    source="server_update",
)
DTYPES = (torch.float32, torch.bfloat16)
Q_DTYPES = (torch.int8, torch.bfloat16)

# csrc/server_update.cu: kMaxTile (8 columns for each of 256 consumer
# threads), kMaxStages, kBarrierBytes
MAX_TILE, MAX_STAGES, BARRIER_BYTES = 2048, 4, 128
ROW_BYTES = 4096  # a row's bytes in a full tile: the bulk-copy engine's cost is per copy
# bytes of one ring stage, window padding included: an f32 plane's stages
# fill an SM with one block; 1- and 2-byte planes fold twice the columns a
# byte, and get two blocks an SM (twice the consumer warps)
STAGE_BYTES = {4: 64 * 1024, 2: 32 * 1024, 1: 32 * 1024}
STAGES = 3  # one stage folded while two are in flight
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
SM_RESERVED = 1024  # shared bytes the card keeps per resident block


class FoldPlan(NamedTuple):
    """One fold launch: ``grid`` persistent blocks walk ``tiles`` column
    tiles of ``tile`` columns; each tile's C rows stream through a ring of
    ``stages`` stages of ``rows`` rows (``groups`` stages a tile);
    ``smem_bytes`` of dynamic shared memory a block."""
    tile: int
    rows: int
    stages: int
    grid: int
    smem_bytes: int
    tiles: int
    groups: int

    def args(self) -> Tuple[int, int, int, int, int]:
        return self.tile, self.rows, self.stages, self.grid, self.smem_bytes


def slot_bytes(tile: int, itemsize: int) -> int:
    """Shared bytes of one row segment in a stage: the 16-byte aligned
    window around ``tile`` elements is at most this long."""
    return tile * itemsize + 16


def weights_bytes(rows: int) -> int:
    """Shared bytes of the consumers' two tables (by item parity) of a row
    group's wn and scale values, f32."""
    return 16 * rows


def smem_bytes(tile: int, rows: int, stages: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory: the mbarriers, two f32 column
    tiles (running sums, then the mean), the weight tables, then the ring
    of ``stages`` × ``rows`` slots."""
    ring = stages * rows * slot_bytes(tile, itemsize)
    return BARRIER_BYTES + 8 * tile + weights_bytes(rows) + ring


def fold_plan(C: int, P: int, itemsize: int, sm_count: int, smem_limit: int) -> FoldPlan:
    """The launch plan of a fold over a ``(C, P)`` plane of ``itemsize``
    bytes an element, on a card with ``sm_count`` SMs and ``smem_limit``
    bytes of opt-in shared memory a block.

    The tile is a multiple of 16 columns, at most ``MAX_TILE`` and
    ``ROW_BYTES`` a row; on a plane too narrow to give every SM a full
    tile, the least such tile that still makes at most one wave of tiles
    (the main path's (25, 22026) gets 126 tiles of 176 columns on 132 SMs).
    A stage holds as many whole rows as fit in ``STAGE_BYTES`` (all 25 at
    the main path's plane), and the grid as many blocks as fit on the card
    at once, at most one per tile."""
    if C < 1 or P < 0:
        raise ValueError(f"a fold needs C >= 1 and P >= 0, got C={C}, P={P}")
    if itemsize not in (1, 2, 4):
        raise ValueError(f"itemsize must be 1, 2 or 4, got {itemsize}")
    if sm_count < 1:
        raise ValueError(f"sm_count must be >= 1, got {sm_count}")
    per_sm = -(-max(P, 1) // sm_count)
    tile = max(16, min(MAX_TILE, ROW_BYTES // itemsize, -(-per_sm // 16) * 16))
    tiles = -(-max(P, 1) // tile)
    slot = slot_bytes(tile, itemsize)
    fits = (smem_limit - smem_bytes(tile, 0, 0, itemsize)) // (STAGES * slot + weights_bytes(1))
    rows = min(C, STAGE_BYTES[itemsize] // slot, fits)
    if rows < 1:
        raise ValueError(f"{smem_limit} bytes of shared memory hold no stage of {slot}-byte rows")
    groups = -(-C // rows)
    smem = smem_bytes(tile, rows, STAGES, itemsize)
    fit = min(BLOCKS_PER_SM, (smem_limit + SM_RESERVED) // (smem + SM_RESERVED))
    grid = min(tiles, sm_count * fit)
    stages = min(STAGES, -(-tiles // grid) * groups)  # a block with one item needs one stage
    return FoldPlan(tile, rows, stages, grid, smem_bytes(tile, rows, stages, itemsize), tiles,
                    groups)


def row_window(a: int, b: int, base16: int, end16: int) -> Tuple[int, int, int]:
    """``(w0, lo, hi)`` for the bytes ``[a, b)`` of one row segment, as
    ``row_window`` in ``csrc/server_update.cu``: the segment's 16-byte
    aligned window starts at ``w0``; a bulk copy reads ``[lo, hi)``, the
    window clipped to its array's aligned interior ``[base16, end16)``
    (nothing when ``hi <= lo``); the segment's bytes outside it, fewer than
    32, are loaded element by element.  The row's shared slot holds the
    byte at address ``q`` at offset ``q - w0``.  x's and m's windows are
    prefetched into L2 by the same rule."""
    w0 = a & ~15
    w1 = (b + 15) & ~15
    return w0, max(w0, base16), min(w1, end16)


@functools.lru_cache(maxsize=None)
def _device_limits(device: int) -> Tuple[int, int]:
    """(SM count, opt-in shared bytes a block) of a CUDA device: a block
    may use the SM's shared memory less the 1 KB the card reserves for it."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_multiprocessor - SM_RESERVED


@functools.lru_cache(maxsize=256)
def device_plan(C: int, P: int, itemsize: int, device: int) -> FoldPlan:
    """``fold_plan`` for a CUDA device, cached: one lookup a launch."""
    return fold_plan(C, P, itemsize, *_device_limits(device))


def _check_operands(plane, plane_dtypes, wn, x, m, coefs, m_dtype, write_x, write_m,
                    extra=()):
    """Validate shapes, dtypes, contiguity and device of a fold launch's
    operands (before any build or launch); returns ``(C, P)``."""
    if plane.dim() != 2:
        raise ValueError(f"plane must be (C, P), got {tuple(plane.shape)}")
    C, P = plane.shape
    used = [("plane", plane, plane_dtypes), ("wn", wn, (torch.float32,)),
            ("coefs", coefs, (torch.float32,)), *extra]
    if write_x:
        used.append(("x", x, DTYPES))
    if write_m:
        used.append(("m", m, DTYPES))
        if m_dtype is not None and m_dtype != m.dtype:
            raise ValueError(f"m_dtype {m_dtype} differs from m's dtype {m.dtype}")
    shapes = {"plane": (C, P), "wn": (C,), "scale": (C,), "coefs": (4,), "x": (P,),
              "m": (P,)}
    for name, t, dtypes in used:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} dtype {t.dtype} not supported ({dtypes})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != plane.device:
            raise ValueError(f"{name} on {t.device}, plane on {plane.device}")
    if C >= 2 ** 31:
        raise ValueError(f"cohort too large: C={C}")
    return C, P


def _launch(binding, plane, per_row, wn, x, m, coefs, write_x, write_m):
    """Allocate the outputs and launch ``binding`` (CUDA tensors only);
    ``per_row`` holds the tensors whose pointers sit between the plane and
    ``wn`` in the C signature (the dequant scale).  ``FakeTensor``
    operands (a dry-run) get the outputs and a recorded launch
    (``NativeKernel.fake_launch``), nothing built or launched."""
    read = [plane, *per_row, wn, coefs, x if write_x else None, m if write_m else None]
    fake = is_fake(*[t for t in read if t is not None])
    if not fake:
        fn = binding.load()
        if plane.device.type != "cuda":
            raise ValueError(f"{binding.name} kernel needs CUDA tensors, got {plane.device}")
    C, P = plane.shape
    mean = torch.empty((P,), dtype=torch.float32, device=plane.device)
    new_x = torch.empty_like(x) if write_x else None
    new_m = torch.empty_like(m) if write_m else None
    if fake:  # a dry-run: the launch's outputs, no launch
        binding.fake_launch([*read, mean, new_x, new_m], flops=2 * C * P + 4 * P)
        return new_x, new_m, mean
    device = (plane.device.index if plane.device.index is not None
              else torch.cuda.current_device())
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    binding.launch(
        fn, mean.data_ptr(),
        new_x.data_ptr() if write_x else None,
        new_m.data_ptr() if write_m else None,
        plane.data_ptr(), *[t.data_ptr() for t in per_row], wn.data_ptr(),
        x.data_ptr() if write_x else None,
        m.data_ptr() if write_m else None,
        coefs.data_ptr(), C, P,
        int(plane.dtype == torch.bfloat16),  # repro: noqa REP003 -- Python flags of the launch
        int(write_m and m.dtype == torch.bfloat16),  # repro: noqa REP003 -- Python flags of the launch
        int(write_x and x.dtype == torch.bfloat16),  # repro: noqa REP003 -- Python flags of the launch
        int(write_x), int(write_m),  # repro: noqa REP003 -- Python flags of the launch
        *device_plan(C, P, plane.element_size(), device).args(), device, stream,
    )
    return new_x, new_m, mean


def server_update_flat(deltas: torch.Tensor, wn: torch.Tensor, x: torch.Tensor,
                       m: torch.Tensor, coefs: torch.Tensor, *, m_dtype=None,
                       write_x: bool = True, write_m: bool = True):
    """deltas: ``(C, P)`` f32/bf16; wn: ``(C,)`` f32 (mask/|S|); x, m:
    ``(P,)`` f32/bf16; coefs: ``(4,)`` f32 (c_mm, c_md, c_xd, γ) on the
    device.  Returns ``(new_x, new_m, mean)``: new_x in x's dtype, new_m in
    m's dtype, mean f32 undiscounted; a skipped output is None and its
    input is neither read nor needed.  ``m_dtype``, if given, must be m's
    dtype (the kernel reads and writes the momentum in one dtype)."""
    _check_operands(deltas, DTYPES, wn, x, m, coefs, m_dtype, write_x, write_m)
    return _launch(KERNEL, deltas, (), wn, x, m, coefs, write_x, write_m)


def dequant_update_flat(q: torch.Tensor, scale: torch.Tensor, wn: torch.Tensor,
                        x: torch.Tensor, m: torch.Tensor, coefs: torch.Tensor, *,
                        m_dtype=None, write_x: bool = True, write_m: bool = True):
    """``server_update_flat`` over a compressed plane: q ``(C, P)`` int8 or
    bf16, scale ``(C,)`` or ``(C, 1)`` f32 per-row dequant scales (ones for
    a bf16 plane); the rest as ``server_update_flat``.  Returns
    ``(new_x, new_m, mean)`` with ``mean`` the f32 undiscounted mean of the
    dequantized plane."""
    if scale.dim() == 2 and scale.shape[-1] == 1:
        scale = scale.reshape(-1)
    _check_operands(q, Q_DTYPES, wn, x, m, coefs, m_dtype, write_x, write_m,
                    extra=(("scale", scale, (torch.float32,)),))
    return _launch(DEQUANT_KERNEL, q, (scale,), wn, x, m, coefs,
                   write_x, write_m)
