"""ctypes binding of ``csrc/ssd_scan.cu``: the Mamba-2 SSD chunked scan, one
block per (batch, head) carrying the (P, N) state across the chunks on chip.
Replaces ``repro/kernels/ssd_scan/kernel.py :: ssd_chunked_pallas``.

For bf16 inputs one call is two launches on the stream (C·Bᵀ once per
(batch, chunk) into a scratch this wrapper allocates, then the scan) and
counts as one launch of the binding."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import is_fake
from repro_torch.kernels.build import NativeKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = NativeKernel(
    "ssd_scan", "ssd_scan_launch",
    # y, state, cb, x, dt, A, B, C | Bsz, S, H, P, N, L | x_sb, x_ss, b_sb, b_ss,
    # c_sb, c_ss | is_bf16, device | stream
    [_P] * 8 + [_I] * 6 + [_L] * 6 + [_I] * 2 + [_P],
)
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 64
CB_TILE = 64  # the C·Bᵀ scratch holds one (64, 64) f32 tile per (batch, chunk)


def _check(x, dt, A, Bm, Cm, chunk):
    """Validate autograd, shapes, dtypes, strides and device (before any
    build or launch); returns ``(Bsz, S, H, P, N)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_scan kernel has no backward, and its outputs would carry no "
                         "gradient: an input requires grad; training takes the plain route "
                         "(use_kernels=False)")
    if x.dim() != 4 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(f"x must be (B, S, H, P) and B, C (B, S, N); got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    shapes = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)), "B": (Bm, (Bsz, S, N)),
              "C": (Cm, (Bsz, S, N))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not (1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan takes P ≤ {MAX_HEAD_DIM}, N ≤ {MAX_STATE}, chunk ≤ "
                         f"{MAX_CHUNK}; got P={P}, N={N}, chunk={chunk}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B and C share one of {DTYPES}; got {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 tensor")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError("x must be contiguous over (H, P) (batch and sequence may be strided)")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("B and C must be contiguous over N (batch and sequence may be strided)")
    for name, t in shapes.items():
        if t[0].device != x.device:
            raise ValueError(f"{name} on {t[0].device}, x on {x.device}")
    if max(Bsz, S, H) >= 2 ** 31:
        raise ValueError("ssd_scan: a dimension is too large")
    return Bsz, S, H, P, N


def scan_flops(Bsz: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """The scan's operations: per chunk of l steps, C·Bᵀ on the causal
    triangle once per (batch, chunk) (the heads share B and C), then per
    (batch, head, chunk) y_diag on the triangle, y_off and the state update."""
    flops = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        tri = n * (n + 1) // 2
        flops += Bsz * 2 * N * tri + Bsz * H * (2 * P * tri + 4 * n * P * N)
    return flops


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int):
    """x ``(B, S, H, P)`` f32/bf16; dt ``(B, S, H)`` f32; A ``(H,)`` f32;
    Bm, Cm ``(B, S, N)`` in x's dtype — CUDA tensors.  Returns ``(y
    (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)``.
    ``FakeTensor`` operands (a dry-run) get the outputs and the scratch
    allocated and a recorded launch (``NativeKernel.fake_launch``), nothing
    built or launched."""
    Bsz, S, H, P, N = _check(x, dt, A, Bm, Cm, chunk)
    fake = is_fake(x, dt, A, Bm, Cm)
    if not fake:
        fn = KERNEL.load()
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {x.device}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    is_bf16 = x.dtype == torch.bfloat16
    cb = torch.empty((Bsz, -(-S // chunk), CB_TILE, CB_TILE) if is_bf16 else (0,),
                     dtype=torch.float32, device=x.device)
    if fake:  # a dry-run: the outputs and the C·Bᵀ scratch the launch allocates, no launch
        KERNEL.fake_launch([x, dt, A, Bm, Cm, y, state],
                           flops=scan_flops(Bsz, S, H, P, N, chunk))
        return y, state
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(fn, y.data_ptr(), state.data_ptr(), cb.data_ptr(), x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), Bsz, S, H, P, N, chunk,
                  x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
                  Cm.stride(1), int(is_bf16), device, stream)
    return y, state
