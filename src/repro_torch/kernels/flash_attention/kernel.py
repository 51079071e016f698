"""ctypes binding of ``csrc/flash_attention.cu``: blocked online-softmax
attention with GQA, causal and sliding-window masks and ``q_offset``, in the
model's ``(B, S, H, hd)`` layout.  Replaces
``repro/kernels/flash_attention/kernel.py :: flash_attention_bhsd``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import is_fake
from repro_torch.kernels.build import NativeKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = NativeKernel(
    "flash_attention", "flash_attention_launch",
    # out, q, k, v | B, Sq, Skv, H, Hkv, hd, causal, window, q_offset | scale |
    # is_bf16, device | stream
    [_P] * 4 + [_I] * 9 + [ctypes.c_float] + [_I] * 2 + [_P],
)
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256  # hd pads to 64, 128 or 256 inside the kernel


def _check(q, k, v):
    """Validate autograd, shapes, dtypes, contiguity and device (before any
    build or launch); returns ``(B, Sq, Skv, H, Hkv, hd)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention kernel has no backward, and its output would carry "
                         "no gradient: an input requires grad; training takes the plain route "
                         "(use_kernels=False)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Hkv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v must be (B, Skv, Hkv, hd) = {(B, Skv, Hkv, hd)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Hkv}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype}: q, k and v share one of {DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if max(B, Sq, Skv, H) >= 2 ** 31:
        raise ValueError("flash_attention: a dimension is too large")
    return B, Sq, Skv, H, Hkv, hd


def attention_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int],
                    q_offset: int = 0) -> int:
    """The (query, key) pairs the masks keep: query i sits at position
    ``i + q_offset`` and sees key j where ``j <= i + q_offset`` (causal)
    and ``i + q_offset − j < window``; the kernel's products are
    ``4 · hd`` operations a pair and head."""
    total = 0
    for i in range(Sq):
        p = i + q_offset
        hi = min(Skv - 1, p) if causal else Skv - 1
        lo = 0 if window is None else max(0, p - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """q ``(B, Sq, H, hd)``, k and v ``(B, Skv, Hkv, hd)``, contiguous CUDA
    tensors of one dtype (f32 or bf16).  Returns the attention output
    ``(B, Sq, H, hd)`` in q's dtype.  ``window`` None means no sliding
    window; an int window must be positive.  ``FakeTensor`` operands (a
    dry-run) get the output and a recorded launch
    (``NativeKernel.fake_launch``), nothing built or launched."""
    B, Sq, Skv, H, Hkv, hd = _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if is_fake(q, k, v):  # a dry-run: what the launch allocates, no launch
        out = torch.empty_like(q)
        KERNEL.fake_launch([q, k, v, out], flops=4 * hd * B * H * attention_pairs(
            Sq, Skv, causal, window, q_offset))
        return out
    fn = KERNEL.load()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    scale = float(scale if scale is not None else hd ** -0.5)
    out = torch.empty_like(q)
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(fn, out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  B, Sq, Skv, H, Hkv, hd, int(causal), int(window or 0), int(q_offset),
                  scale, int(q.dtype == torch.bfloat16), device, stream)
    return out
