"""ctypes binding of ``csrc/fed_direction.cu``: the fused local step
``x' = x − η_l·(c_g·g + c_x·x + Σ_j c_j·aux_j)`` over a whole cohort plane
in one launch.  Replaces ``repro/kernels/fed_direction/kernel.py ::
fed_direction_flat``, which the reference launches once per client under
``vmap``."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels.build import NativeKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = NativeKernel(
    "fed_direction", "fed_direction_launch",
    # out, x, g, aux0..2, coefs | n, p | x_bf16, g_bf16, n_aux, aux_bf16_mask,
    # aux_bcast_mask, vec_ok, device | stream
    [_P] * 7 + [_L, _L] + [_I] * 7 + [_P],
)
MAX_AUX = 3
DTYPES = (torch.float32, torch.bfloat16)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def fed_direction_flat(x: torch.Tensor, g: torch.Tensor,
                       auxes: Sequence[torch.Tensor],
                       coefs: torch.Tensor) -> torch.Tensor:
    """x: ``(C, P)`` or ``(P,)`` f32/bf16; g: x's shape, f32/bf16; each aux
    x's shape (per client) or ``(P,)`` (broadcast over rows), f32/bf16;
    coefs: ``(3 + len(auxes),)`` f32 on the device.  Returns x' in x's
    dtype, in a new tensor."""
    auxes = list(auxes)
    if len(auxes) > MAX_AUX:
        raise ValueError(f"fed_direction takes at most {MAX_AUX} aux streams, got {len(auxes)}")
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be (P,) or (C, P), got {tuple(x.shape)}")
    P = x.shape[-1]
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    bcast = []
    for a in auxes:
        if a.shape == x.shape:
            bcast.append(False)
        elif a.shape == (P,):
            bcast.append(True)
        else:
            raise ValueError(f"aux {tuple(a.shape)} must be {tuple(x.shape)} or ({P},)")
    for name, t in [("x", x), ("g", g)] + [(f"aux{j}", a) for j, a in enumerate(auxes)]:
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not supported (f32 or bf16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if coefs.dtype != torch.float32 or coefs.shape != (3 + len(auxes),):
        raise ValueError(f"coefs must be f32 ({3 + len(auxes)},), got "
                         f"{coefs.dtype} {tuple(coefs.shape)}")
    if coefs.device != x.device:
        raise ValueError(f"coefs on {coefs.device}, x on {x.device}")

    fn = KERNEL.load()
    if x.device.type != "cuda":
        raise ValueError(f"fed_direction kernel needs CUDA tensors, got {x.device}")
    coefs = coefs.contiguous()
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in auxes] + [None] * (MAX_AUX - len(auxes))
    vec_ok = all(_aligned(t) for t in [x, g, out] + [a for a, b in zip(auxes, bcast) if not b])
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(
        fn, out.data_ptr(), x.data_ptr(), g.data_ptr(), *ptrs, coefs.data_ptr(),
        x.numel(), P,
        int(x.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16), len(auxes),
        sum(1 << j for j, a in enumerate(auxes) if a.dtype == torch.bfloat16),
        sum(1 << j for j, b in enumerate(bcast) if b),
        int(vec_ok), device, stream,
    )
    return out
