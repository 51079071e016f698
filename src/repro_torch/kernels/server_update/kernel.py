"""ctypes binding of ``csrc/server_update.cu``: masked cohort mean, momentum
EMA and server step in one pass over the ``(C, P)`` delta plane.  Replaces
``repro/kernels/server_update/kernel.py :: server_update_flat``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import NativeKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = NativeKernel(
    "server_update", "server_update_launch",
    # mean, new_x, new_m, deltas, wn, x, m, coefs | C, P | d_bf16, m_bf16,
    # x_bf16, write_x, write_m, device | stream
    [_P] * 8 + [_I, _L] + [_I] * 6 + [_P],
)
DTYPES = (torch.float32, torch.bfloat16)


def server_update_flat(deltas: torch.Tensor, wn: torch.Tensor, x: torch.Tensor,
                       m: torch.Tensor, coefs: torch.Tensor, *, m_dtype=None,
                       write_x: bool = True, write_m: bool = True):
    """deltas: ``(C, P)`` f32/bf16; wn: ``(C,)`` f32 (mask/|S|); x, m:
    ``(P,)`` f32/bf16; coefs: ``(4,)`` f32 (c_mm, c_md, c_xd, γ) on the
    device.  Returns ``(new_x, new_m, mean)``: new_x in x's dtype, new_m in
    m's dtype, mean f32 undiscounted; a skipped output is None and its
    input is neither read nor needed.  ``m_dtype``, if given, must be m's
    dtype (the kernel reads and writes the momentum in one dtype)."""
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (C, P), got {tuple(deltas.shape)}")
    C, P = deltas.shape
    used = [("deltas", deltas, DTYPES), ("wn", wn, (torch.float32,)),
            ("coefs", coefs, (torch.float32,))]
    if write_x:
        used.append(("x", x, DTYPES))
    if write_m:
        used.append(("m", m, DTYPES))
        if m_dtype is not None and m_dtype != m.dtype:
            raise ValueError(f"m_dtype {m_dtype} differs from m's dtype {m.dtype}")
    shapes = {"deltas": (C, P), "wn": (C,), "coefs": (4,), "x": (P,), "m": (P,)}
    for name, t, dtypes in used:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} dtype {t.dtype} not supported ({dtypes})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != deltas.device:
            raise ValueError(f"{name} on {t.device}, deltas on {deltas.device}")
    if C >= 2 ** 31:
        raise ValueError(f"cohort too large: C={C}")

    fn = KERNEL.load()
    if deltas.device.type != "cuda":
        raise ValueError(f"server_update kernel needs CUDA tensors, got {deltas.device}")
    mean = torch.empty((P,), dtype=torch.float32, device=deltas.device)
    new_x = torch.empty_like(x) if write_x else None
    new_m = torch.empty_like(m) if write_m else None
    device = (deltas.device.index if deltas.device.index is not None
              else torch.cuda.current_device())
    stream = torch.cuda.current_stream(deltas.device).cuda_stream
    KERNEL.launch(
        fn, mean.data_ptr(),
        new_x.data_ptr() if write_x else None,
        new_m.data_ptr() if write_m else None,
        deltas.data_ptr(), wn.data_ptr(),
        x.data_ptr() if write_x else None,
        m.data_ptr() if write_m else None,
        coefs.data_ptr(), C, P,
        int(deltas.dtype == torch.bfloat16),
        int(write_m and m.dtype == torch.bfloat16),
        int(write_x and x.dtype == torch.bfloat16),
        int(write_x), int(write_m), device, stream,
    )
    return new_x, new_m, mean
