"""ctypes bindings of ``csrc/server_update.cu``: masked cohort mean, momentum
EMA and server step in one pass over the ``(C, P)`` uplink plane.

``server_update_flat`` folds a dense f32/bf16 delta plane and replaces
``repro/kernels/server_update/kernel.py :: server_update_flat``;
``dequant_update_flat`` folds a compressed int8/bf16 plane with its per-row
scales, dequantizing in registers, and replaces ``:: dequant_update_flat``.
Both entry points share one CUDA source and one build; each has its own
``NativeKernel``, so their launches are counted apart."""
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
DEQUANT_KERNEL = NativeKernel(
    "dequant_update", "dequant_update_launch",
    # mean, new_x, new_m, q, scale, wn, x, m, coefs | C, P | q_bf16, m_bf16,
    # x_bf16, write_x, write_m, device | stream
    [_P] * 9 + [_I, _L] + [_I] * 6 + [_P],
    source="server_update",
)
DTYPES = (torch.float32, torch.bfloat16)
Q_DTYPES = (torch.int8, torch.bfloat16)


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
    ``per_row`` holds the pointers that sit between the plane and ``wn``
    in the C signature (the dequant scale)."""
    fn = binding.load()
    if plane.device.type != "cuda":
        raise ValueError(f"{binding.name} kernel needs CUDA tensors, got {plane.device}")
    C, P = plane.shape
    mean = torch.empty((P,), dtype=torch.float32, device=plane.device)
    new_x = torch.empty_like(x) if write_x else None
    new_m = torch.empty_like(m) if write_m else None
    device = (plane.device.index if plane.device.index is not None
              else torch.cuda.current_device())
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    binding.launch(
        fn, mean.data_ptr(),
        new_x.data_ptr() if write_x else None,
        new_m.data_ptr() if write_m else None,
        plane.data_ptr(), *per_row, wn.data_ptr(),
        x.data_ptr() if write_x else None,
        m.data_ptr() if write_m else None,
        coefs.data_ptr(), C, P,
        int(plane.dtype == torch.bfloat16),
        int(write_m and m.dtype == torch.bfloat16),
        int(write_x and x.dtype == torch.bfloat16),
        int(write_x), int(write_m), device, stream,
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
    return _launch(DEQUANT_KERNEL, q, (scale.data_ptr(),), wn, x, m, coefs,
                   write_x, write_m)
