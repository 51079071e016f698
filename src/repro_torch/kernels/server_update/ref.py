"""Plain PyTorch versions of the fused server update and of its
compressed-uplink form.

    d_c  = Δ_c                     (server_update_ref)
    d_c  = scale_c · q_c           (dequant_server_update_ref)
    mean = Σ_c wn_c · d_c          (c ascending)
    m'   = c_mm·m + c_md·(γ·mean)
    x'   = x + c_xd·(γ·mean)

coefs = (c_mm, c_md, c_xd, γ).  The cohort sum runs row by row in ascending
order, each operation rounded to f32 — the kernel's order — so on the card
the kernel agrees with these to the bit.  The emitted ``mean`` is f32 and
undiscounted; a skipped output (``write_x`` / ``write_m`` False) is None.
"""
from __future__ import annotations

import torch


def _close(mean, x, m, coefs, m_dtype, write_x, write_m):
    coefs = coefs.to(torch.float32)
    dmean = coefs[3] * mean
    new_x = new_m = None
    if write_x:
        new_x = (x.to(torch.float32) + coefs[2] * dmean).to(x.dtype)
    if write_m:
        new_m = (coefs[0] * m.to(torch.float32) + coefs[1] * dmean).to(m_dtype or m.dtype)
    return new_x, new_m, mean


def server_update_ref(deltas, wn, x, m, coefs, m_dtype=None,
                      write_x: bool = True, write_m: bool = True):
    wn = wn.to(torch.float32)
    mean = torch.zeros(deltas.shape[-1], dtype=torch.float32, device=deltas.device)
    for c in range(deltas.shape[0]):
        mean = mean + deltas[c].to(torch.float32) * wn[c]
    return _close(mean, x, m, coefs, m_dtype, write_x, write_m)


def dequant_server_update_ref(q, scale, wn, x, m, coefs, m_dtype=None,
                              write_x: bool = True, write_m: bool = True):
    """q ``(C, P)`` int8 or bf16, scale ``(C,)`` or ``(C, 1)`` f32."""
    wn = wn.to(torch.float32)
    scale = scale.to(torch.float32).reshape(-1)
    mean = torch.zeros(q.shape[-1], dtype=torch.float32, device=q.device)
    for c in range(q.shape[0]):
        mean = mean + (q[c].to(torch.float32) * scale[c]) * wn[c]
    return _close(mean, x, m, coefs, m_dtype, write_x, write_m)
