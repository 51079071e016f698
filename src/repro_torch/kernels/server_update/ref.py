"""Plain PyTorch version of the fused server update.

    mean = Σ_c wn_c · Δ_c          (c ascending)
    m'   = c_mm·m + c_md·(γ·mean)
    x'   = x + c_xd·(γ·mean)

coefs = (c_mm, c_md, c_xd, γ).  The cohort sum runs row by row in ascending
order, each operation rounded to f32 — the kernel's order — so on the card
the kernel agrees with this to the bit.  The emitted ``mean`` is f32 and
undiscounted; a skipped output (``write_x`` / ``write_m`` False) is None.
"""
from __future__ import annotations

import torch


def server_update_ref(deltas, wn, x, m, coefs, m_dtype=None,
                      write_x: bool = True, write_m: bool = True):
    coefs = coefs.to(torch.float32)
    wn = wn.to(torch.float32)
    mean = torch.zeros(deltas.shape[-1], dtype=torch.float32, device=deltas.device)
    for c in range(deltas.shape[0]):
        mean = mean + deltas[c].to(torch.float32) * wn[c]
    dmean = coefs[3] * mean
    new_x = new_m = None
    if write_x:
        new_x = (x.to(torch.float32) + coefs[2] * dmean).to(x.dtype)
    if write_m:
        new_m = (coefs[0] * m.to(torch.float32) + coefs[1] * dmean).to(m_dtype or m.dtype)
    return new_x, new_m, mean
