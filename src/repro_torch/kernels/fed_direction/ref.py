"""Plain PyTorch version of the fused local step.

    v = c_g·g + c_x·x + Σ_j c_j·aux_j
    x_new = x − η_l·v

with coefs = (η_l, c_g, c_x, c_aux...) exactly as the kernel consumes them,
each operation rounded to f32 in the kernel's order.  A ``(P,)`` aux
broadcasts over the rows of a ``(C, P)`` plane.
"""
from __future__ import annotations

import torch


def fed_direction_ref(x, g, auxes, coefs):
    coefs = coefs.to(torch.float32)
    xf = x.to(torch.float32)
    v = coefs[1] * g.to(torch.float32) + coefs[2] * xf
    for j, a in enumerate(auxes):
        v = v + coefs[3 + j] * a.to(torch.float32)
    return (xf - coefs[0] * v).to(x.dtype)
