"""Plain oracle of FedCM's client update (Algorithm 2 lines 8–9).

    v      = α·g + (1−α)·Δ
    x_new  = x − η_l·v

Counterpart of ``repro/kernels/fedcm_update/ref.py``: the blend runs in
f32 whatever the operands' dtypes, and rounds once, to x's dtype.
"""
from __future__ import annotations

import torch


def fedcm_step_ref(x, g, delta, alpha, eta_l):
    v = alpha * g.to(torch.float32) + (1.0 - alpha) * delta.to(torch.float32)
    return (x.to(torch.float32) - eta_l * v).to(x.dtype)
