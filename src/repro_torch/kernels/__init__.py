"""Hand-written CUDA kernels of the port, one package per TPU kernel replaced.

Each kernel keeps the reference's three-file layout: ``kernel.py`` binds the
CUDA source in ``repro_torch/csrc`` (ctypes, see ``build.py``), ``ref.py`` is
the same function in plain PyTorch ops, and ``ops.py`` dispatches: the plain
version for tensors on the CPU, the kernel for CUDA tensors — where it
launches or raises, and never falls back.
"""
from __future__ import annotations

from typing import Iterable

import torch


def coef_vector(values: Iterable, device) -> torch.Tensor:
    """Stack scalar coefficients into one f32 vector on ``device``.

    Tensor entries (η_l, −1/(η_l·K), ...) stay on the device; python floats
    become device fills, so building the vector copies nothing from the
    host and a kernel reads every coefficient from device memory."""
    parts = [
        v.to(torch.float32).reshape(()) if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float32, device=device)
        for v in values
    ]
    return torch.stack(parts)
