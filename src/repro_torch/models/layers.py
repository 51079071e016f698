"""Initializers (counterpart of the part of ``repro.models.layers`` the
federated slice uses)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Scaled normal init: std = 1/sqrt(fan_in), drawn from ``generator``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (std * w).to(dtype)
