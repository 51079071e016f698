"""Hand-written CUDA kernels of the port, one package per TPU kernel replaced.

Each kernel keeps the reference's three-file layout: ``kernel.py`` binds the
CUDA source in ``repro_torch/csrc`` (ctypes, see ``build.py``), ``ref.py`` is
the same function in plain PyTorch ops, and ``ops.py`` dispatches: the plain
version for tensors on the CPU, the kernel for CUDA tensors — where it
launches or raises, and never falls back.  A ``FakeTensor`` (a dry-run's,
``repro_torch.launch.dryrun``) is no CUDA tensor: given one, a binding
allocates what its launch would and records the launch
(``build.NativeKernel.fake_launch``) without building or launching (``is_fake``).
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor


def coef_vector(values: Iterable, device) -> torch.Tensor:
    """Stack scalar coefficients into one f32 vector on ``device``.

    Tensor entries (η_l, −1/(η_l·K), ...) stay on the device; python floats
    become device fills, so building the vector copies nothing from the
    host and a kernel reads every coefficient from device memory."""
    parts = [
        v.to(torch.float32).reshape(()) if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float32, device=device)  # repro: noqa REP003 -- isinstance-guarded Python scalar
        for v in values
    ]
    return torch.stack(parts)


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor``: a dry-run's operand,
    which has a shape, a dtype and a device but no memory.  A real tensor,
    on the card or the CPU, never is."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, by name: each wrapper
    adds one where it launches its kernel (``build.NativeKernel``)."""
    from repro_torch.kernels.fed_direction import kernel as fd
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.server_update import kernel as su
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return {"fed_direction": fd.KERNEL.launches, "server_update": su.KERNEL.launches,
            "dequant_update": su.DEQUANT_KERNEL.launches,
            "flash_attention": fa.KERNEL.launches, "ssd_scan": ssd.KERNEL.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches of each kernel since ``before`` (a ``launch_counts()``)."""
    return {k: v - before[k] for k, v in launch_counts().items()}
