"""Dispatch from an ``AlgorithmSpec`` to the fused local-step kernel.

``flat_direction_step`` resolves the spec's ``DirectionRow`` into the
``(η_l, c_g, c_x, c_aux...)`` device coefficient vector and launches ONE
kernel pass over the whole cohort plane: ``x`` and ``g`` are ``(C, P)``,
the broadcast Δ_t is ``(P,)``.  Statically-zero coefficients drop their
stream — FedCM at α = 1 launches the same zero-aux kernel as FedAvg — and a
nonzero proximal ``c_x`` on ``(x − x_t)`` is distributed onto the kernel's
``c_x·x`` slot plus a ``−c_x·x_t`` aux, as in the reference.

A spec with a ``direction_fn`` escape hatch (a non-affine direction)
bypasses the kernel: ``flat_direction_step`` runs the callable on the
``(P,)`` buffers in plain PyTorch and steps ``x ← x − η_l·v`` in x's dtype,
and ``direction_operands`` refuses it.

Routing is by device: tensors on the CPU take the plain version
(``ref.py``); CUDA tensors take the kernel, which launches or raises.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.registry import _dir_coef, get_algorithm
from repro_torch.kernels import coef_vector
from repro_torch.kernels.fed_direction import kernel
from repro_torch.kernels.fed_direction.ref import fed_direction_ref


def fed_direction(x, g, auxes, coefs) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fed_direction_ref(x, g, auxes, coefs)
    return kernel.fed_direction_flat(x, g, auxes, coefs)


def direction_operands(algo, cfg, m, cst, x0, eta_l) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The aux streams and the device coefficient vector of the spec's
    direction row, for one round (η_l is fixed within a round)."""
    spec = get_algorithm(algo) if isinstance(algo, str) else algo
    if spec.direction_fn is not None:
        raise ValueError(f"{spec.name}: a direction_fn spec launches no fed_direction "
                         f"kernel (flat_direction_step runs its callable)")
    row = spec.direction_row
    c_g = _dir_coef(row.c_g, cfg)
    c_x = _dir_coef(row.c_x, cfg)
    streams = {"momentum": m, "client_state": cst}
    auxes, aux_coefs = [], []
    for stream, c in row.aux:
        c = _dir_coef(c, cfg)
        if c != 0.0:  # static zero: the stream never reaches the kernel
            auxes.append(streams[stream])
            aux_coefs.append(c)
    if c_x != 0.0:
        auxes.append(x0)
        aux_coefs.append(-c_x)
    return auxes, coef_vector([eta_l, c_g, c_x, *aux_coefs], eta_l.device)


def flat_direction_step(algo, cfg, x, g, m, cst, x0, eta_l) -> torch.Tensor:
    """One local step ``x ← x − η_l·v`` on flat buffers: the fused kernel for
    an affine row, the spec's ``direction_fn`` in plain PyTorch for an escape
    hatch (then on one client's ``(P,)`` planes)."""
    spec = get_algorithm(algo) if isinstance(algo, str) else algo
    if spec.direction_fn is not None:
        return (x - eta_l * spec.direction(cfg, m, cst, x, x0, g)).to(x.dtype)
    auxes, coefs = direction_operands(spec, cfg, m, cst, x0, eta_l)
    return fed_direction(x, g, auxes, coefs)
