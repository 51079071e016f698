"""Public wrappers of the fused server round-close kernel.

``fused_server_step`` launches one coefficient-row pass; ``fused_fold``
runs all of an ``AlgorithmSpec``'s ``FoldPass`` rows against the cohort's
uplink planes.  A statically-zero coefficient skips the matching output:
a pass with ``c_xd == 0.0`` never rewrites params, one with ``c_md == 0.0,
c_mm == 1.0`` never touches the momentum.  Coefficients go to the kernel
as a device f32 vector (``coef_vector``), so the per-round
c_md = −1/(η_l·K) stays on the device.

Routing is by device: tensors on the CPU take the plain version
(``ref.py``); CUDA tensors take the kernel, which launches or raises.
Only uncompressed planes are folded; the compressed-uplink dequant fold is
ROADMAP A.10.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import _fold_coef, _is_static_one, _is_static_zero
from repro_torch.kernels import coef_vector
from repro_torch.kernels.server_update import kernel
from repro_torch.kernels.server_update.ref import server_update_ref


def fused_server_step(deltas, wn, x, m, c_mm, c_md, c_xd, m_dtype=None,
                      discount=1.0, write_x=True, write_m=True):
    """Masked cohort mean + momentum EMA + param step, one pass over
    ``(C, P)``.  Returns ``(new_x, new_m, mean)`` with ``mean``
    undiscounted; a skipped output comes back None."""
    coefs = coef_vector([c_mm, c_md, c_xd, discount], deltas.device)
    if deltas.device.type == "cpu":
        return server_update_ref(deltas, wn, x, m, coefs, m_dtype,
                                 write_x=write_x, write_m=write_m)
    return kernel.server_update_flat(deltas, wn, x, m, coefs, m_dtype=m_dtype,
                                     write_x=write_x, write_m=write_m)


def fused_fold(spec, cfg, planes, wn, n_active, x, m, eta_l, discount=1.0):
    """Execute the spec's fold rows as fused kernel passes.

    ``planes`` maps plane names to the cohort's raw ``(C, P)`` uplink
    planes; ``wn`` = mask/|S|.  The delta plane is cast to
    ``cfg.aggregate_dtype`` before the reduction, as in the reference.
    Returns ``(new_x, new_m, mean_delta)``."""
    agg_dt = getattr(torch, cfg.aggregate_dtype)
    m_dt = spec.momentum_dtype(cfg)
    mean_delta = None
    for p in spec.fold:
        pv = planes[p.plane]
        if not isinstance(pv, torch.Tensor):
            raise NotImplementedError(
                f"fold over a {type(pv).__name__} plane: compressed uplinks "
                f"and their dequant-fold kernel are ROADMAP A.10")
        c_mm = _fold_coef(p.c_mm, cfg, eta_l, n_active)
        c_md = _fold_coef(p.c_md, cfg, eta_l, n_active)
        c_xd = _fold_coef(p.c_xd, cfg, eta_l, n_active)
        adopt_x = not _is_static_zero(p.c_xd)
        adopt_m = not (_is_static_zero(p.c_md) and _is_static_one(p.c_mm))
        new_x, new_m, mean = fused_server_step(
            pv.to(agg_dt), wn, x, m, c_mm, c_md, c_xd, m_dtype=m_dt,
            discount=discount, write_x=adopt_x, write_m=adopt_m,
        )
        if p.plane == "delta":
            mean_delta = mean
        if adopt_x:
            x = new_x
        if adopt_m:
            m = new_m
    return x, m, mean_delta
