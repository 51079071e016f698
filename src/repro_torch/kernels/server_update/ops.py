"""Public wrappers of the fused server round-close kernels.

``fused_server_step`` launches one coefficient-row pass over a dense
plane, ``dequant_server_step`` one over a compressed int8/bf16 plane;
``fused_fold`` runs all of an ``AlgorithmSpec``'s ``FoldPass`` rows against
the cohort's uplink planes, a ``QPlane`` through the dequant fold.  A statically-zero coefficient skips the matching output:
a pass with ``c_xd == 0.0`` never rewrites params, one with ``c_md == 0.0,
c_mm == 1.0`` never touches the momentum.  Coefficients go to the kernel
as a device f32 vector (``coef_vector``), so the per-round
c_md = −1/(η_l·K) stays on the device.

Routing is by device: tensors on the CPU take the plain version
(``ref.py``); CUDA tensors take the kernel, which launches or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import QPlane, TopKPlane
from repro_torch.core.registry import _fold_coef, _is_static_one, _is_static_zero
from repro_torch.kernels import coef_vector
from repro_torch.kernels.server_update import kernel
from repro_torch.kernels.server_update.ref import dequant_server_update_ref, server_update_ref


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


def dequant_server_step(q, scale, wn, x, m, c_mm, c_md, c_xd, m_dtype=None,
                        discount=1.0, write_x=True, write_m=True):
    """``fused_server_step`` over a compressed plane: dequantize (int8 or
    bf16 ``q`` × per-row ``scale``), masked mean, EMA and step in one pass;
    the f32 ``(C, P)`` plane is never formed."""
    coefs = coef_vector([c_mm, c_md, c_xd, discount], q.device)
    if q.device.type == "cpu":
        return dequant_server_update_ref(q, scale, wn, x, m, coefs, m_dtype,
                                         write_x=write_x, write_m=write_m)
    return kernel.dequant_update_flat(q, scale, wn, x, m, coefs, m_dtype=m_dtype,
                                      write_x=write_x, write_m=write_m)


def fused_fold(spec, cfg, planes, wn, n_active, x, m, eta_l, discount=1.0):
    """Execute the spec's fold rows as fused kernel passes.

    ``planes`` maps plane names to the cohort's ``(C, P)`` uplink planes,
    dense or as a ``QPlane`` (compressed uplink); ``wn`` = mask/|S|.  A
    dense plane is cast to ``cfg.aggregate_dtype`` before the reduction,
    as in the reference; a ``QPlane`` goes to the dequant fold as it is
    (its representation is the quantization, so ``aggregate_dtype`` does
    not apply).  Returns ``(new_x, new_m, mean_delta)``."""
    agg_dt = getattr(torch, cfg.aggregate_dtype)
    m_dt = spec.momentum_dtype(cfg)
    mean_delta = None
    for p in spec.fold:
        pv = planes[p.plane]
        if isinstance(pv, TopKPlane):
            raise TypeError("the fold takes a dense plane or a QPlane; densify a "
                            "TopKPlane first (compress.decompress_plane)")
        c_mm = _fold_coef(p.c_mm, cfg, eta_l, n_active)
        c_md = _fold_coef(p.c_md, cfg, eta_l, n_active)
        c_xd = _fold_coef(p.c_xd, cfg, eta_l, n_active)
        adopt_x = not _is_static_zero(p.c_xd)
        adopt_m = not (_is_static_zero(p.c_md) and _is_static_one(p.c_mm))
        if isinstance(pv, QPlane):
            new_x, new_m, mean = dequant_server_step(
                pv.q, pv.scale, wn, x, m, c_mm, c_md, c_xd, m_dtype=m_dt,
                discount=discount, write_x=adopt_x, write_m=adopt_m,
            )
        else:
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
