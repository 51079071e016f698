"""Public wrappers of the fused server round-close kernels.

``fused_server_step`` launches one coefficient-row pass over a dense
plane, ``dequant_server_step`` one over a compressed int8/bf16 plane;
``fused_fold`` runs all of an ``AlgorithmSpec``'s ``FoldPass`` rows against
the cohort's uplink planes, a ``QPlane`` through the dequant fold, and
``scatter_fold`` runs them under cohort sharding on this rank's column
block.  A spec with a ``server_fn`` escape hatch has no fold rows:
``fold_means`` (``scatter_means`` under sharding) takes the masked cohort
mean of each plane it reads from the same kernels, one launch a plane with
neither x nor m written, and ``server_fn`` does the rest.  A statically-zero coefficient skips the matching output:
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
from repro_torch.core.flat import cohort_to_columns, gather_plane, gather_rows, plane_chunk
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


def _fold_pass(pv, agg_dt, wn, x, m, c_mm, c_md, c_xd, m_dt, discount, write_x, write_m):
    """One fold launch over the plane ``pv``: the dequant fold for a
    ``QPlane``, else the dense fold over ``pv`` cast to ``agg_dt``."""
    if isinstance(pv, TopKPlane):
        raise TypeError("the fold takes a dense plane or a QPlane; densify a "
                        "TopKPlane first (compress.decompress_plane)")
    if isinstance(pv, QPlane):
        return dequant_server_step(pv.q, pv.scale, wn, x, m, c_mm, c_md, c_xd, m_dtype=m_dt,
                                   discount=discount, write_x=write_x, write_m=write_m)
    return fused_server_step(pv.to(agg_dt), wn, x, m, c_mm, c_md, c_xd, m_dtype=m_dt,
                             discount=discount, write_x=write_x, write_m=write_m)


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
        c_mm = _fold_coef(p.c_mm, cfg, eta_l, n_active)
        c_md = _fold_coef(p.c_md, cfg, eta_l, n_active)
        c_xd = _fold_coef(p.c_xd, cfg, eta_l, n_active)
        adopt_x = not _is_static_zero(p.c_xd)
        adopt_m = not (_is_static_zero(p.c_md) and _is_static_one(p.c_mm))
        new_x, new_m, mean = _fold_pass(planes[p.plane], agg_dt, wn, x, m, c_mm, c_md, c_xd,
                                        m_dt, discount, adopt_x, adopt_m)
        if p.plane == "delta":
            mean_delta = mean
        if adopt_x:
            x = new_x
        if adopt_m:
            m = new_m
    return x, m, mean_delta


def fold_means(spec, cfg, planes, wn, x, m):
    """The masked cohort mean ``Σ_c wn_c·plane_c`` of every plane a
    ``server_fn`` spec reads (``fold_planes``), each from one fold launch
    that writes neither x nor m (x and m only give the plane's length).
    The kernel sums the cohort in ascending c, so the means are bitwise
    those of the fold rows' and do not depend on sharding.  Returns
    ``{plane: (P,) f32 mean}``."""
    agg_dt = getattr(torch, cfg.aggregate_dtype)
    return {name: _fold_pass(planes[name], agg_dt, wn, x, m, 1.0, 0.0, 0.0, None, 1.0,
                             False, False)[2]
            for name in spec.fold_planes}


def _to_columns(spec, planes, group, n_shards):
    """This rank's rows of each plane the spec folds → its ``(C_pad,
    ceil(P/n))`` column block (a ``QPlane`` moves its int8 / bf16 payload
    so and all-gathers its ``(C_loc, 1)`` scales), in ``fold_planes``
    order: every rank runs the same collectives in turn."""
    def to_columns(v):
        if isinstance(v, QPlane):
            return QPlane(q=cohort_to_columns(v.q, group, n_shards),
                          scale=gather_rows(v.scale, group, n_shards))
        return cohort_to_columns(v, group, n_shards)

    return {name: to_columns(planes[name]) for name in spec.fold_planes}


def scatter_fold(spec, cfg, planes, wn, n_active, x, m, eta_l, discount=1.0, *, group,
                 rank: int, n_shards: int):
    """``fused_fold`` under cohort sharding, in each rank of ``group``.

    ``planes`` holds this rank's ``(C_loc, P)`` rows of each uplink plane
    (dense or a ``QPlane``), ``wn`` the padded ``(C_pad,)`` mask/|S| row
    (zeros on pad rows), ``x`` / ``m`` the replicated ``(P,)`` server
    planes.  Three steps:

    1. ``cohort_to_columns``: an ``all_to_all`` turns each plane into the
       ``(C_pad, ceil(P/n))`` column block of this rank — the complete
       cohort for its columns (``_to_columns``);
    2. ``fused_fold`` on the block, with ``plane_chunk`` views of x and m:
       each fold row's kernel sums the cohort in the unsharded order;
    3. ``gather_plane`` rebuilds the replicated planes.

    Returns ``(new_x, new_m, mean_delta)`` as ``fused_fold`` does, bit for
    bit the unsharded fold's."""
    size = x.shape[-1]
    cols = _to_columns(spec, planes, group, n_shards)
    new_x, new_m, mean = fused_fold(spec, cfg, cols, wn, n_active,
                                    plane_chunk(x, rank, n_shards),
                                    plane_chunk(m, rank, n_shards), eta_l, discount=discount)
    return (gather_plane(new_x, group, n_shards, size),
            gather_plane(new_m, group, n_shards, size),
            None if mean is None else gather_plane(mean, group, n_shards, size))


def scatter_means(spec, cfg, planes, wn, x, m, *, group, rank: int, n_shards: int):
    """``fold_means`` under cohort sharding: each plane to this rank's
    column block, its mean-only fold there, and the replicated ``(P,)``
    means gathered back; bit for bit the unsharded ``fold_means``."""
    size = x.shape[-1]
    cols = _to_columns(spec, planes, group, n_shards)
    means = fold_means(spec, cfg, cols, wn, plane_chunk(x, rank, n_shards),
                       plane_chunk(m, rank, n_shards))
    return {k: gather_plane(v, group, n_shards, size) for k, v in means.items()}
