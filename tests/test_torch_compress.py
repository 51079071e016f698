"""Port vs reference: the lossy uplink's pieces — the counter-based draws,
fault injection and quarantine, uplink compression, and the dequant fold's
plain version.

Inputs are made with numpy from a seed and handed to both packages; where
the reference draws with threefry, the same draw is computed with
``jax.random`` and injected into the port.  The reference's Pallas dequant
kernel runs in interpret mode, as its own tests run it.  Three kinds of
check are kept apart (tests/_torch_parity.py states the tolerances):

1. fold-level checks on identical ``(q, scale)`` — within ``RTOL`` of the
   reference, whose cohort sum runs in another order;
2. ``quantize_int8`` on an identical plane and identical ``u`` — bitwise
   (the same f32 operations, so no floor can flip);
3. round-level parity, where a flip is possible — tests/test_torch_uplink.py.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from _torch_parity import ATOL, BF16_RTOL, RTOL, assert_close
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro.configs.base import FaultConfig as RefFaultConfig
from repro.core import compress as rc
from repro.core import faults as rf
from repro.kernels.server_update.ops import dequant_server_step as ref_dequant_server_step
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core import compress as pc
from repro_torch.core import faults as pf
from repro_torch.core.convert import state_from_numpy, to_numpy
from repro_torch.core.engine import check_supported
from repro_torch.core.registry import get_algorithm
from repro_torch.kernels.server_update.ops import dequant_server_step
from repro_torch.kernels.server_update.ref import (
    dequant_server_update_ref,
    server_update_ref,
)
from repro_torch.utils import draws

torch.set_num_threads(1)

BF16 = jnp.bfloat16


def _np(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _u(seed, shape):
    """A threefry uniform draw, as the reference makes its own."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32))


# ------------------------------------------------------------------ draws
def test_uniform_draw_is_uniform_in_unit_interval():
    ids = torch.arange(40)
    u = draws.uniform(7, torch.tensor(3, dtype=torch.int32), 8, ids, 5000).numpy().ravel()
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / u.size)
    assert stats.kstest(u, "uniform").pvalue > 1e-3


def test_normal_draw_is_standard_normal():
    z = draws.normal(1, 0, 4, torch.arange(20), 5000).numpy().ravel()
    assert abs(z.mean()) < 4 / np.sqrt(z.size) and abs(z.std() - 1.0) < 0.01
    assert stats.kstest(z, "norm").pvalue > 1e-3


def test_draw_streams_are_distinct_and_reproducible():
    ids = torch.arange(16)
    base = draws.bits(0, 5, 1, ids, 64)
    assert torch.equal(base, draws.bits(0, torch.tensor(5, dtype=torch.int32), 1, ids, 64))
    others = [draws.bits(1, 5, 1, ids, 64), draws.bits(0, 6, 1, ids, 64),
              draws.bits(0, 5, 2, ids, 64), draws.bits(0, 5, 1, ids + 16, 64)]
    for o in others:  # seed, round, stream and id each change every value
        assert (o != base).float().mean() > 0.99
    flat = base.reshape(-1)
    assert flat.unique().numel() == flat.numel()  # no repeats across (id, j)
    assert int(base.min()) >= 0 and int(base.max()) < 2 ** 32


def test_draw_of_a_client_does_not_depend_on_its_slot():
    ids = torch.tensor([4, 9, 2, 7])
    u = draws.uniform(3, 2, 1, ids, 10)
    perm = torch.tensor([2, 0, 3, 1])
    assert torch.equal(draws.uniform(3, 2, 1, ids[perm], 10), u[perm])
    # the (C,) form is element 0 of the (C, n) form
    assert torch.equal(draws.uniform(3, 2, 1, ids), u[:, 0])


def test_int8_rounding_with_hash_draws_is_unbiased():
    """The mean of dequantize(quantize_int8(x)) over many rounds' draws
    tends to x (the stochastic rounding is unbiased)."""
    rng = np.random.default_rng(0)
    plane = torch.tensor(_np(rng, (2, 64), 3.0))
    ids = torch.tensor([11, 5])
    n = 2048
    acc = torch.zeros_like(plane)
    for t in range(n):
        acc += pc.dequantize(pc.quantize_int8(plane, draws.uniform(1, t, 8, ids, 64)))
    scale = plane.abs().amax(dim=-1, keepdim=True) / 127.0
    # se of the mean of a dithered floor ≤ scale/sqrt(4n); 6σ bound
    assert torch.all((acc / n - plane).abs() <= 6 * scale / np.sqrt(4 * n))


# ------------------------------------------------------------------ int8 / bf16
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bitwise_vs_reference(seed):
    rng = np.random.default_rng(seed)
    plane = _np(rng, (4, 300), 0.05)
    plane[2] = 0.0  # a dropped / quarantined row
    key = jax.random.PRNGKey(seed)
    ref = rc.quantize_int8(jnp.asarray(plane), key)
    u = np.asarray(jax.random.uniform(key, plane.shape, jnp.float32))
    got = pc.quantize_int8(torch.tensor(plane), torch.tensor(u))
    assert got.q.dtype == torch.int8 and got.scale.shape == (4, 1)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.q[2].numpy(), 0)
    assert float(got.scale[2]) == 1.0


def test_quantize_int8_clip_boundary():
    """±absmax lands on ±127 for draws away from 1, an all-zero row stays
    zero with unit scale, and q never leaves [−127, 127] — not even for the
    largest u below 1, where x/scale + u may round to ±128 or ∓126 in f32
    (the reference's formula, so its q is the port's there too)."""
    plane = torch.tensor([[-6.0, 0.0, 6.0, 1e-3], [0.0, 0.0, 0.0, 0.0]])
    for top in (0.0, 0.5, 0.999):
        got = pc.quantize_int8(plane, torch.full(plane.shape, top))
        assert got.q[0, 0] == -127 and got.q[0, 2] == 127
        assert torch.equal(got.q[1], torch.zeros(4, dtype=torch.int8))
        assert float(got.scale[1]) == 1.0
    assert torch.equal(pc.dequantize(got)[0, [0, 2]], torch.tensor([-6.0, 6.0]))
    rng = np.random.default_rng(8)
    rows = torch.tensor(_np(rng, (64, 50)))
    near_one = pc.quantize_int8(rows, torch.full(rows.shape, 1.0 - 2.0 ** -24))
    assert int(near_one.q.max()) == 127 and int(near_one.q.min()) >= -127


def test_quantize_bf16_and_unit_scale_qplane_match_reference():
    rng = np.random.default_rng(3)
    plane = _np(rng, (3, 257))
    got = pc.quantize_bf16(torch.tensor(plane))
    ref = rc.quantize_bf16(jnp.asarray(plane))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref, np.float32))
    rep = pc.as_qplane(got)
    assert isinstance(rep, pc.QPlane) and torch.equal(rep.scale, torch.ones(3, 1))
    assert torch.equal(pc.dequantize(rep), got.float())
    assert pc.is_compressed(got) and pc.is_compressed(rep)
    assert not pc.is_compressed(torch.tensor(plane))


# ------------------------------------------------------------------ top-k
def test_error_feedback_topk_matches_reference_and_keeps_inactive_residual():
    """Continuous data (no ties at the k-th place): the same elements are
    sent, the wire plane and the new residuals match the reference, and an
    inactive row keeps its residual and folds as zeros."""
    rng = np.random.default_rng(4)
    comp_r = RefCompressionConfig(kind="topk", topk_frac=0.2)
    comp_p = CompressionConfig(kind="topk", topk_frac=0.2)
    plane, res = _np(rng, (3, 40)), _np(rng, (3, 40), 0.1)
    active = np.array([1.0, 0.0, 1.0], np.float32)
    rep_r, recon_r, new_r = rc.error_feedback_topk(comp_r, jnp.asarray(plane), jnp.asarray(res),
                                                   jnp.asarray(active), 40)
    rep_p, recon_p, new_p = pc.error_feedback_topk(comp_p, torch.tensor(plane), torch.tensor(res),
                                                   torch.tensor(active), 40)
    assert pc.topk_k(comp_p, 40) == rc.topk_k(comp_r, 40) == 8
    for c in range(3):
        assert set(rep_p.idx[c].tolist()) == set(np.asarray(rep_r.idx)[c].tolist())
    np.testing.assert_array_equal(recon_p.numpy(), np.asarray(recon_r))
    np.testing.assert_array_equal(new_p.numpy(), np.asarray(new_r))
    assert torch.equal(recon_p[1], torch.zeros(40))
    assert torch.equal(new_p[1], torch.tensor(res[1]))
    dense = pc.decompress_plane(rep_p, 40)
    assert torch.equal(dense[0], recon_p[0]) and torch.count_nonzero(dense[0]) == 8


@pytest.mark.parametrize("frac, n", [(0.1, 100), (0.1, 3), (1.0, 7), (0.01, 22026)])
def test_topk_k_matches_reference(frac, n):
    assert pc.topk_k(CompressionConfig(kind="topk", topk_frac=frac), n) == \
        rc.topk_k(RefCompressionConfig(kind="topk", topk_frac=frac), n)


# ------------------------------------------------------------------ accounting
@pytest.mark.parametrize("kind", [None, "int8", "bf16", "topk"])
@pytest.mark.parametrize("wire", [("delta",), ("delta", "state_delta")])
def test_wire_bytes_match_reference(kind, wire):
    P = 22026
    comp_p = None if kind is None else CompressionConfig(kind=kind)
    comp_r = None if kind is None else RefCompressionConfig(kind=kind)
    assert pc.wire_plane_bytes(comp_p, P, 4 * P) == rc.wire_plane_bytes(comp_r, P, 4 * P)
    assert pc.uplink_bytes_per_client(comp_p, wire, P, 4 * P) == \
        rc.uplink_bytes_per_client(comp_r, wire, P, 4 * P)


def test_fedcm_uplink_bytes_at_the_main_width():
    """fedcm at P = 22,026: none / bf16 / int8 / topk 1 % per client."""
    wire = get_algorithm("fedcm").wire_uplink_planes
    got = [pc.uplink_bytes_per_client(c, wire, 22026, 4 * 22026)
           for c in (None, CompressionConfig(kind="bf16"), CompressionConfig(kind="int8"),
                     CompressionConfig(kind="topk", topk_frac=0.01))]
    assert got == [88104, 44052, 22030, 1760]


@pytest.mark.parametrize("kind, frac, match", [("int4", 0.01, "unknown compression kind"),
                                               ("topk", 0.0, "topk_frac"),
                                               ("topk", 1.5, "topk_frac")])
def test_validate_compression_rejects_malformed(kind, frac, match):
    with pytest.raises(ValueError, match=match):
        pc.validate_compression(CompressionConfig(kind=kind, topk_frac=frac))
    with pytest.raises(ValueError, match=match):
        rc.validate_compression(RefCompressionConfig(kind=kind, topk_frac=frac))


@pytest.mark.parametrize("kind", [None, "int8", "bf16", "topk"])
def test_residual_rows_exist_only_under_topk(kind):
    """One rule decides the residual rows: the engine's ``init`` and the
    converter's ``state_from_numpy`` both start from ``init_residuals``."""
    comp = None if kind is None else CompressionConfig(kind=kind)
    assert pc.carries_residuals(comp) == (kind == "topk")
    rows = pc.init_residuals(comp, 6, 484)
    cfg = FedConfig(num_clients=6, compression=comp)
    params = [{"w": np.ones((20, 22), np.float32), "b": np.ones((22,), np.float32)}]
    st, _ = state_from_numpy(params, cfg)
    if kind != "topk":
        assert rows is None and st.residuals is None
        return
    assert rows.shape == (6, 484) and rows.dtype == torch.float32
    assert torch.count_nonzero(rows) == 0
    assert st.residuals.shape == (6, 462) and torch.count_nonzero(st.residuals) == 0


def test_config_copies_have_reference_defaults():
    from dataclasses import fields
    for port, ref in ((FaultConfig, RefFaultConfig), (CompressionConfig, RefCompressionConfig)):
        ref_defaults = {f.name: f.default for f in fields(ref)}
        assert {f.name: f.default for f in fields(port)} == ref_defaults


# ------------------------------------------------------------------ faults
def _ref_fault_draws(fault, t, ids):
    kt = jax.random.fold_in(jax.random.PRNGKey(fault.seed), t)
    one = jax.vmap(lambda k: jax.random.uniform(k, ()))
    return (np.asarray(one(rf._per_client_keys(kt, 1, ids))),
            np.asarray(jax.vmap(lambda k: jax.random.normal(k, ()))(rf._per_client_keys(kt, 2, ids))),
            np.asarray(one(rf._per_client_keys(kt, 3, ids))))


@pytest.mark.parametrize("kw", [dict(drop_rate=0.4), dict(deadline=1.2, straggler_sigma=0.8),
                                dict(corrupt_rate=0.5),
                                dict(drop_rate=0.3, deadline=1.5, corrupt_rate=0.3)])
def test_fault_masks_on_injected_draws_match_reference(kw):
    ids = jnp.arange(20, dtype=jnp.int32) * 3
    ref_f, port_f = RefFaultConfig(seed=9, **kw), FaultConfig(seed=9, **kw)
    plan = rf.fault_masks(ref_f, jnp.int32(4), ids)
    u_drop, z, u_cor = _ref_fault_draws(ref_f, 4, ids)
    got = pf.fault_masks(port_f, torch.tensor(4), torch.tensor(np.asarray(ids)),
                         u_drop=torch.tensor(u_drop), z_deadline=torch.tensor(z),
                         u_corrupt=torch.tensor(u_cor))
    np.testing.assert_array_equal(got.drop.numpy(), np.asarray(plan.drop))
    np.testing.assert_array_equal(got.corrupt.numpy(), np.asarray(plan.corrupt))
    assert got.noise is None


def test_fault_masks_from_hash_are_keyed_by_round_and_id():
    fault = FaultConfig(drop_rate=0.5, corrupt_rate=0.5, seed=2)
    ids = torch.arange(200)
    a = pf.fault_masks(fault, torch.tensor(1), ids)
    assert 60 < int(a.drop.sum()) < 140 and 60 < int(a.corrupt.sum()) < 140
    assert not torch.equal(a.drop, a.corrupt)  # independent streams
    b = pf.fault_masks(fault, torch.tensor(1), ids.flip(0))
    assert torch.equal(b.drop, a.drop.flip(0))
    assert not torch.equal(pf.fault_masks(fault, torch.tensor(2), ids).drop, a.drop)
    n = pf.fault_masks(FaultConfig(corrupt_rate=1.0, corrupt_mode="noise"), 0, ids[:3], 50)
    assert n.noise.shape == (3, 50)


@pytest.mark.parametrize("mode", ["nan", "inf", "noise"])
def test_corrupt_uplink_matches_reference(mode):
    rng = np.random.default_rng(5)
    C, P = 4, 130
    x = _np(rng, (C, P))
    cmask = np.array([True, False, True, False])
    ref_f = RefFaultConfig(corrupt_rate=0.5, corrupt_mode=mode, noise_scale=2.0, seed=3)
    ids = jnp.arange(C, dtype=jnp.int32)
    kt = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    keys = rf._per_client_keys(kt, 4, ids)
    ref = np.asarray(rf.corrupt_uplink(ref_f, jnp.asarray(cmask), keys, jnp.asarray(x)))
    noise = None
    if mode == "noise":
        lk = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
        noise = torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (P,), jnp.float32))(lk)))
    got = pf.corrupt_uplink(FaultConfig(corrupt_rate=0.5, corrupt_mode=mode, noise_scale=2.0),
                            torch.tensor(cmask), noise, torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got[~cmask], x[~cmask])  # untouched rows bitwise
    if mode == "noise":
        assert_close(got, ref, what="noisy rows")
    else:
        np.testing.assert_array_equal(got, ref)
    fin = pf.rows_finite(torch.tensor(got)).numpy()
    np.testing.assert_array_equal(fin, np.asarray(rf.rows_finite(jnp.asarray(got), C)))
    assert_close(pf.rows_sqnorm(torch.tensor(x)).numpy(),
                 np.asarray(rf.rows_sqnorm(jnp.asarray(x), C)), what="sqnorm")
    zeroed = pf.zero_rows(torch.tensor(got), torch.tensor(~fin)).numpy()
    np.testing.assert_array_equal(zeroed, np.asarray(rf.zero_rows(jnp.asarray(got),
                                                                  jnp.asarray(~fin))))


def test_corrupt_uplink_refuses_unknown_mode():
    with pytest.raises(ValueError, match="corrupt_mode"):
        pf.corrupt_uplink(FaultConfig(corrupt_mode="zeros"), torch.ones(2, dtype=torch.bool),
                          None, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="corrupt_mode"):
        check_supported(FedConfig(fault=FaultConfig(corrupt_mode="zeros")))


@pytest.mark.parametrize("values", [[3.0, 1.0, 2.0, 9.0], [3.0, 1.0, 2.0, 9.0, 4.0],
                                    [np.nan, 2.0, np.nan, 5.0], [np.nan, np.nan],
                                    [7.0]])
def test_nanmedian_midpoint_is_the_references_definition(values):
    v = np.asarray(values, np.float32)
    got = float(pf.nanmedian_midpoint(torch.tensor(v)))
    ref = float(jnp.nanmedian(jnp.asarray(v)))
    assert (np.isnan(got) and np.isnan(ref)) or got == ref


def test_store_failure_rate_is_not_ported_yet():
    # ported with the host store: the rate is accepted, and a host store
    # built under it injects failures through FaultyStore
    from repro_torch.data.population import FaultyStore, make_population_store
    cfg = FedConfig(population_store="host", fault=FaultConfig(store_failure_rate=0.1))
    check_supported(cfg)
    assert isinstance(make_population_store(cfg, 4), FaultyStore)
    assert not isinstance(make_population_store(replace(cfg, fault=None), 4), FaultyStore)


# ------------------------------------------------------------------ dequant fold
def _qplane(rng, kind, C, P):
    plane = _np(rng, (C, P), 1e-2)
    if kind == "int8":
        u = _u(int(rng.integers(1 << 30)), (C, P))
        rep_p = pc.quantize_int8(torch.tensor(plane), torch.tensor(u))
        return jnp.asarray(rep_p.q.numpy()), jnp.asarray(rep_p.scale.numpy()), rep_p
    rep_p = pc.as_qplane(pc.quantize_bf16(torch.tensor(plane)))
    return jnp.asarray(plane).astype(BF16), jnp.asarray(rep_p.scale.numpy()), rep_p


@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("write_x, write_m", [(True, True), (True, False),
                                              (False, True), (False, False)])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_dequant_fold_plain_matches_reference_kernel(kind, write_x, write_m, m_dtype):
    """Identical (q, scale) into the reference's Pallas dequant kernel
    (interpret mode) and the port's dispatch (CPU → plain version)."""
    rng = np.random.default_rng(30)
    C, P = 5, 700
    q_j, sc_j, rep = _qplane(rng, kind, C, P)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    wn = mask / mask.sum()
    x, m = _np(rng, P), _np(rng, P)
    jd, td = (BF16, torch.bfloat16) if m_dtype == "bfloat16" else (jnp.float32, torch.float32)
    ex = ref_dequant_server_step(q_j, sc_j, jnp.asarray(wn), jnp.asarray(x),
                                 jnp.asarray(m, jd), 0.9, -0.5, 1.0, write_x=write_x,
                                 write_m=write_m)
    got = dequant_server_step(rep.q, rep.scale, torch.tensor(wn), torch.tensor(x),
                              torch.tensor(m).to(td), 0.9, -0.5, 1.0, write_x=write_x,
                              write_m=write_m)
    for name, e, a in zip(("x", "m", "mean"), ex, got):
        assert (e is None) == (a is None), name
        if e is not None:
            tol = dict(rtol=BF16_RTOL, atol=ATOL) if (name == "m" and m_dtype == "bfloat16") \
                else dict(rtol=RTOL, atol=ATOL)
            assert_close(to_numpy(a), np.asarray(e, np.float32), what=name, **tol)
    if write_m:
        assert got[1].dtype == td


def test_dequant_fold_masked_client_contributes_nothing():
    rng = np.random.default_rng(31)
    C, P = 4, 257
    rep = pc.quantize_int8(torch.tensor(_np(rng, (C, P))), torch.tensor(_u(2, (C, P))))
    wn = torch.tensor([1.0, 1.0, 1.0, 0.0]) / 3
    x, m = torch.tensor(_np(rng, P)), torch.tensor(_np(rng, P))
    coefs = torch.tensor([0.9, 0.1, -2.0, 1.0])
    out = dequant_server_update_ref(rep.q, rep.scale, wn, x, m, coefs)
    q_g = rep.q.clone()
    q_g[-1] = 127
    sc_g = rep.scale.clone()
    sc_g[-1] = 1e9
    out_g = dequant_server_update_ref(q_g, sc_g, wn, x, m, coefs)
    assert all(torch.equal(a, b) for a, b in zip(out, out_g))


def test_bf16_dequant_fold_with_unit_scale_is_the_dense_fold_bitwise():
    rng = np.random.default_rng(32)
    q = torch.tensor(_np(rng, (6, 321))).to(torch.bfloat16)
    wn = torch.tensor([0.25, 0.25, 0.0, 0.25, 0.25, 0.0])
    x = torch.tensor(_np(rng, 321))
    m = torch.tensor(_np(rng, 321)).to(torch.bfloat16)
    coefs = torch.tensor([0.0, -1.7, 1.0, 1.0])
    a = dequant_server_update_ref(q, torch.ones(6), wn, x, m, coefs)
    b = server_update_ref(q, wn, x, m, coefs)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_dequant_fold_sum_is_ascending_dequantized_rows():
    rng = np.random.default_rng(33)
    rep = pc.quantize_int8(torch.tensor(_np(rng, (7, 129))), torch.tensor(_u(3, (7, 129))))
    wn = torch.full((7,), 1.0 / 7)
    z = torch.zeros(129)
    mean = dequant_server_update_ref(rep.q, rep.scale.reshape(-1), wn, z, z,
                                     torch.tensor([0.0, 1.0, 1.0, 1.0]))[2]
    expect = torch.zeros(129)
    for c in range(7):
        expect = expect + (rep.q[c].float() * rep.scale[c, 0]) * wn[c]
    assert torch.equal(mean, expect)
