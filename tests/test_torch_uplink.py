"""Port vs reference: the lossy-uplink round — launch → faults → quarantine
→ wire encoding → fold — and the port's own contracts for it.

The reference runs its kernel route (``use_fused_kernel=True``, Pallas in
interpret mode) and draws its cohort, minibatches, fault draws and int8
rounding draw with threefry.  The same draws are computed here with
``jax.random`` and injected into the port (``round_step(..., draws=)``),
which runs on the CPU through the kernels' plain versions.  Each of three
rounds starts both packages from the reference's state (params, momentum,
residuals, round counter); ``FLIP_MAX`` in tests/_torch_parity.py states
the allowance for floor flips.

In-port contracts, held bitwise: quarantine ≡ excluding the client; a run
split in two (state copied through numpy) ≡ the straight run, with the
hash draws keyed by the device round counter; and ``compression=None,
fault=None`` ≡ the round composed of the uncompressed slice's pieces.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    ATOL, RTOL, assert_states_equal, client_data, count_flips, data_setup, jax_tree, np_params,
    port_cfg, port_engine, ref_cfg, ref_draws, ref_engine, ref_round_draws, small_cfg,
    torch_batches,
)
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro.configs.base import FaultConfig as RefFaultConfig
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import (
    RoundDraws, check_supported, local_learning_rate, metrics_to_host,
)
from repro_torch.kernels.server_update.ops import fused_fold

torch.set_num_threads(1)


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).ravel()
                           for l in jax.tree_util.tree_leaves(tree)])


def _ref_numpy(st):
    return {"params": _flat(st.params), "momentum": _flat(st.server.momentum),
            "residuals": None if st.residuals is None else np.asarray(st.residuals)}


CASES = {
    "int8": dict(compression=RefCompressionConfig(kind="int8", seed=3)),
    "bf16": dict(compression=RefCompressionConfig(kind="bf16")),
    "topk": dict(compression=RefCompressionConfig(kind="topk", topk_frac=0.1, seed=1)),
    "faults": dict(fault=RefFaultConfig(drop_rate=0.3, corrupt_rate=0.4, corrupt_mode="nan",
                                        seed=4)),
    "int8+faults": dict(
        participation="bernoulli",
        compression=RefCompressionConfig(kind="int8", seed=2),
        fault=RefFaultConfig(drop_rate=0.25, deadline=1.5, corrupt_rate=0.3,
                             corrupt_mode="nan", quarantine_norm_mult=3.0, seed=6)),
    "topk+faults": dict(
        participation="bernoulli",
        compression=RefCompressionConfig(kind="topk", topk_frac=0.05, seed=2),
        fault=RefFaultConfig(drop_rate=0.25, corrupt_rate=0.3, corrupt_mode="noise",
                             noise_scale=50.0, quarantine_norm_mult=2.0, seed=8)),
}
EXACT = ("n_active", "n_dropped", "n_quarantined", "quorum_skipped", "bytes_up",
         "bytes_down", "n_clipped", "eta_l")


def _parity_run(case):
    kw = dict(CASES[case])
    cfg = ref_cfg(kw.pop("participation", "fixed"), use_fused_kernel=True, **kw)
    reng, _ = ref_engine(cfg)
    rst = reng.init(jax_tree(np_params()), jax.random.PRNGKey(0))
    peng = port_engine(port_cfg(cfg))
    cx, cy = client_data()
    totals = {"flips": 0, "n_dropped": 0.0, "n_quarantined": 0.0, "inactive_rows": 0}
    for t in range(3):
        before = _ref_numpy(rst)
        pst, _ = state_from_numpy(np_params(), peng.cfg, momentum=before["momentum"],
                                  round=t, residuals=before["residuals"])
        pst = pst._replace(params=torch.tensor(before["params"]))
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(100 + t), t)
        rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                  jnp.asarray(ids), jnp.asarray(mask))
        nst, pm = peng.round_step(pst, torch_batches(batches), torch.tensor(ids),
                                  torch.tensor(mask),
                                  draws=ref_round_draws(cfg, t, ids, peng.spec.size))
        ref, got = _ref_numpy(rst), state_to_numpy(nst)
        flips = 0
        for key in ("params", "momentum", "residuals"):
            assert (ref[key] is None) == (got[key] is None), key
            if ref[key] is not None:
                flips += count_flips(got[key], ref[key], before[key], f"round {t} {key}")
        host = {f: v[0] for f, v in metrics_to_host(pm).items()}
        for f in EXACT:
            assert host[f] == np.float32(getattr(rm, f)), f"round {t} {f}"
        np.testing.assert_allclose(host["loss"], float(rm.loss), rtol=RTOL, atol=ATOL)
        # a flip moves the mean by one quantum: only then is the norm looser
        np.testing.assert_allclose(host["delta_norm"], float(rm.delta_norm),
                                   rtol=1e-2 if flips else RTOL, atol=ATOL)
        totals["flips"] += flips
        totals["n_dropped"] += float(rm.n_dropped)
        totals["n_quarantined"] += float(rm.n_quarantined)
        totals["inactive_rows"] += int(mask.sum() - host["n_active"])
    return totals


@pytest.mark.parametrize("case", list(CASES))
def test_lossy_round_matches_reference_kernel_route(case):
    totals = _parity_run(case)
    if "faults" in case:  # the draws did exercise the fault paths
        assert totals["n_dropped"] > 0 and totals["n_quarantined"] > 0, totals


def test_topk_residuals_of_inactive_clients_are_kept():
    """Under top-k with drops, a dropped client's residual row is carried
    through unchanged and a client outside the cohort is never touched."""
    cfg = port_cfg(ref_cfg("fixed", compression=RefCompressionConfig(kind="topk",
                                                                      topk_frac=0.1),
                           fault=RefFaultConfig(drop_rate=0.5, seed=1)))
    eng = port_engine(cfg)
    rng = np.random.default_rng(0)
    res0 = (0.01 * rng.normal(size=(6, eng.spec.size))).astype(np.float32)
    st, _ = state_from_numpy(np_params(), cfg, residuals=res0)
    cx, cy = client_data()
    reng, _ = ref_engine(ref_cfg("fixed"))
    batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(5))
    u_drop = torch.tensor([0.9, 0.1, 0.9])  # client ids[1] drops
    nst, m = eng.round_step(st, torch_batches(batches), torch.tensor(ids), torch.tensor(mask),
                            draws=RoundDraws(u_drop=u_drop))
    res = nst.residuals.numpy()
    assert float(m.n_dropped) == 1.0 and float(m.n_active) == 2.0
    np.testing.assert_array_equal(res[ids[1]], res0[ids[1]])
    for c in (0, 2):
        assert not np.array_equal(res[ids[c]], res0[ids[c]])
    for i in sorted(set(range(6)) - set(ids.tolist())):
        np.testing.assert_array_equal(res[i], res0[i])


# ------------------------------------------------------------------ in-port contracts
@pytest.mark.parametrize("comp", [None, CompressionConfig(kind="int8", seed=2),
                                  CompressionConfig(kind="topk", topk_frac=0.1)])
def test_quarantine_equals_excluding_the_client(comp):
    """A NaN-corrupted uplink, quarantined, folds identically to the same
    round with that client dropped outright: run B routes run A's
    corruption draw into the drop draw (and corrupts nobody)."""
    eng_a, st_a, data = data_setup(small_cfg(compression=comp, fault=FaultConfig(
        corrupt_rate=0.5, corrupt_mode="nan", seed=5)))
    eng_b, st_b, _ = data_setup(small_cfg(compression=comp, fault=FaultConfig(
        drop_rate=0.5, corrupt_rate=0.5, corrupt_mode="nan", seed=5)))
    gen = torch.Generator().manual_seed(3)
    n_quar = 0.0
    for _ in range(3):
        batches, ids, mask, _ = eng_a._sample_round(st_a._replace(rng=gen), data)
        u = torch.rand(ids.shape[0], generator=gen)
        st_a, ma = eng_a.round_step(st_a, batches, ids, mask, draws=RoundDraws(u_corrupt=u))
        st_b, mb = eng_b.round_step(st_b, batches, ids, mask, draws=RoundDraws(
            u_drop=u, u_corrupt=torch.ones_like(u)))
        assert float(ma.n_active) == float(mb.n_active)
        assert float(ma.n_quarantined) == float(mb.n_dropped)
        n_quar += float(ma.n_quarantined)
        assert_states_equal(st_a, st_b)
    assert n_quar > 0 and torch.all(torch.isfinite(st_a.params))


@pytest.mark.parametrize("comp", [CompressionConfig(kind="int8", seed=5),
                                  CompressionConfig(kind="topk", topk_frac=0.1, seed=5)])
def test_split_run_is_bitwise_the_straight_run(comp):
    """4 straight rounds ≡ 2 rounds, the state copied out through numpy and
    into a new engine, then 2 more: the rounding and fault draws are keyed
    by the round counter carried in the state, and the residual rows ride
    the state."""
    cfg = small_cfg(compression=comp, fault=FaultConfig(drop_rate=0.3, corrupt_rate=0.3, seed=2))
    eng, st, data = data_setup(cfg)
    straight, _ = eng.run_rounds(st, data, 4)

    eng1, st1, data1 = data_setup(cfg)
    st1, _ = eng1.run_rounds(st1, data1, 2)
    snap = state_to_numpy(st1)
    eng2, _, _ = data_setup(cfg)
    gen = torch.Generator()
    gen.set_state(st1.rng.get_state())
    st2, _ = state_from_numpy(np_params(), cfg, momentum=snap["momentum"],
                              round=snap["round"], residuals=snap["residuals"], generator=gen)
    st2 = st2._replace(params=torch.tensor(snap["params"]))
    resumed, _ = eng2.run_rounds(st2, data1, 2)
    assert_states_equal(straight, resumed)
    if comp.kind == "topk":
        assert torch.count_nonzero(straight.residuals) > 0


def test_no_compression_no_fault_is_the_uncompressed_round_bitwise():
    """``compression=None, fault=None`` runs exactly the uncompressed slice's
    round: local steps, then one dense fold.  A fault config whose rates are
    all zero (quarantine on, nothing non-finite) gives the same bits."""
    eng, st, data = data_setup(small_cfg())
    batches, ids, mask, _ = eng._sample_round(st, data)
    got, m = eng.round_step(st, batches, ids, mask)

    eta_l = local_learning_rate(eng.cfg, st.server.round)
    planes, _ = eng._flat_cohort_pass(st.params, st.server.momentum, batches, eta_l)
    w = mask.to(torch.float32)
    n = w.sum()
    x, mom, _ = fused_fold(eng.algo, eng.cfg, planes, w / n.clamp(min=1.0), n, st.params,
                           st.server.momentum, eta_l)
    assert torch.equal(got.params, x) and torch.equal(got.server.momentum, mom)
    assert got.residuals is None
    assert float(m.n_dropped) == 0.0 and float(m.n_quarantined) == 0.0

    eng0, st0, _ = data_setup(small_cfg(fault=FaultConfig()))
    got0, m0 = eng0.round_step(st0, batches, ids, mask)
    assert_states_equal(got, got0)
    assert float(m0.n_quarantined) == 0.0


@pytest.mark.parametrize("kind, per_client", [("int8", 484 + 4), ("bf16", 2 * 484),
                                              ("topk", 48 * 8), (None, 4 * 484)])
def test_bytes_up_is_n_active_times_wire_bytes(kind, per_client):
    comp = None if kind is None else CompressionConfig(kind=kind, topk_frac=0.1)
    eng, st, data = data_setup(small_cfg(compression=comp, fault=FaultConfig(drop_rate=0.4,
                                                                           seed=1)))
    assert eng.spec.size == 484 and eng.payload_bytes()["up_per_client"] == per_client
    _, ms = eng.run_rounds(st, data, 3)
    host = metrics_to_host(ms)
    np.testing.assert_array_equal(host["bytes_up"], host["n_active"] * per_client)
    assert host["n_dropped"].sum() > 0


def test_init_allocates_residuals_only_under_topk():
    eng, st, _ = data_setup(small_cfg(compression=CompressionConfig(kind="topk")))
    assert st.residuals.shape == (6, 484) and st.residuals.dtype == torch.float32
    assert torch.count_nonzero(st.residuals) == 0
    for comp in (None, CompressionConfig(kind="int8")):
        assert data_setup(small_cfg(compression=comp))[1].residuals is None
    # a top-k state without its residual rows is refused at the round
    eng, st, data = data_setup(small_cfg(compression=CompressionConfig(kind="topk")))
    batches, ids, mask, _ = eng._sample_round(st, data)
    with pytest.raises(ValueError, match="residual"):
        eng.round_step(st._replace(residuals=None), batches, ids, mask)


@pytest.mark.parametrize("kind, frac", [("int4", 0.01), ("topk", 0.0), ("topk", 1.5)])
def test_engine_refuses_malformed_compression(kind, frac):
    """``cfg.compression`` alone selects the wire format, and the engine
    validates it before any round runs."""
    with pytest.raises(ValueError, match="compression kind|topk_frac"):
        data_setup(small_cfg(compression=CompressionConfig(kind=kind, topk_frac=frac)))


@pytest.mark.parametrize("knob", [
    {"fault": FaultConfig(drop_rate=0.1, corrupt_rate=0.1, deadline=2.0)},
    {"compression": CompressionConfig(kind="int8")},
    {"compression": CompressionConfig(kind="bf16")},
    {"compression": CompressionConfig(kind="topk", topk_frac=0.05)},
    {"fault": FaultConfig(corrupt_mode="noise", corrupt_rate=0.2),
     "compression": CompressionConfig(kind="int8"), "min_quorum": 2},
])
def test_fault_and_compression_configs_are_supported(knob):
    cfg = FedConfig(**knob)
    check_supported(cfg)
    eng, st, data = data_setup(replace(small_cfg(), **knob))
    st, m = eng.run_round(st, data)
    assert torch.all(torch.isfinite(st.params))
