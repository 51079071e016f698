"""Port vs reference: the nine algorithms beyond FedCM and FedAvg — fedprox,
fedavgm, fedacg, fedadam, fedadagrad, fedyogi, mimelite, scaffold, feddyn —
and the port's own contracts for all eleven.

The seam is ``round_step(state, batches, ids, mask, full_batches)``: the
reference draws the cohort and minibatches with ``jax.random`` and the same
draws (and, for MimeLite, each cohort client's whole dataset) go into both
packages.  Both start from one state carried across with
``state_from_numpy``: params, a random momentum, a random positive second
moment (the adaptive specs) and random ``(N, …)`` client states
(SCAFFOLD, FedDyn), so every post-step and the client-state scatter act on
nonzero planes.  The reference runs its Pallas kernels in interpret mode
(the kernel route, the primary oracle) and its jnp route; the port runs on
the CPU, through the kernels' plain versions.  Tolerances are stated in
tests/_torch_parity.py.

In-port contracts, held bitwise: quarantine ≡ excluding the client for all
eleven specs (an excluded client's state row is left as it was),
fedavgm(α = 1) ≡ fedavg and fedprox(μ = 0) ≡ fedavg.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    N_CLIENTS, ROUND_ATOL, assert_close, assert_states_equal, client_data, count_flips,
    data_setup, flat_rows, flat_tree, jax_tree, np_params, port_cfg, port_engine, ref_cfg,
    ref_draws, ref_engine, ref_round_draws, ref_state_numpy, ring_start, small_cfg,
    torch_batches,
)
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro_torch.configs.base import FaultConfig
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import RoundDraws, RoundMetrics, metrics_to_host
from repro_torch.core.registry import get_algorithm
from repro_torch.data.pipeline import gather_full_client_batch

torch.set_num_threads(1)

NEW_ALGOS = ("fedprox", "fedavgm", "fedacg", "fedadam", "fedadagrad", "fedyogi",
             "mimelite", "scaffold", "feddyn")
ALL_ALGOS = tuple(sorted(NEW_ALGOS + ("fedavg", "fedcm")))
PARTICIPATIONS = ("fixed", "bernoulli")
ROUTES = ("kernel", "jnp")
# the reference benchmark's server lr for the adaptive specs (an absolute
# step on the preconditioned momentum)
ETA_G = {"fedadam": 0.03, "fedadagrad": 0.03, "fedyogi": 0.03}


def _cfg(algo, participation="fixed", route="kernel", **kw):
    kw.setdefault("eta_g", ETA_G.get(algo, 1.0))
    return ref_cfg(participation, algo=algo, use_fused_kernel=(route == "kernel"), **kw)


@lru_cache(maxsize=None)
def _ref_engine(algo, participation, route):
    return ref_engine(_cfg(algo, participation, route))[0]


def _ref_state(eng, start):
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(0))
    srv = st.server._replace(momentum=jax_tree(start["momentum"]))
    if srv.second_moment is not None:
        srv = srv._replace(second_moment=jax_tree(start["second_moment"]))
    st = st._replace(server=srv)
    if st.client_states is not None:
        st = st._replace(client_states=jax_tree(start["client_states"]))
    return st


def _port_state(pcfg, start):
    state, _ = state_from_numpy(np_params(), pcfg, momentum=start["momentum"],
                                second_moment=start["second_moment"],
                                client_states=start["client_states"])
    return state


def _full(cx, cy, ids):
    return {"x": cx[ids], "y": cy[ids]}


def _ref_step(eng, st, batches, ids, mask, full):
    return eng.round_step(st, jax.tree_util.tree_map(jnp.asarray, batches), jnp.asarray(ids),
                          jnp.asarray(mask), jax.tree_util.tree_map(jnp.asarray, full))


def _port_step(eng, st, batches, ids, mask, full, draws=None):
    return eng.round_step(st, torch_batches(batches), torch.tensor(ids), torch.tensor(mask),
                          draws=draws, full_batches=torch_batches(full))


PLANES = ("params", "momentum", "second_moment", "client_states")


@lru_cache(maxsize=None)
def _one_round(algo, participation, route):
    """(reference, port) numpy results of one round from the same state on
    the reference's draws."""
    reng = _ref_engine(algo, participation, route)
    start = ring_start()
    cx, cy = client_data()
    batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(7))
    full = _full(cx, cy, ids)
    rst, rm = _ref_step(reng, _ref_state(reng, start), batches, ids, mask, full)
    ref = ref_state_numpy(rst)
    ref["metrics"] = {f: np.asarray(v, np.float32) for f, v in zip(rm._fields, rm)
                      if v is not None}
    pcfg = port_cfg(reng.cfg)
    nst, pm = _port_step(port_engine(pcfg), _port_state(pcfg, start), batches, ids, mask,
                         full)
    port = state_to_numpy(nst)
    port["metrics"] = {f: v[0] for f, v in metrics_to_host(pm).items()}
    return ref, port, mask


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("participation", PARTICIPATIONS)
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_one_round_state_matches_reference(algo, participation, route):
    ref, port, mask = _one_round(algo, participation, route)
    if participation == "bernoulli":
        assert 0 < mask.sum() < mask.size  # the draw exercises inactive rows
    assert port["round"] == ref["round"] == 1
    spec = get_algorithm(algo)
    assert (port["second_moment"] is None) == (not spec.needs_second_moment)
    assert (port["client_states"] is None) == (not spec.needs_client_state)
    for key in PLANES:
        assert (ref[key] is None) == (port[key] is None), key
        if ref[key] is not None:
            assert_close(port[key], ref[key], what=key)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("participation", PARTICIPATIONS)
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_one_round_metrics_match_reference(algo, participation, route):
    """Every metric, bytes up and down included (P per wire plane up; x_t,
    plus Δ_t or c when broadcast, down)."""
    ref, port, _ = _one_round(algo, participation, route)
    assert set(port["metrics"]) == set(ref["metrics"]) == set(RoundMetrics._fields)
    for f in RoundMetrics._fields:
        assert_close(port["metrics"][f], ref["metrics"][f], what=f)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_three_rounds_match_reference(algo, route):
    """Three chained rounds on the reference's draws (bernoulli): the
    logged loss line for line and every state plane at the end."""
    reng = _ref_engine(algo, "bernoulli", route)
    start = ring_start()
    rst = _ref_state(reng, start)
    pcfg = port_cfg(reng.cfg)
    peng, pst = port_engine(pcfg), _port_state(pcfg, start)
    cx, cy = client_data()
    ref_loss, port_loss = [], []
    for t in range(3):
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(100 + t), t)
        full = _full(cx, cy, ids)
        rst, rm = _ref_step(reng, rst, batches, ids, mask, full)
        pst, pm = _port_step(peng, pst, batches, ids, mask, full)
        ref_loss.append(float(rm.loss))
        port_loss.append(float(pm.loss))
    assert_close(port_loss, ref_loss, atol=ROUND_ATOL, what="loss per round")
    ref, port = ref_state_numpy(rst), state_to_numpy(pst)
    assert port["round"] == 3
    for key in PLANES:
        assert (ref[key] is None) == (port[key] is None), key
        if ref[key] is not None:
            assert_close(port[key], ref[key], atol=ROUND_ATOL, what=key)


# ------------------------------------------------------------------ lossy uplink
LOSSY = {"int8": RefCompressionConfig(kind="int8", seed=3),
         "topk": RefCompressionConfig(kind="topk", topk_frac=0.1, seed=1)}


@pytest.mark.parametrize("case", ["int8", "topk"])
@pytest.mark.parametrize("algo", ["scaffold", "mimelite"])
def test_lossy_round_matches_reference_kernel_route(algo, case):
    """int8 (every wire plane stochastic-rounded, the state delta decoded
    dense for the scatter) and top-k (the delta plane only, with error
    feedback) over three rounds, each started from the reference's state;
    floor flips within ``FLIP_MAX``."""
    cfg = _cfg(algo, "fixed", "kernel", compression=LOSSY[case])
    reng, _ = ref_engine(cfg)
    rst = _ref_state(reng, ring_start())
    peng = port_engine(port_cfg(cfg))
    cx, cy = client_data()
    for t in range(3):
        before = ref_state_numpy(rst)
        before["residuals"] = None if rst.residuals is None else np.asarray(rst.residuals)
        pst, _ = state_from_numpy(np_params(), peng.cfg, momentum=before["momentum"],
                                  round=t, residuals=before["residuals"],
                                  client_states=before["client_states"])
        pst = pst._replace(params=torch.tensor(before["params"]))
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(100 + t), t)
        full = _full(cx, cy, ids)
        rst, rm = _ref_step(reng, rst, batches, ids, mask, full)
        nst, pm = _port_step(peng, pst, batches, ids, mask, full,
                             draws=ref_round_draws(cfg, t, ids, peng.spec.size))
        ref, got = ref_state_numpy(rst), state_to_numpy(nst)
        ref["residuals"] = None if rst.residuals is None else np.asarray(rst.residuals)
        for key in ("params", "momentum", "client_states", "residuals"):
            assert (ref[key] is None) == (got[key] is None), key
            if ref[key] is not None:
                count_flips(got[key], ref[key], before[key], f"round {t} {key}")
        host = {f: v[0] for f, v in metrics_to_host(pm).items()}
        for f in ("n_active", "bytes_up", "bytes_down"):
            assert host[f] == np.float32(getattr(rm, f)), f"round {t} {f}"


# ------------------------------------------------------------------ in-port contracts
@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_quarantine_equals_excluding_the_client(algo):
    """A NaN-corrupted uplink, quarantined, folds identically to the same
    round with that client dropped outright, bitwise, for every spec: the
    quarantined client's state row is left exactly as it was (cst + 0·sd
    on a zeroed row), and so are the second moment and every other plane."""
    eng_a, st_a, data = data_setup(small_cfg(algo=algo, fault=FaultConfig(
        corrupt_rate=0.5, corrupt_mode="nan", seed=5)))
    eng_b, st_b, _ = data_setup(small_cfg(algo=algo, fault=FaultConfig(
        drop_rate=0.5, corrupt_rate=0.5, corrupt_mode="nan", seed=5)))
    gen = torch.Generator().manual_seed(3)
    n_quar = 0.0
    for _ in range(3):
        batches, ids, mask, _ = eng_a._sample_round(st_a._replace(rng=gen), data)
        full = gather_full_client_batch(data.client_x, data.client_y, ids)
        u = torch.rand(ids.shape[0], generator=gen)
        before = st_a.client_states
        st_a, ma = eng_a.round_step(st_a, batches, ids, mask, draws=RoundDraws(u_corrupt=u),
                                    full_batches=full)
        st_b, mb = eng_b.round_step(st_b, batches, ids, mask, draws=RoundDraws(
            u_drop=u, u_corrupt=torch.ones_like(u)), full_batches=full)
        assert float(ma.n_active) == float(mb.n_active)
        assert float(ma.n_quarantined) == float(mb.n_dropped)
        n_quar += float(ma.n_quarantined)
        assert_states_equal(st_a, st_b)
        if before is not None:  # quarantined rows and clients outside the cohort keep theirs
            kept = [i for i in range(N_CLIENTS)
                    if i not in ids.tolist() or bool(u[ids.tolist().index(i)] < 0.5)]
            assert torch.equal(st_a.client_states[kept], before[kept])
    assert n_quar > 0 and torch.all(torch.isfinite(st_a.params))


def test_quarantine_tests_every_uplink_plane():
    """A client whose delta is finite but whose full-batch gradient (the
    extra plane) is not is quarantined: its rows are zeroed in every plane
    and the round equals the one with that client dropped, bitwise."""
    eng_a, st_a, data = data_setup(small_cfg(algo="mimelite", fault=FaultConfig(seed=5)))
    eng_b, st_b, _ = data_setup(small_cfg(algo="mimelite", fault=FaultConfig(
        drop_rate=0.5, seed=5)))
    batches, ids, mask, _ = eng_a._sample_round(st_a, data)
    full = gather_full_client_batch(data.client_x, data.client_y, ids)
    full["x"] = full["x"].clone()
    full["x"][1, 0, 0] = float("nan")  # client ids[1]: NaN in its full batch only
    st_a, ma = eng_a.round_step(st_a, batches, ids, mask, full_batches=full)
    st_b, mb = eng_b.round_step(st_b, batches, ids, mask, full_batches=full, draws=RoundDraws(
        u_drop=torch.tensor([0.9, 0.1, 0.9])))
    assert float(ma.n_quarantined) == 1.0 == float(mb.n_dropped)
    assert_states_equal(st_a, st_b)
    assert torch.all(torch.isfinite(st_a.server.momentum))


@pytest.mark.parametrize("algo, knob", [
    ("fedavgm", {"alpha": 1.0, "eta_l": 0.125, "eta_l_decay": 1.0}),
    ("fedprox", {"fedprox_mu": 0.0})])
def test_identity_settings_are_fedavg_bitwise(algo, knob):
    """fedavgm at α = 1 and fedprox at μ = 0 run FedAvg's rounds bit for
    bit, over three rounds.  fedprox's proximal stream is a static zero and
    drops from the launch, at any η_l.  fedavgm keeps m' = Δ_{t+1} (the
    same fold row as FedAvg's at c_mm = 0) and steps x − η_g·η_l·K·m' in
    its post-step, which is FedAvg's x + η_g·mean only where
    (η_g·η_l·K)·(−1/(η_l·K)) rounds to −1 exactly: here η_l·K = 1/4 with
    no decay.  At other η_l the two differ by that reassociation (the next
    test)."""
    finals = []
    for name in (algo, "fedavg"):
        eng, st, data = data_setup(small_cfg(algo=name, **knob))
        st, _ = eng.run_rounds(st, data, 3)
        finals.append(st)
    assert torch.equal(finals[0].params, finals[1].params)
    assert torch.equal(finals[0].server.momentum, finals[1].server.momentum)


def test_fedavgm_alpha_one_is_fedavg_to_reassociation():
    """At the default (decaying) η_l fedavgm(α = 1) follows FedAvg to the
    f32 reassociation of the server step, over three rounds: the bound of
    the reference's own test_fedavgm_alpha1_is_fedavg."""
    finals = []
    for name in ("fedavgm", "fedavg"):
        eng, st, data = data_setup(small_cfg(algo=name, alpha=1.0))
        st, _ = eng.run_rounds(st, data, 3)
        finals.append(st)
    for key in ("params", "momentum"):
        a, b = (state_to_numpy(f)[key] for f in finals)
        assert_close(a, b, rtol=1e-5, atol=1e-6, what=key)


@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_run_rounds_allocates_the_spec_planes_and_stays_finite(algo):
    """``init`` allocates what the spec's flags ask for and nothing else;
    ``run_rounds`` (MimeLite's full batches gathered by ``run_round``)
    stays finite and counts one wire plane per uplink plane."""
    spec = get_algorithm(algo)
    eng, st, data = data_setup(small_cfg(algo=algo))
    assert (st.client_states is not None) == spec.needs_client_state
    assert (st.server.second_moment is not None) == spec.needs_second_moment
    if spec.needs_client_state:
        assert st.client_states.shape == (N_CLIENTS, eng.spec.size)
    st, ms = eng.run_rounds(st, data, 3)
    host = metrics_to_host(ms)
    assert np.all(np.isfinite(host["loss"])) and torch.all(torch.isfinite(st.params))
    P4 = 4 * eng.spec.size
    np.testing.assert_array_equal(host["bytes_up"],
                                  host["n_active"] * P4 * len(spec.wire_uplink_planes))
    down = P4 * (2 if spec.needs_momentum_broadcast else 1)
    np.testing.assert_array_equal(host["bytes_down"], host["n_active"] * down)
    if spec.needs_client_state:
        assert torch.count_nonzero(st.client_states) > 0


def test_full_batch_spec_refuses_a_round_without_full_batches():
    eng, st, data = data_setup(small_cfg(algo="mimelite"))
    batches, ids, mask, _ = eng._sample_round(st, data)
    with pytest.raises(ValueError, match="full_batches"):
        eng.round_step(st, batches, ids, mask)


def test_client_state_spec_refuses_a_state_without_its_plane():
    eng, st, data = data_setup(small_cfg(algo="scaffold"))
    batches, ids, mask, _ = eng._sample_round(st, data)
    with pytest.raises(ValueError, match="client_states"):
        eng.round_step(st._replace(client_states=None), batches, ids, mask)


def test_below_quorum_round_leaves_every_plane_as_it_was():
    """Below quorum the client-state rows are written back as cst + 0·sd
    and the second moment is carried through with params and momentum."""
    for algo in ("scaffold", "fedadam"):
        cfg = port_cfg(_cfg(algo, min_quorum=4))  # cohort of 3 < quorum
        eng, st = port_engine(cfg), _port_state(cfg, ring_start())
        cx, cy = client_data()
        batches, ids, mask = ref_draws(_ref_engine(algo, "fixed", "jnp"), cx, cy,
                                       jax.random.PRNGKey(7))
        nst, m = _port_step(eng, st, batches, ids, mask, _full(cx, cy, ids))
        assert float(m.quorum_skipped) == 1.0 and int(nst.server.round) == 1
        assert_states_equal(nst, st._replace(server=st.server._replace(
            round=torch.tensor(1, dtype=torch.int32))))


def test_state_from_numpy_takes_flat_or_stacked_client_states():
    """The reference's stacked ``(N, …)`` client-state tree and its
    ``(N, P)`` ravel give the same plane; second moment likewise."""
    pcfg = small_cfg(algo="scaffold")
    start = ring_start()
    a, spec = state_from_numpy(np_params(), pcfg, client_states=start["client_states"])
    rows = flat_rows(start["client_states"])
    b, _ = state_from_numpy(np_params(), pcfg, client_states=rows)
    assert a.client_states.shape == (N_CLIENTS, spec.size)
    assert torch.equal(a.client_states, b.client_states)
    np.testing.assert_array_equal(state_to_numpy(a)["client_states"], rows)
    acfg = replace(pcfg, algo="fedadam")
    c, _ = state_from_numpy(np_params(), acfg, second_moment=start["second_moment"])
    d, _ = state_from_numpy(np_params(), acfg, second_moment=flat_tree(start["second_moment"]))
    assert torch.equal(c.server.second_moment, d.server.second_moment)
    assert state_from_numpy(np_params(), pcfg)[0].server.second_moment is None
    assert state_from_numpy(np_params(), acfg)[0].client_states is None
