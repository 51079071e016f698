"""Port vs reference: one FedCM round, and a few, on injected draws.

The seam is ``round_step(state, batches, ids, mask)``: the reference draws
the cohort and minibatches with ``jax.random`` and the same draws go into
both packages.  The reference runs both of its routes — its Pallas kernels
in interpret mode (``use_fused_kernel=True``) and its jnp route — and the
port (on the CPU, so through the kernels' plain versions) is held to each,
field by field.  Tolerances are stated in tests/_torch_parity.py.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    B, DIMS, ROUND_ATOL, assert_close, client_data, jax_tree,
    np_params, port_cfg, ref_cfg, ref_draws, ref_engine, torch_batches,
)
from repro_torch.configs.base import FaultConfig
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import (
    FederatedEngine, RoundMetrics, check_supported, metrics_to_host,
)
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import list_algorithms
from repro_torch.data.pipeline import FederatedData
from repro_torch.models.small import classification_loss, mlp_classifier

torch.set_num_threads(1)

PARTICIPATIONS = ("fixed", "bernoulli")
ROUTES = ("kernel", "jnp")
ALL_ALGOS = ("fedacg", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedcm", "feddyn",
             "fedprox", "fedyogi", "mimelite", "scaffold")


def _t(a):
    return torch.tensor(np.array(a))


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).ravel()
                           for l in jax.tree_util.tree_leaves(tree)])


def _np_momentum(seed=3):
    rng = np.random.default_rng(seed)
    return [{k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in layer.items()}
            for layer in np_params()]


@lru_cache(maxsize=None)
def _ref(participation, route, algo="fedcm", alpha=0.1, momentum_dtype="float32"):
    cfg = ref_cfg(participation, algo=algo, alpha=alpha, momentum_dtype=momentum_dtype,
                  use_fused_kernel=(route == "kernel"))
    eng, _ = ref_engine(cfg)
    return cfg, eng


def _ref_state(eng, momentum=None):
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(0))
    if momentum is not None:
        mdt = st.server.momentum[0]["w"].dtype
        st = st._replace(server=st.server._replace(
            momentum=jax.tree_util.tree_map(lambda a: jnp.asarray(a, mdt), momentum)))
    return st


def _port(cfg, momentum=None):
    pcfg = port_cfg(cfg)
    state, spec = state_from_numpy(np_params(), pcfg, momentum=momentum)
    model = mlp_classifier(DIMS)
    eng = FederatedEngine(pcfg, classification_loss(model.apply), spec,
                          batch_size=B, device="cpu")
    return eng, state


@lru_cache(maxsize=None)
def _one_round(participation, route, algo="fedcm", alpha=0.1, momentum_dtype="float32"):
    """(reference, port) numpy results of one round from the same state and
    the reference's draws."""
    cfg, reng = _ref(participation, route, algo, alpha, momentum_dtype)
    mom = _np_momentum()
    cx, cy = client_data()
    batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(7))
    rst, rm = reng.round_step(_ref_state(reng, mom), jax.tree_util.tree_map(jnp.asarray, batches),
                              jnp.asarray(ids), jnp.asarray(mask))
    ref = {"params": _flat(rst.params), "momentum": _flat(rst.server.momentum),
           "round": int(rst.server.round),
           "metrics": {f: np.asarray(v, np.float32) for f, v in zip(rm._fields, rm)
                       if v is not None}}
    peng, pst = _port(cfg, mom)
    nst, pm = peng.round_step(pst, torch_batches(batches), _t(ids),
                              _t(mask))
    port = state_to_numpy(nst)
    port["metrics"] = {f: v[0] for f, v in metrics_to_host(pm).items()}
    return ref, port, mask


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("participation", PARTICIPATIONS)
def test_round_step_state_matches_reference(participation, route):
    ref, port, mask = _one_round(participation, route)
    if participation == "bernoulli":
        assert 0 < mask.sum() < mask.size  # the draw exercises inactive rows
    assert port["round"] == ref["round"] == 1
    assert_close(port["params"], ref["params"], what="params")
    assert_close(port["momentum"], ref["momentum"], what="momentum")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("participation", PARTICIPATIONS)
def test_round_step_metrics_match_reference(participation, route):
    ref, port, _ = _one_round(participation, route)
    assert set(port["metrics"]) == set(ref["metrics"]) == set(RoundMetrics._fields)
    for f in RoundMetrics._fields:
        # byte counts are exact integers far above f32 ulp; norms/loss O(1)
        assert_close(port["metrics"][f], ref["metrics"][f], what=f)


def test_round_step_bf16_momentum_matches_reference():
    """momentum_dtype bf16: the direction kernel reads a bf16 broadcast aux
    and the fold writes a bf16 momentum plane.  The oracle is the
    reference's kernel route, which like the port widens Δ_t to f32 before
    the blend (its jnp route multiplies the bf16 Δ_t by (1−α) in bf16)."""
    ref, port, _ = _one_round("fixed", "kernel", momentum_dtype="bfloat16")
    assert_close(port["params"], ref["params"], what="params")
    # bf16 storage: one bf16 ulp (see _torch_parity)
    assert_close(port["momentum"], ref["momentum"], rtol=2.0 ** -7, atol=1e-6,
                 what="momentum")


@pytest.mark.parametrize("participation", PARTICIPATIONS)
def test_three_rounds_loss_matches_reference(participation):
    """Per-round logged loss, line for line, over three rounds on the
    reference's draws (loss discriminates trajectories; accuracy saturates)."""
    cfg, reng = _ref(participation, "kernel")
    mom = _np_momentum()
    rst = _ref_state(reng, mom)
    peng, pst = _port(cfg, mom)
    cx, cy = client_data()
    ref_loss, port_loss = [], []
    for t in range(3):
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(100 + t), t)
        rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                  jnp.asarray(ids), jnp.asarray(mask))
        pst, pm = peng.round_step(pst, torch_batches(batches), _t(ids),
                                  _t(mask))
        ref_loss.append(float(rm.loss))
        port_loss.append(float(pm.loss))
    assert_close(port_loss, ref_loss, atol=ROUND_ATOL, what="loss per round")
    out = state_to_numpy(pst)
    assert out["round"] == 3
    assert_close(out["params"], _flat(rst.params), atol=ROUND_ATOL, what="params")
    assert_close(out["momentum"], _flat(rst.server.momentum), atol=ROUND_ATOL,
                 what="momentum")


def test_fedcm_alpha_one_is_fedavg():
    """At α = 1 FedCM drops its momentum stream (a static zero) and runs the
    same zero-aux launch and fold as FedAvg: bitwise equal in the port, and
    equal to the reference's FedAvg within tolerance."""
    cfg = ref_cfg("fixed", algo="fedcm", alpha=1.0)
    cx, cy = client_data()
    _, reng = _ref("fixed", "kernel", "fedavg")
    batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(7))
    outs = []
    for c in (cfg, replace(cfg, algo="fedavg")):
        peng, pst = _port(c, _np_momentum())
        nst, _ = peng.round_step(pst, torch_batches(batches), _t(ids),
                                 _t(mask))
        outs.append(nst)
    assert torch.equal(outs[0].params, outs[1].params)
    assert torch.equal(outs[0].server.momentum, outs[1].server.momentum)
    ref, port, _ = _one_round("fixed", "kernel", "fedavg")
    assert_close(state_to_numpy(outs[1])["params"], ref["params"], what="fedavg params")
    assert_close(port["params"], ref["params"], what="fedavg params (cached)")


def test_quorum_skip_carries_state_through():
    cfg = ref_cfg("fixed", min_quorum=4)  # cohort of 3 < quorum
    peng, pst = _port(cfg, _np_momentum())
    cx, cy = client_data()
    _, reng = _ref("fixed", "jnp")
    batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(7))
    nst, m = peng.round_step(pst, torch_batches(batches), _t(ids),
                             _t(mask))
    assert torch.equal(nst.params, pst.params)
    assert torch.equal(nst.server.momentum, pst.server.momentum)
    assert float(m.quorum_skipped) == 1.0
    assert int(nst.server.round) == 1


def _data_engine(participation="bernoulli", seed=0):
    from repro_torch.configs.base import FedConfig
    cfg = FedConfig(num_clients=6, cohort_size=3, local_steps=2, participation=participation)
    cx, cy = client_data()
    data = FederatedData(cx.reshape(-1, DIMS[0]), cy.reshape(-1), 6, seed=seed, device="cpu")
    model = mlp_classifier(DIMS)
    params = model.init(torch.Generator().manual_seed(seed))
    from repro_torch.core.flat import FlatSpec
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=B, device="cpu")
    return eng, eng.init(params, torch.Generator().manual_seed(seed + 1)), data


@pytest.mark.parametrize("participation", PARTICIPATIONS)
def test_run_rounds_stacks_metrics_and_is_deterministic(participation):
    outs = []
    for _ in range(2):
        eng, st, data = _data_engine(participation)
        st, ms = eng.run_rounds(st, data, 3)
        outs.append((st, ms))
    (st, ms), (st2, ms2) = outs
    assert int(st.server.round) == 3
    host = metrics_to_host(ms)
    assert all(v.shape == (3,) for v in host.values())
    assert np.all(np.isfinite(host["loss"]))
    assert np.all(host["n_active"] >= 1)
    assert torch.equal(st.params, st2.params)  # same seeds → same trajectory


def test_run_round_equals_round_step_on_its_own_draws():
    eng, st, data = _data_engine("fixed")
    gen_state = st.rng.get_state()
    a, ma = eng.run_round(st, data)
    st.rng.set_state(gen_state)
    batches, ids, mask, _ = eng._sample_round(st, data)
    b, mb = eng.round_step(st, batches, ids, mask)
    assert torch.equal(a.params, b.params)
    assert float(ma.loss) == float(mb.loss)


@pytest.mark.parametrize("knob, item", [
    ({"use_flat_plane": False}, "A.16"),
    ({"pipeline_depth": 2}, "A.8"),
    ({"staleness": 1}, "A.8"),
    ({"cohort_shard": 2}, "A.14"),
    ({"population_store": "host"}, "A.11"),
    ({"availability": "zipf"}, "A.11"),
    ({"dropout_rate": 0.1}, "A.11"),
    ({"fault": FaultConfig(store_failure_rate=0.1)}, "A.11"),
    pytest.param({"algo": "fednova"}, "unknown federated algorithm", id="unknown-algo"),
    pytest.param({"availability": "lunar"}, "unknown availability", id="unknown-availability"),
    pytest.param({"population_store": "disk"}, "unknown population_store", id="unknown-store"),
    pytest.param(None, None, id="all-eleven-algos-ported"),
])
def test_unported_config_raises_naming_roadmap_item(knob, item):
    from repro_torch.configs.base import FedConfig
    if knob is None:  # every algorithm of the reference's registry is ported
        assert list_algorithms() == ALL_ALGOS
        for algo in ALL_ALGOS:
            check_supported(FedConfig(algo=algo))
        return
    if item in ("A.8", "A.11"):
        # the async ring (A.8) and the population store (A.11) are ported:
        # their knobs are accepted, by the check and by the engine
        cfg = FedConfig(**knob)
        check_supported(cfg)
        model = mlp_classifier(DIMS)
        params = model.init(torch.Generator().manual_seed(0))
        eng = FederatedEngine(cfg, classification_loss(model.apply),
                              FlatSpec.from_tree(params), device="cpu")
        state = eng.init(params, torch.Generator().manual_seed(1))
        assert state.client_states is None  # fedcm keeps no per-client state
        return
    if item == "A.14":
        # cohort sharding (A.14) is ported: the check accepts it, and the
        # engine asks for the process group of its ranks, saying how to
        # start one (tests/test_torch_cohort_shard.py runs it)
        cfg = FedConfig(**knob)
        check_supported(cfg)
        model = mlp_classifier(DIMS)
        spec = FlatSpec.from_tree(model.init(torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match="spawn_cohort"):
            FederatedEngine(cfg, classification_loss(model.apply), spec, device="cpu")
        return
    if item == "A.16":
        # the per-leaf tree path (A.16 (d) 4) is ported: the check accepts
        # it and the engine runs a round on the params tree
        cfg = FedConfig(**knob)
        check_supported(cfg)
        model = mlp_classifier(DIMS)
        params = model.init(torch.Generator().manual_seed(0))
        eng = FederatedEngine(cfg, classification_loss(model.apply), None, device="cpu")
        state = eng.init(params, torch.Generator().manual_seed(1))
        C = cfg.cohort_size
        x = torch.zeros(C, cfg.local_steps, 2, DIMS[0])
        y = torch.zeros(C, cfg.local_steps, 2, dtype=torch.long)
        state, m = eng.round_step(state, {"x": x, "y": y}, torch.arange(C),
                                  torch.ones(C, dtype=torch.bool))
        assert isinstance(state.params, list) and bool(torch.isfinite(m.loss))
        return
    # an unknown algorithm, availability process or store is a bad value
    with pytest.raises(ValueError, match=item):
        check_supported(FedConfig(**knob))
