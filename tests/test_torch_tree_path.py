"""The per-leaf tree path (``use_flat_plane=False``) against the reference's.

The seam is ``round_step(state, batches, ids, mask, full_batches=)`` on
the reference's own draws, from one nonzero start state carried into the
port with ``core.convert.tree_state_from_numpy``.  Tolerances
(``tests/_torch_parity.py``): three chained f32 rounds at ``ROUND_ATOL`` /
rtol 1e-5 (``TREE_RTOL``), as the reference holds its flat plane to its
tree path (tests/test_flat.py); loss and ``delta_norm`` at rtol 1e-5;
``n_active`` and the byte counts exactly.  A mixed bf16/f32 tree is held
to the reference's own bar for that tree, 2e-2 (``BF16_TREE_TOL``): both
paths round the bf16 leaf at every local step, but the frameworks round a
Python scalar times a bf16 tensor differently (JAX casts the scalar to
bf16 first).
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    B,
    COHORT,
    DIMS,
    K,
    ROUND_ATOL,
    client_data,
    data_setup,
    flat_rows,
    flat_tree,
    jax_tree,
    np_params,
    port_cfg,
    ref_cfg,
    ref_draws,
    ref_engine,
    ring_start,
    small_cfg,
    torch_batches,
)
from repro.configs.base import FaultConfig as RefFaultConfig
from repro.core import client_update as ref_client_update
from repro.core import flat_client_update as ref_flat_client_update
from repro.core import registry as ref_registry
from repro.core.engine import FederatedEngine as RefEngine
from repro.core.faults import _per_client_keys
from repro.core.flat import FlatSpec as RefFlatSpec
from repro.models.small import classification_loss as ref_classification_loss
from repro.models.small import mlp_classifier as ref_mlp_classifier
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import ClientOutputs, FlatClientOutputs, client_update, flat_client_update
from repro_torch.core import engine as engine_mod
from repro_torch.core.convert import params_from_numpy, tree_state_from_numpy, tree_state_to_numpy
from repro_torch.core.engine import FederatedEngine, RoundDraws, metrics_to_host
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import (
    AlgorithmSpec,
    get_algorithm,
    register_algorithm,
    unregister_algorithm,
)
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)

TREE_RTOL = 1e-5
BF16_TREE_TOL = 2e-2
ALGOS = ref_registry.list_algorithms()
ETA_G = {"fedadam": 0.03, "fedadagrad": 0.03, "fedyogi": 0.03}
N_ROUNDS = 3
PLANES = ("params", "momentum", "second_moment", "client_states")


def _cfg(algo, participation="bernoulli", **kw):
    kw.setdefault("eta_g", ETA_G.get(algo, 1.0))
    return ref_cfg(participation, algo=algo, use_flat_plane=False, **kw)


def _loss():
    return classification_loss(mlp_classifier(DIMS).apply)


def _port_engine(pcfg):
    return FederatedEngine(pcfg, _loss(), None, batch_size=B, device="cpu")


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
    return tree_state_from_numpy(np_params(), pcfg, momentum=start["momentum"],
                                 second_moment=start["second_moment"],
                                 client_states=start["client_states"])


def _flat(st, key):
    """A state's plane as one numpy row (``(N, P)`` for the client states)."""
    tree = {"params": st["params"], "momentum": st["momentum"],
            "second_moment": st["second_moment"], "client_states": st["client_states"]}[key]
    if tree is None:
        return None
    return flat_rows(tree) if key == "client_states" else flat_tree(tree)


def _ref_numpy(st):
    return {"params": st.params, "momentum": st.server.momentum,
            "second_moment": st.server.second_moment, "client_states": st.client_states}


def _close(got, want, what, rtol=TREE_RTOL, atol=ROUND_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def _ref_step(eng, st, batches, ids, mask, full):
    return eng.round_step(st, jax.tree_util.tree_map(jnp.asarray, batches), jnp.asarray(ids),
                          jnp.asarray(mask), jax.tree_util.tree_map(jnp.asarray, full))


def _port_step(eng, st, batches, ids, mask, full, draws=None):
    return eng.round_step(st, torch_batches(batches), torch.tensor(ids), torch.tensor(mask),
                          draws=draws, full_batches=torch_batches(full))


def _rounds(cfg, n_rounds=N_ROUNDS, draws_of=None, seed=100):
    """The reference's tree path and the port's on the same draws from the
    same start: ``(ref numpy state, port numpy state, ref metrics rows,
    port metrics rows)``."""
    model = ref_mlp_classifier(DIMS)
    reng = RefEngine(cfg, ref_classification_loss(model.apply), batch_size=B)
    start = ring_start()
    rst = _ref_state(reng, start)
    pcfg = port_cfg(cfg)
    peng = _port_engine(pcfg)
    pst = _port_state(pcfg, start)
    cx, cy = client_data()
    rms, pms = [], []
    for t in range(n_rounds):
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(seed + t), t)
        full = {"x": cx[ids], "y": cy[ids]}
        rst, rm = _ref_step(reng, rst, batches, ids, mask, full)
        draws = None if draws_of is None else draws_of(cfg, t, ids)
        pst, pm = _port_step(peng, pst, batches, ids, mask, full, draws)
        rms.append({f: np.asarray(v, np.float32) for f, v in zip(rm._fields, rm)
                    if v is not None} | {"capacity": mask.size})
        pms.append({f: v[0] for f, v in metrics_to_host(pm).items()})
    ref = {k: None if v is None else jax.tree_util.tree_map(np.asarray, v)
           for k, v in _ref_numpy(rst).items()}
    return ref, tree_state_to_numpy(pst), rms, pms


def _assert_states(ref, port, **tol):
    for key in PLANES:
        r, p = _flat(ref, key), _flat(port, key)
        assert (r is None) == (p is None), key
        if r is not None:
            _close(p, r, key, **tol)


def _assert_metrics(rms, pms):
    for t, (rm, pm) in enumerate(zip(rms, pms)):
        for f in ("loss", "delta_norm", "momentum_norm", "eta_l"):
            _close(pm[f], rm[f], f"{f} round {t}", atol=1e-7)
        for f in ("n_active", "bytes_down", "bytes_up", "n_dropped", "n_quarantined",
                  "quorum_skipped"):
            assert pm[f] == rm[f], (f, t, pm[f], rm[f])


# ------------------------------------------------------------------ rounds
@lru_cache(maxsize=None)
def _three_rounds(algo):
    return _rounds(_cfg(algo))


@pytest.mark.parametrize("algo", ALGOS)
def test_three_tree_rounds_match_the_references_tree_path(algo):
    """Every spec of the reference's registry: three chained rounds on its
    draws (bernoulli, so inactive rows are exercised), every state plane
    at the end and every metric of every round."""
    ref, port, rms, pms = _three_rounds(algo)
    assert port["round"] == N_ROUNDS
    assert isinstance(port["params"], list) and set(port["params"][0]) == {"w", "b"}
    _assert_states(ref, port)
    _assert_metrics(rms, pms)
    assert any(0 < m["n_active"] < m["capacity"] for m in rms)  # an inactive row


@pytest.mark.parametrize("algo", ALGOS)
def test_tree_path_matches_the_flat_path_from_one_seed(algo):
    """``run_rounds`` on both paths from one seed: the same cohorts and
    minibatches (the same generator stream) and the same planes."""
    cfg = small_cfg(algo=algo, participation="bernoulli", eta_g=ETA_G.get(algo, 1.0))
    eng_f, st_f, data = data_setup(cfg)
    eng_t, st_t, _ = data_setup(replace(cfg, use_flat_plane=False))
    st_f, m_f = eng_f.run_rounds(st_f, data, N_ROUNDS)
    st_t, m_t = eng_t.run_rounds(st_t, data, N_ROUNDS)
    spec = eng_f.spec
    _close(spec.ravel(st_t.params), st_f.params, "params")
    _close(spec.ravel(st_t.server.momentum), st_f.server.momentum, "momentum")
    if st_f.server.second_moment is not None:
        _close(spec.ravel(st_t.server.second_moment), st_f.server.second_moment, "v")
    if st_f.client_states is not None:
        _close(spec.ravel(st_t.client_states, batch_dims=1), st_f.client_states, "cst")
    hf, ht = metrics_to_host(m_f), metrics_to_host(m_t)
    np.testing.assert_array_equal(ht["n_active"], hf["n_active"])
    _close(ht["loss"], hf["loss"], "loss", atol=1e-7)
    assert torch.equal(st_f.rng.get_state(), st_t.rng.get_state())


def test_tree_round_launches_no_kernel(monkeypatch):
    """The tree path never reaches a kernel wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the tree path reached a kernel wrapper")

    for name in ("fed_direction", "fused_fold", "fold_means", "scatter_fold"):
        monkeypatch.setattr(engine_mod, name, refuse)
    cfg = replace(small_cfg(algo="scaffold"), use_flat_plane=False)
    eng, st, data = data_setup(cfg)
    st, m = eng.run_rounds(st, data, 2)
    assert bool(torch.isfinite(m.loss).all())


# ------------------------------------------------------------------ mixed dtypes
def _mixed_loss(params, batch):
    """The reference's mixed-tree quadratic, a client row at a time:
    ``batch["c"]`` is ``(C, B, 6)``."""
    d = params["w"].to(torch.float32)[:, None, :] - batch["c"]
    b = params["b"].to(torch.float32)
    return 0.5 * (d ** 2).sum(-1).mean(-1) + 0.5 * (b ** 2).mean(-1)


def _ref_mixed_loss(params, batch):
    d = params["w"].astype(jnp.float32) - batch["c"]
    return 0.5 * jnp.mean(jnp.sum(d ** 2, -1)) + 0.5 * jnp.mean(
        params["b"].astype(jnp.float32) ** 2)


def test_mixed_bf16_f32_tree_matches_the_reference():
    """A tree mixing a bf16 and an f32 leaf, two chained rounds: the bf16
    leaf rounds at every local step on both paths and comes back from the
    server step in f32, as the reference's does (``BF16_TREE_TOL``)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6,)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    centers = rng.normal(size=(2, 2, 6)).astype(np.float32)
    cfg = replace(ref_cfg("fixed", algo="fedcm", use_flat_plane=False, weight_decay=0.0),
                  num_clients=4, cohort_size=2)
    reng = RefEngine(cfg, _ref_mixed_loss, batch_size=2)
    rst = reng.init({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)},
                    jax.random.PRNGKey(0))
    peng = FederatedEngine(port_cfg(cfg), _mixed_loss, None, batch_size=2, device="cpu")
    pst = peng.init({"w": torch.tensor(w).to(torch.bfloat16), "b": torch.tensor(b)})
    c = np.ascontiguousarray(np.broadcast_to(centers[:, None], (2, K, 2, 6)))  # (C, K, B, 6)
    ids, mask = np.arange(2), np.ones(2, bool)
    for _ in range(2):
        rst, _ = reng.round_step(rst, {"c": jnp.asarray(c)}, jnp.asarray(ids),
                                 jnp.asarray(mask))
        pst, _ = peng.round_step(pst, {"c": torch.tensor(np.array(c))}, torch.tensor(ids),
                                 torch.tensor(mask))
        for k in ("w", "b"):
            assert str(pst.params[k].dtype).split(".")[-1] == str(rst.params[k].dtype)
    for k in ("w", "b"):
        _close(pst.params[k].float(), np.asarray(rst.params[k], np.float32), k,
               rtol=BF16_TREE_TOL, atol=BF16_TREE_TOL)
        _close(pst.server.momentum[k], np.asarray(rst.server.momentum[k]), k,
               rtol=BF16_TREE_TOL, atol=BF16_TREE_TOL)


# ------------------------------------------------------------------ faults
def _tree_draws(cfg, t, ids):
    """The reference's fault draws of round ``t`` for the tree path: the
    noise of leaf i from ``fold_in(client key, i)``, leaves in order."""
    f = cfg.fault
    ids = jnp.asarray(ids)
    kt = jax.random.fold_in(jax.random.PRNGKey(f.seed), t)
    one_u = jax.vmap(lambda k: jax.random.uniform(k, ()))
    out = {}
    if f.drop_rate > 0:
        out["u_drop"] = one_u(_per_client_keys(kt, 1, ids))
    if f.corrupt_rate > 0:
        out["u_corrupt"] = one_u(_per_client_keys(kt, 3, ids))
        if f.corrupt_mode == "noise":
            keys = _per_client_keys(kt, 4, ids)
            shapes = [l.shape for l in jax.tree_util.tree_leaves(np_params())]
            cols = [jax.vmap(lambda k, i=i, s=s: jax.random.normal(
                jax.random.fold_in(k, i), s, jnp.float32).reshape(-1))(keys)
                for i, s in enumerate(shapes)]
            out["z_noise"] = jnp.concatenate(cols, axis=1)
    return RoundDraws(**{k: torch.tensor(np.asarray(v)) for k, v in out.items()})


FAULTS = {
    "drop": dict(fault=RefFaultConfig(drop_rate=0.4, seed=3)),
    "corrupt-nan": dict(fault=RefFaultConfig(corrupt_rate=0.5, corrupt_mode="nan", seed=1)),
    "quarantine-norm": dict(fault=RefFaultConfig(corrupt_rate=0.5, corrupt_mode="noise",
                                                 noise_scale=50.0, quarantine_norm_mult=2.0,
                                                 seed=4)),
    "below-quorum": dict(min_quorum=COHORT + 1),
}


@pytest.mark.parametrize("case", list(FAULTS))
def test_faults_and_quorum_match_the_references_tree_path(case):
    """SCAFFOLD (client states and two fold rows) under each fault, with
    the reference's draws injected: the noise of the norm case is drawn
    leaf by leaf."""
    cfg = _cfg("scaffold", "fixed", **FAULTS[case])
    draws_of = _tree_draws if cfg.fault is not None else None
    ref, port, rms, pms = _rounds(cfg, n_rounds=2, draws_of=draws_of, seed=200)
    _assert_states(ref, port)
    _assert_metrics(rms, pms)
    if case == "below-quorum":
        assert all(m["quorum_skipped"] == 1.0 for m in pms)
        _close(_flat(port, "params"), flat_tree(np_params()), "params carried", rtol=0,
               atol=0)
    elif case == "drop":
        assert sum(m["n_dropped"] for m in pms) > 0
    else:
        assert sum(m["n_quarantined"] for m in pms) > 0


# ------------------------------------------------------------------ escape hatches
SEEN = []


def _port_tree_direction(cfg, m, cst, x, x0, g):
    SEEN.append(type(g))
    n = torch.sqrt(sum(torch.sum(a * a) for a in tree_leaves(g))) + 1e-12
    return tree_map(lambda a: a / n, g)


def _port_tree_server(cfg, params, server, mean_delta, mean_sd, mean_extra, n_active, eta_l):
    SEEN.append(type(mean_delta))
    new = tree_map(lambda p, d: p + cfg.eta_g * d, params, mean_delta)
    return new, server._replace(round=server.round + 1)


def _ref_tree_direction(cfg, m, cst, x, x0, g):
    n = jnp.sqrt(sum(jnp.sum(a * a) for a in jax.tree_util.tree_leaves(g))) + 1e-12
    return jax.tree_util.tree_map(lambda a: a / n, g)


def _ref_tree_server(cfg, params, server, mean_delta, mean_sd, mean_extra, n_active, eta_l):
    new = jax.tree_util.tree_map(lambda p, d: p + cfg.eta_g * d, params, mean_delta)
    return new, server._replace(round=server.round + 1)


def test_user_direction_fn_and_server_fn_see_trees():
    """A runtime spec whose ``direction_fn`` normalizes by the whole tree's
    norm (not elementwise: it must see one client's tree) and whose
    ``server_fn`` averages trees: two rounds against the reference."""
    name = "_test_tree_hatch"
    register_algorithm(AlgorithmSpec(name=name, direction_row=None,
                                     direction_fn=_port_tree_direction, fold=(),
                                     server_fn=_port_tree_server), override=True)
    ref_registry.register_algorithm(ref_registry.AlgorithmSpec(
        name=name, direction_row=None, direction_fn=_ref_tree_direction, fold=(),
        server_fn=_ref_tree_server), override=True)
    SEEN.clear()
    try:
        ref, port, rms, pms = _rounds(_cfg(name, "fixed"), n_rounds=2, seed=300)
    finally:
        unregister_algorithm(name)
        ref_registry.unregister_algorithm(name)
    assert set(SEEN) == {list}  # the MLP's params tree, one client at a time
    _assert_states(ref, port)
    _assert_metrics(rms, pms)


# ------------------------------------------------------------------ one client
def _one_client(algo):
    rng = np.random.default_rng(11)
    start = ring_start()
    cx, cy = client_data()
    idx = rng.integers(0, cx.shape[1], size=(K, B))
    batches = {"x": cx[2][idx], "y": cy[2][idx]}
    full = {"x": cx[2], "y": cy[2]}
    cst = jax.tree_util.tree_map(lambda a: a[2], start["client_states"])
    return start, batches, full, cst


@pytest.mark.parametrize("algo", ["fedcm", "scaffold", "mimelite", "feddyn"])
def test_client_update_matches_the_reference(algo):
    cfg = _cfg(algo)
    start, batches, full, cst = _one_client(algo)
    model = ref_mlp_classifier(DIMS)
    spec = ref_registry.get_algorithm(algo)
    r_outs, r_loss = ref_client_update(
        spec, cfg, ref_classification_loss(model.apply), jax_tree(np_params()),
        jax_tree(start["momentum"]), jax_tree(cst), jax_tree(batches), jnp.float32(0.05),
        full_grad_batch=jax_tree(full))
    outs, loss = client_update(
        get_algorithm(algo), port_cfg(cfg), _loss(), params_from_numpy(np_params()),
        params_from_numpy(start["momentum"]), params_from_numpy(cst),
        {"x": torch.tensor(batches["x"]), "y": torch.tensor(batches["y"]).long()},
        torch.tensor(0.05), full_grad_batch={"x": torch.tensor(full["x"]),
                                             "y": torch.tensor(full["y"]).long()})
    assert isinstance(outs, ClientOutputs)
    for f in ClientOutputs._fields:
        _close(flat_tree(tree_map(lambda a: a.numpy(), getattr(outs, f))),
               flat_tree(getattr(r_outs, f)), f)
    _close(loss, r_loss, "loss", atol=1e-7)


@pytest.mark.parametrize("algo", ["fedcm", "scaffold", "mimelite"])
def test_flat_client_update_matches_the_reference(algo):
    """The one-row cohort pass against the reference's ``flat_client_update``
    (its leaf route, raveled)."""
    cfg = ref_cfg("fixed", algo=algo)
    start, batches, full, cst = _one_client(algo)
    model = ref_mlp_classifier(DIMS)
    params = jax_tree(np_params())
    rspec = RefFlatSpec.from_tree(params)
    m_tree, cst_tree = jax_tree(start["momentum"]), jax_tree(cst)
    uses_state = ref_registry.get_algorithm(algo).needs_client_state
    r_outs, r_loss = ref_flat_client_update(
        ref_registry.get_algorithm(algo), cfg, ref_classification_loss(model.apply), rspec,
        rspec.ravel(params), params, rspec.ravel(m_tree), m_tree,
        cst_tree if uses_state else None, rspec.ravel(cst_tree) if uses_state else None,
        jax_tree(batches), jnp.float32(0.05), full_grad_batch=jax_tree(full))
    tparams = params_from_numpy(np_params())
    spec = FlatSpec.from_tree(tparams)
    m_flat = spec.ravel(params_from_numpy(start["momentum"]))
    c_flat = spec.ravel(params_from_numpy(cst)) if uses_state else None
    outs, loss = flat_client_update(
        algo, port_cfg(cfg), _loss(), spec, spec.ravel(tparams), None, m_flat, None, None,
        c_flat, {"x": torch.tensor(batches["x"]), "y": torch.tensor(batches["y"]).long()},
        torch.tensor(0.05), full_grad_batch={"x": torch.tensor(full["x"]),
                                             "y": torch.tensor(full["y"]).long()})
    assert isinstance(outs, FlatClientOutputs)
    for f in FlatClientOutputs._fields:
        r = getattr(r_outs, f)
        assert (r is None) == (getattr(outs, f) is None), f
        if r is not None:
            _close(getattr(outs, f), flat_tree(r), f)
    _close(loss, r_loss, "loss", atol=1e-7)


# ------------------------------------------------------------------ refusals
def _ref_refusal(cfg, call=None):
    model = ref_mlp_classifier(DIMS)
    with pytest.raises(ValueError) as e:
        eng = RefEngine(cfg, ref_classification_loss(model.apply), batch_size=B)
        call(eng)
    return str(e.value)


REFUSALS = {
    "compression": dict(compression=True),
    "host-store": dict(population_store="host"),
    "cohort-shard": dict(cohort_shard=1),
    "async": dict(),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tree_path_refuses_what_the_reference_refuses(case):
    """The four refusals, each with the reference's message."""
    from repro.configs.base import CompressionConfig as RefCompressionConfig

    kw = dict(REFUSALS[case])
    if kw.pop("compression", False):
        kw["compression"] = RefCompressionConfig(kind="int8")
    cfg = _cfg("fedcm", "fixed", **kw)
    pcfg = port_cfg(cfg)

    def ring(eng):
        eng.run_rounds_async(None, None, 2, pipeline_depth=2)

    want = _ref_refusal(cfg, ring)
    with pytest.raises(ValueError) as e:
        eng = _port_engine(pcfg)
        ring(eng)
    assert str(e.value) == want


def test_compression_declared_by_the_spec_is_refused_too():
    cfg = replace(small_cfg(), use_flat_plane=False,
                  compression=CompressionConfig(kind="bf16"))
    with pytest.raises(ValueError, match="flat-plane transform"):
        _port_engine(cfg)


def test_an_integer_leaf_raises_typeerror_at_the_gradient_as_in_the_reference():
    """The reference's tree path takes an int leaf into its state and
    raises ``TypeError`` from ``jax.grad`` at the round; so does the port."""
    cfg = _cfg("fedcm", "fixed")

    def ref_loss(p, batch):
        return jnp.mean((p["w"] - batch["c"]) ** 2) + 0.0 * p["i"].sum()

    def loss(p, batch):
        return ((p["w"][:, None, :] - batch["c"]) ** 2).mean((-1, -2)) + 0.0 * p["i"].sum(-1)

    c = np.zeros((COHORT, K, B, 3), np.float32)
    ids, mask = np.arange(COHORT), np.ones(COHORT, bool)
    reng = RefEngine(cfg, ref_loss, batch_size=B)
    rst = reng.init({"w": jnp.zeros(3), "i": jnp.arange(3, dtype=jnp.int32)},
                    jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        reng.round_step(rst, {"c": jnp.asarray(c)}, jnp.asarray(ids), jnp.asarray(mask))
    eng = FederatedEngine(port_cfg(cfg), loss, None, batch_size=B, device="cpu")
    st = eng.init({"w": torch.zeros(3), "i": torch.arange(3, dtype=torch.int32)})
    assert st.params["i"].dtype == torch.int32
    with pytest.raises(TypeError, match=r"\['i'\] has dtype torch.int32"):
        eng.round_step(st, {"c": torch.tensor(c)}, torch.tensor(ids), torch.tensor(mask))


def test_tree_state_round_trips_through_numpy():
    pcfg = port_cfg(_cfg("scaffold"))
    start = ring_start()
    st = _port_state(pcfg, start)
    back = tree_state_to_numpy(st)
    np.testing.assert_array_equal(flat_tree(back["params"]), flat_tree(np_params()))
    np.testing.assert_array_equal(flat_tree(back["momentum"]), flat_tree(start["momentum"]))
    np.testing.assert_array_equal(flat_rows(back["client_states"]),
                                  flat_rows(start["client_states"]))
    assert back["second_moment"] is None and back["round"] == 0


def test_tree_run_rounds_leaves_the_callers_state_intact():
    cfg = replace(small_cfg(algo="scaffold"), use_flat_plane=False)
    eng, st, data = data_setup(cfg)
    before = [a.clone() for a in tree_leaves(st.params) + tree_leaves(st.client_states)]
    eng.run_rounds(st, data, 2)
    after = tree_leaves(st.params) + tree_leaves(st.client_states)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_engine_params_tree_is_the_model_tree_on_both_paths():
    cfg = small_cfg()
    eng_f, st_f, _ = data_setup(cfg)
    eng_t, st_t, _ = data_setup(replace(cfg, use_flat_plane=False))
    for a, b in zip(tree_leaves(eng_f.params_tree(st_f)), tree_leaves(eng_t.params_tree(st_t))):
        assert torch.equal(a, b)


def test_ref_engine_helper_builds_the_flat_route():
    """``_torch_parity.ref_engine`` stays the flat route the other files use."""
    assert ref_engine(ref_cfg())[0].cfg.use_flat_plane


# ------------------------------------------------------------------ the CLI
def test_cli_no_flat_plane_logs_the_flat_runs_losses():
    from repro_torch.launch.fed_train import build_parser, resolve_config, run_federated

    losses = {}
    for flag in ("--flat-plane", "--no-flat-plane"):
        args = build_parser().parse_args(["--clients", "20", "--cohort", "4", "--rounds", "4",
                                          "--local-steps", "2", "--algo", "scaffold", flag])
        cfg = resolve_config(args)
        assert cfg.use_flat_plane == (flag == "--flat-plane")
        _, log = run_federated(cfg, 0.6, eval_every=2, n_train=2_000, n_test=100,
                               echo=False, device="cpu")
        losses[flag] = log.column("loss")
    _close(losses["--no-flat-plane"], losses["--flat-plane"], "logged loss", atol=1e-4)


@pytest.mark.parametrize("argv", [["--cohort-shard", "2"], ["--population-store", "host"],
                                  ["--ckpt-every", "2", "--ckpt-dir", "d"]])
def test_cli_no_flat_plane_refusals(argv, capsys):
    from repro_torch.launch.fed_train import main

    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--no-flat-plane", *argv])
    assert e.value.code == 2 and "--no-flat-plane" in capsys.readouterr().err
