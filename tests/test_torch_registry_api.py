"""The public algorithm API of the port against the reference's.

* registry mechanics: lookup errors name the registered set, duplicates
  need ``override=True``, the decorator forms, ``unregister_algorithm``,
  the ``Algorithm`` alias and the ``ALGORITHMS`` view;
* validation: every case of the reference's tests/test_registry.py table is
  refused by both registries with the same message;
* the plane properties and routing rows, and the ``kernels/README.md``
  table in sync with the registry (``python -m repro_torch.core.registry``
  prints it);
* four specs registered at runtime (tests/_torch_user_specs.py: the
  reference's affine ``_test_damped``, the escape hatches ``_test_escape``,
  the mixed ``_test_mixed`` and a ``server_fn`` over client state) each run
  three rounds against the reference's ``round_step`` on its draws, on its
  kernel (interpret mode) and jnp routes, and the async ring against its
  ``run_rounds_async``;
* in the port, bitwise: the ring at D = 1, S = 0 ≡ the sync round, the host
  store ≡ resident state, below quorum the planes carry through; the
  ``direction_fn`` sees one client row at a time.

Tolerances (tests/_torch_parity.py): ``RTOL`` 2e-5 with ``ATOL`` 1e-6 for
one round and the unit pieces, ``ROUND_ATOL`` 1e-5 after three rounds (the
smoke script's ``PARITY_RTOL`` / ``PARITY_ATOL``); int8 rounds within
``FLIP_MAX`` floor flips.  The port's ``server_fn`` means come from the
fold kernel's ``Σ (w/n)·a``, the reference's from ``(Σ w·a)/n``: the same
values to reassociation.
"""
import contextlib
import subprocess
import sys
from dataclasses import replace
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    COHORT, ROUND_ATOL, assert_close, assert_ring_states, assert_states_equal, client_data,
    count_flips, data_setup, jax_tree, np_params, port_cfg, port_engine, ref_cfg, ref_draws,
    ref_engine, ref_round_draws, ref_state_numpy, ring_parity, ring_start, small_cfg,
    torch_batches,
)
from _torch_user_specs import NAMES, averaging_server, normalized_direction, registered, specs
import repro.core.algorithms  # noqa: F401  (registers the reference's specs)
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro.core import registry as ref_registry
from repro.kernels.fed_direction.ops import flat_direction_step as ref_flat_direction_step
from repro_torch.core import ALGORITHMS, registry
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.registry import (
    Algorithm, AlgorithmSpec, FoldPass, ServerState, describe_algorithm,
    get_algorithm, list_algorithms, register_algorithm, routing_table_md, sync_readme,
    unregister_algorithm,
)
from repro_torch.kernels.fed_direction.ops import direction_operands, flat_direction_step
from repro_torch.launch.fed_train import list_algos_text

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BUILTINS = ("fedacg", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedcm", "feddyn",
            "fedprox", "fedyogi", "mimelite", "scaffold")
ROUTES = ("kernel", "jnp")
SERVER_FN_SPECS = ("_test_escape", "_test_mixed", "_test_escape_state")
PLANES = ("params", "momentum", "client_states")


# ---------------------------------------------------------------- the specs, both packages
def _ref_specs():
    """The reference's counterparts of tests/_torch_user_specs.py.  Its jnp
    route hands a direction leaf trees, its kernel route one client's (P,)
    buffer, so the direction sums over the tree's leaves."""
    R = ref_registry

    def normalized(cfg, m, cst, x, x0, g):
        norm = jnp.sqrt(sum(jnp.sum(l * l) for l in jax.tree_util.tree_leaves(g))) + 1e-12
        return jax.tree_util.tree_map(lambda l: l / norm, g)

    def averaging(cfg, params, st, md, msd, mex, n, eta_l):
        new = jax.tree_util.tree_map(lambda p, d: p + cfg.eta_g * d, params, md)
        return new, st._replace(round=st.round + 1)

    def state_server(cfg, params, st, md, msd, mex, n, eta_l):
        m = jax.tree_util.tree_map(lambda a, b: a + b * (n / cfg.num_clients), st.momentum, msd)
        new = jax.tree_util.tree_map(lambda p, d: p + cfg.eta_g * d, params, md)
        return new, st._replace(momentum=m, round=st.round + 1)

    return {
        "_test_damped": R.AlgorithmSpec(
            name="_test_damped", direction_row=R.DirectionRow(c_g=0.7, c_x=0.05),
            fold=(R.FoldPass("delta", c_mm=0.0,
                             c_md=lambda cfg, e, n: -1.0 / (e * cfg.local_steps),
                             c_xd=lambda cfg, e, n: cfg.eta_g),)),
        "_test_escape": R.AlgorithmSpec(
            name="_test_escape", direction_row=None, direction_fn=normalized, fold=(),
            server_fn=averaging),
        "_test_mixed": R.AlgorithmSpec(
            name="_test_mixed", direction_row=R.DirectionRow(), server_fn=averaging),
        "_test_escape_state": R.AlgorithmSpec(
            name="_test_escape_state",
            direction_row=R.DirectionRow(aux=(("client_state", -1.0), ("momentum", 1.0))),
            state_update_fn=R.get_algorithm("scaffold").state_update_fn,
            server_fn=state_server, needs_client_state=True, needs_momentum_broadcast=True,
            client_state_uplink=True),
    }


@contextlib.contextmanager
def _ref_registered():
    for spec in _ref_specs().values():
        ref_registry.register_algorithm(spec, override=True)
    try:
        yield
    finally:
        for name in NAMES:
            ref_registry.unregister_algorithm(name)


@pytest.fixture
def user_specs():
    """The four specs registered in both registries for one test."""
    with registered(), _ref_registered():
        yield


# ---------------------------------------------------------------- mechanics
def test_get_algorithm_unknown_names_the_registry():
    with pytest.raises(KeyError, match="fedcm"):
        get_algorithm("sgd")


def test_duplicate_registration_rejected_unless_override():
    spec = get_algorithm("fedavg")
    with pytest.raises(ValueError, match="already registered"):
        register_algorithm(spec)
    assert register_algorithm(spec, override=True) is spec
    assert get_algorithm("fedavg") is spec


def test_register_forms_and_unregister():
    def build():
        return AlgorithmSpec(name="_test_form", fold=(FoldPass("delta", c_xd=1.0),))

    try:
        assert register_algorithm(build).name == "_test_form"  # a builder
        with pytest.raises(ValueError, match="already registered"):
            register_algorithm(build)
        decorated = register_algorithm(override=True)(build)  # @register_algorithm(override=True)
        assert decorated is get_algorithm("_test_form")
        assert "_test_form" in ALGORITHMS and ALGORITHMS["_test_form"] is decorated
        assert "_test_form" in list_algorithms() and len(ALGORITHMS) == len(list_algorithms())
    finally:
        unregister_algorithm("_test_form")
    assert "_test_form" not in ALGORITHMS
    unregister_algorithm("_test_form")  # a name not registered is ignored
    with pytest.raises(TypeError, match="expected AlgorithmSpec"):
        register_algorithm(lambda: "fedavg")


def test_algorithm_alias_and_view():
    assert Algorithm is AlgorithmSpec
    assert list(ALGORITHMS) == list(BUILTINS) == list(ALGORITHMS.keys())
    assert [n for n, _ in ALGORITHMS.items()] == list(BUILTINS)


# reference tests/test_registry.py::test_spec_validation, case for case
def _validation_cases(m):
    return [
        (dict(name="x", direction_row=m.DirectionRow(aux=(("nope", 1.0),))),
         "unknown direction stream"),
        (dict(name="x", direction_row=m.DirectionRow(aux=(("client_state", 1.0),))),
         "needs_client_state"),
        (dict(name="x", direction_row=m.DirectionRow(aux=(("momentum", 1.0),))),
         "needs_momentum_broadcast"),
        (dict(name="x", needs_client_state=True), "state_update_fn"),
        (dict(name="x", client_state_uplink=True), "without client state"),
        (dict(name="x", fold=(m.FoldPass("nope"),)), "unknown fold plane"),
        (dict(name="x", fold=(m.FoldPass("state_delta"),)), "without client state"),
        (dict(name="x", fold=(m.FoldPass("extra"),)), "without needs_full_grad"),
        (dict(name="x", fold=()), "escape hatch"),
        (dict(name="x"), "never move"),
        (dict(name="x", fold=(m.FoldPass("delta", c_mm=1.0, c_md=0.0, c_xd=0.0),)),
         "never move"),
        (dict(name="x", direction_fn=lambda *a: a), "exactly one of"),
        (dict(name="x", momentum_store="bf16"), "momentum_store"),
        (dict(name="x", server_fn=averaging_server,
              server_post_fn=lambda cfg, x, s, *a: (x, s)), "server_fn replaces fold\\+post"),
    ]


@pytest.mark.parametrize("case", range(len(_validation_cases(registry))))
def test_spec_validation_refuses_as_the_reference_does(case):
    for m in (ref_registry, registry):
        bad, match = _validation_cases(m)[case]
        with pytest.raises(ValueError, match=match):
            m.register_algorithm(m.AlgorithmSpec(**bad))
    assert "x" not in list_algorithms()


def test_escape_hatch_specs_validate():
    for name, spec in specs().items():
        registry._validate(spec)
        ref_registry._validate(_ref_specs()[name])


@pytest.mark.parametrize("name", BUILTINS + NAMES)
def test_plane_properties_equal_the_reference(name):
    spec = get_algorithm(name) if name in BUILTINS else specs()[name]
    ref = (ref_registry.get_algorithm(name) if name in BUILTINS else _ref_specs()[name])
    assert spec.uplink_planes == ref.uplink_planes
    assert spec.fold_planes == ref.fold_planes
    assert spec.wire_uplink_planes == ref.wire_uplink_planes


def test_escape_hatch_routing_rows():
    s = specs()
    assert describe_algorithm(s["_test_escape"]) == {
        "algorithm": "_test_escape",
        "local step": "custom PyTorch (`direction_fn`, a client row at a time)",
        "server fold": "`server_update` mean ×1 + custom (`server_fn`)",
        "state planes": "—", "uplink": "1×P (delta)", "wire": "f32"}
    row = describe_algorithm(s["_test_escape_state"])
    assert row["local step"] == "`fed_direction` affine: g + client_state + momentum"
    assert row["server fold"] == "`server_update` mean ×2 + custom (`server_fn`)"
    assert describe_algorithm(s["_test_damped"]) == \
        ref_registry.describe_algorithm(_ref_specs()["_test_damped"])


def test_routing_table_equals_the_reference_and_the_readme():
    assert routing_table_md() == ref_registry.routing_table_md()
    assert sync_readme()
    text = (ROOT / "src/repro_torch/kernels/README.md").read_text()
    assert f"{registry.README_BEGIN}\n{routing_table_md()}\n{registry.README_END}" in text


def test_registry_module_prints_the_table():
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.registry"], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == routing_table_md()


def test_list_algos_renders_runtime_specs(user_specs):
    text = list_algos_text()
    for name in NAMES:
        assert name in text
    assert "custom PyTorch (`direction_fn`" in text


def test_interpreters_refuse_what_the_kernels_run():
    fedcm = get_algorithm("fedcm")
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="fed_direction kernel"):
        fedcm.direction(None, z, None, z, z, z)
    with pytest.raises(ValueError, match="server_update kernel"):
        fedcm.server_update(None, z, None, z, None, None, 1.0, 0.1)
    with pytest.raises(ValueError, match="launches no fed_direction"):
        direction_operands(specs()["_test_escape"], small_cfg(), z, None, z,
                           torch.tensor(0.1))


def test_escape_direction_step_matches_the_reference():
    """``flat_direction_step`` of a ``direction_fn`` spec on one client's
    ``(P,)`` buffers: x − η_l·v in x's dtype, as the reference's."""
    rng = np.random.default_rng(3)
    x, g, m, x0 = (rng.normal(size=257).astype(np.float32) for _ in range(4))
    cfg = ref_cfg()
    got = flat_direction_step(specs()["_test_escape"], port_cfg(cfg), torch.tensor(x),
                              torch.tensor(g), torch.tensor(m), None, torch.tensor(x0),
                              torch.tensor(0.05))
    want = ref_flat_direction_step(_ref_specs()["_test_escape"], cfg, jnp.asarray(x),
                                   jnp.asarray(g), jnp.asarray(m), None, jnp.asarray(x0),
                                   jnp.float32(0.05))
    assert got.dtype == torch.float32
    assert_close(got, want, what="escape step")


@pytest.mark.parametrize("discount", [1.0, 0.9])
def test_server_update_discounts_every_mean(discount):
    """``server_update`` hands a ``server_fn`` γ·mean of each plane."""
    rng = np.random.default_rng(4)
    x, md, msd, m = (rng.normal(size=64).astype(np.float32) for _ in range(4))
    cfg = ref_cfg(eta_g=0.7)
    name = "_test_escape_state"
    px, psrv = specs()[name].server_update(
        port_cfg(cfg), torch.tensor(x),
        ServerState(momentum=torch.tensor(m), round=torch.tensor(2, dtype=torch.int32)),
        torch.tensor(md), torch.tensor(msd), None, torch.tensor(3.0), torch.tensor(0.05),
        discount=discount)
    rx, rsrv = _ref_specs()[name].server_update(
        cfg, jnp.asarray(x), ref_registry.ServerState(momentum=jnp.asarray(m),
                                                      second_moment=None, round=jnp.int32(2)),
        jnp.asarray(md), jnp.asarray(msd), None, jnp.float32(3.0), jnp.float32(0.05),
        discount=discount)
    assert_close(px, rx, what="params")
    assert_close(psrv.momentum, rsrv.momentum, what="momentum")
    assert int(psrv.round) == int(rsrv.round) == 3


# ---------------------------------------------------------------- rounds vs the reference
def _ref_state(eng, start):
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(0))
    st = st._replace(server=st.server._replace(momentum=jax_tree(start["momentum"])))
    if st.client_states is not None:
        st = st._replace(client_states=jax_tree(start["client_states"]))
    return st


def _port_state(pcfg, start):
    state, _ = state_from_numpy(np_params(), pcfg, momentum=start["momentum"],
                                client_states=start["client_states"])
    return state


@lru_cache(maxsize=None)
def _three_rounds(name, route):
    """Three chained rounds (bernoulli: inactive rows) of both packages on
    the reference's draws from one nonzero state: the loss per round and
    the numpy planes after them."""
    with registered(), _ref_registered():
        cfg = ref_cfg("bernoulli", algo=name, use_fused_kernel=(route == "kernel"), eta_g=0.8)
        reng, _ = ref_engine(cfg)
        start = ring_start()
        rst = _ref_state(reng, start)
        pcfg = port_cfg(cfg)
        peng, pst = port_engine(pcfg), _port_state(pcfg, start)
        cx, cy = client_data()
        ref_loss, port_loss, masks = [], [], []
        for t in range(3):
            batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(200 + t), t)
            rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                      jnp.asarray(ids), jnp.asarray(mask))
            pst, pm = peng.round_step(pst, torch_batches(batches), torch.tensor(ids),
                                      torch.tensor(mask))
            ref_loss.append(float(rm.loss))
            port_loss.append(float(pm.loss))
            masks.append(mask)
        return (ref_loss, ref_state_numpy(rst)), (port_loss, state_to_numpy(pst)), masks


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", NAMES)
def test_three_rounds_match_the_reference(name, route):
    (ref_loss, ref), (port_loss, port), masks = _three_rounds(name, route)
    assert any(0 < m.sum() < m.size for m in masks)  # inactive rows in the fold
    assert_close(port_loss, ref_loss, atol=ROUND_ATOL, what="loss per round")
    assert port["round"] == ref["round"] == 3
    for key in PLANES:
        assert (ref[key] is None) == (port[key] is None), key
        if ref[key] is not None:
            assert_close(port[key], ref[key], atol=ROUND_ATOL, what=key)


@pytest.mark.parametrize("name", ["_test_escape", "_test_escape_state"])
def test_ring_matches_the_reference(name, user_specs):
    """The async ring (D = 2, S = 1, γ = 0.9) against the reference's
    ``run_rounds_async`` on its draws: ``server_fn`` gets γ·mean."""
    r = ring_parity(name, 2, 1, 0.9, route="kernel")
    assert_ring_states(r)


@pytest.mark.parametrize("name", ["_test_mixed", "_test_escape_state"])
def test_int8_server_fn_matches_the_reference(name, user_specs):
    """int8 wire planes: the port's dequant fold takes each mean from the
    quantized plane, the reference decodes and then reduces; three rounds,
    each from the reference's state, within ``FLIP_MAX`` floor flips."""
    cfg = ref_cfg(algo=name, use_fused_kernel=True,
                  compression=RefCompressionConfig(kind="int8", seed=3))
    reng, _ = ref_engine(cfg)
    rst = _ref_state(reng, ring_start())
    peng = port_engine(port_cfg(cfg))
    cx, cy = client_data()
    for t in range(3):
        before = ref_state_numpy(rst)
        pst, _ = state_from_numpy(np_params(), peng.cfg, momentum=before["momentum"], round=t,
                                  client_states=before["client_states"])
        pst = pst._replace(params=torch.tensor(before["params"]))
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(300 + t), t)
        rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                  jnp.asarray(ids), jnp.asarray(mask))
        nst, pm = peng.round_step(pst, torch_batches(batches), torch.tensor(ids),
                                  torch.tensor(mask),
                                  draws=ref_round_draws(cfg, t, ids, peng.spec.size))
        ref, got = ref_state_numpy(rst), state_to_numpy(nst)
        for key in PLANES:
            assert (ref[key] is None) == (got[key] is None), key
            if ref[key] is not None:
                count_flips(got[key], ref[key], before[key], f"round {t} {key}")
        assert float(pm.bytes_up) == float(rm.bytes_up)


# ---------------------------------------------------------------- in-port contracts
@pytest.mark.parametrize("name", NAMES)
def test_ring_d1_s0_is_the_sync_round_bitwise(name, user_specs):
    eng, st, data = data_setup(small_cfg(algo=name))
    sync, _ = eng.run_rounds(st, data, 3)
    eng, st, data = data_setup(small_cfg(algo=name))
    ring, ms = eng.run_rounds_async(st, data, 3, pipeline_depth=1, staleness=0)
    assert_states_equal(sync, ring)
    np.testing.assert_array_equal(ms.folded.numpy(), [1, 1, 1])


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_host_store_is_resident_state_bitwise(name, compression, user_specs):
    from repro_torch.configs.base import CompressionConfig

    comp = None if compression is None else CompressionConfig(kind=compression)
    eng, st, data = data_setup(small_cfg(algo=name, compression=comp))
    res, rm = eng.run_rounds(st, data, 3)
    eng, st, data = data_setup(small_cfg(algo=name, compression=comp,
                                         population_store="host"))
    sto, sm = eng.run_rounds(st, data, 3)
    assert torch.equal(res.params, sto.params)
    assert torch.equal(res.server.momentum, sto.server.momentum)
    assert torch.equal(rm.loss, sm.loss)
    if eng.population is not None:  # the client-state rows, gathered from the store
        ids = np.arange(eng.cfg.num_clients)
        np.testing.assert_array_equal(eng.population.gather(ids), res.client_states.numpy())


@pytest.mark.parametrize("name", SERVER_FN_SPECS)
def test_below_quorum_carries_the_planes_through(name, user_specs):
    """A quorum above the cohort: params, momentum and client states stay,
    the round counter advances, ``quorum_skipped`` is 1."""
    eng, st, data = data_setup(small_cfg(algo=name, min_quorum=COHORT + 1))
    out, ms = eng.run_rounds(st, data, 2)
    assert torch.equal(out.params, st.params)
    assert torch.equal(out.server.momentum, st.server.momentum)
    if st.client_states is not None:
        assert torch.equal(out.client_states, st.client_states)
    assert int(out.server.round) == 2
    np.testing.assert_array_equal(ms.quorum_skipped.numpy(), [1.0, 1.0])


def test_direction_fn_sees_one_client_row_at_a_time(user_specs):
    """The engine's local step of a ``direction_fn`` spec normalizes each
    client's gradient alone; the same callable over the whole ``(C, P)``
    plane would normalize by the cohort's norm and step elsewhere."""
    eng, st, data = data_setup(replace(small_cfg(algo="_test_escape"), local_steps=1,
                                       weight_decay=0.0))
    batches, ids, mask, _ = eng._sample_round(st, data)
    eta = torch.tensor(0.1)
    planes, _ = eng._flat_cohort_pass(st.params, st.server.momentum, batches, eta)
    x0 = st.params.expand(ids.shape[0], -1).contiguous()
    _, g = eng._value_and_grad(x0, {k: v[:, 0] for k, v in batches.items()})
    rows = torch.stack([x0[c] - eta * normalized_direction(None, None, None, None, None, g[c])
                        for c in range(g.shape[0])])
    assert torch.equal(planes["delta"], rows - x0)
    whole = x0 - eta * normalized_direction(None, None, None, None, None, g)
    assert not torch.allclose(whole - x0, planes["delta"], rtol=1e-3, atol=0)


def test_server_fn_launches_no_fold_row(user_specs, monkeypatch):
    """A ``server_fn`` round close takes one mean-only pass a plane (neither
    x nor m written) and no fold row; an affine direction still takes the
    ``fed_direction`` route once a local step."""
    from repro_torch.kernels.server_update import ops as su_ops
    from repro_torch.core import engine as engine_mod

    calls, steps = [], []
    real_step, real_dir = su_ops.fused_server_step, engine_mod.fed_direction

    def spy_step(*a, **kw):
        calls.append((kw["write_x"], kw["write_m"]))
        return real_step(*a, **kw)

    def spy_dir(*a, **kw):
        steps.append(1)
        return real_dir(*a, **kw)

    monkeypatch.setattr(su_ops, "fused_server_step", spy_step)
    monkeypatch.setattr(engine_mod, "fed_direction", spy_dir)
    for name, planes, launches in (("_test_mixed", 1, 2), ("_test_escape_state", 2, 2),
                                   ("_test_escape", 1, 0)):
        calls.clear()
        steps.clear()
        eng, st, data = data_setup(small_cfg(algo=name))
        eng.run_round(st, data)
        assert calls == [(False, False)] * planes, name
        assert len(steps) == launches, name


# ---------------------------------------------------------------- the spec's wire format
def _wire_cases(m):
    """Specs the reference's wire-format rules refuse, each otherwise valid."""
    base = dict(name="x", fold=(m.FoldPass("delta", c_xd=1.0),))
    return [dict(base, uplink_compression="fp8"), dict(base, uplink_compression="topk"),
            dict(base, needs_residual=True),
            dict(base, uplink_compression="int8", needs_residual=True)]


@pytest.mark.parametrize("case", range(4))
def test_wire_format_validation_messages_equal_the_references(case):
    msgs = []
    for m in (ref_registry, registry):
        with pytest.raises(ValueError) as err:
            m.register_algorithm(m.AlgorithmSpec(**_wire_cases(m)[case]))
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert "x" not in list_algorithms()


@pytest.mark.parametrize("wire", [dict(uplink_compression="int8"),
                                  dict(uplink_compression="bf16"),
                                  dict(uplink_compression="topk", needs_residual=True)],
                         ids=["int8", "bf16", "topk"])
def test_wire_column_equals_the_references(wire):
    spec = get_algorithm("scaffold")._replace(name="_wire", **wire)
    ref = ref_registry.get_algorithm("scaffold")._replace(name="_wire", **wire)
    registry._validate(spec)
    ref_registry._validate(ref)
    assert describe_algorithm(spec) == ref_registry.describe_algorithm(ref)
    assert describe_algorithm(spec)["wire"] == wire["uplink_compression"] + (
        " + residual" if wire.get("needs_residual") else "")


@contextlib.contextmanager
def _int8_fedcm():
    """``_wire_int8``: FedCM declaring an int8 uplink, in both registries."""
    register_algorithm(get_algorithm("fedcm")._replace(name="_wire_int8",
                                                       uplink_compression="int8"))
    ref_registry.register_algorithm(ref_registry.get_algorithm("fedcm")._replace(
        name="_wire_int8", uplink_compression="int8"), override=True)
    try:
        yield
    finally:
        unregister_algorithm("_wire_int8")
        ref_registry.unregister_algorithm("_wire_int8")


def test_a_declared_int8_uplink_is_cfg_compression_int8_bitwise():
    """The spec's own wire format (cfg.compression None) runs as FedCM under
    ``cfg.compression`` int8 at its defaults: three rounds bitwise, the
    same uplink bytes; ``cfg.compression`` still overrides the spec's."""
    from repro_torch.configs.base import CompressionConfig
    with _int8_fedcm():
        declared = small_cfg(algo="_wire_int8")
        configured = small_cfg(algo="fedcm", compression=CompressionConfig(kind="int8"))
        runs = []
        for cfg in (declared, configured):
            eng, state, data = data_setup(cfg)
            assert eng.compression == CompressionConfig(kind="int8")
            state, m = eng.run_rounds(state, data, 3)
            runs.append((state, m, eng.payload_bytes()))
        assert_states_equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1].bytes_up, runs[1][1].bytes_up)
        assert runs[0][2] == runs[1][2]
        bf16 = replace(declared, compression=CompressionConfig(kind="bf16"))
        assert data_setup(bf16)[0].compression.kind == "bf16"


def test_a_declared_int8_uplink_matches_the_references_round_step():
    """Three rounds of ``_wire_int8`` with no ``cfg.compression`` on the
    reference's draws and int8 rounding draws: both engines take the spec's
    wire format; each round from the reference's state, within
    ``FLIP_MAX`` floor flips."""
    with _int8_fedcm():
        cfg = ref_cfg(algo="_wire_int8", use_fused_kernel=True)
        draws_cfg = replace(cfg, compression=RefCompressionConfig(kind="int8"))
        reng, _ = ref_engine(cfg)
        assert reng.compression == RefCompressionConfig(kind="int8")
        rst = _ref_state(reng, ring_start())
        peng = port_engine(port_cfg(cfg))
        assert peng.compression.kind == "int8"
        cx, cy = client_data()
        for t in range(3):
            before = ref_state_numpy(rst)
            pst, _ = state_from_numpy(np_params(), peng.cfg, momentum=before["momentum"],
                                      round=t)
            pst = pst._replace(params=torch.tensor(before["params"]))
            batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(400 + t), t)
            rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                      jnp.asarray(ids), jnp.asarray(mask))
            nst, pm = peng.round_step(pst, torch_batches(batches), torch.tensor(ids),
                                      torch.tensor(mask),
                                      draws=ref_round_draws(draws_cfg, t, ids, peng.spec.size))
            ref, got = ref_state_numpy(rst), state_to_numpy(nst)
            for key in ("params", "momentum"):
                count_flips(got[key], ref[key], before[key], f"round {t} {key}")
            assert float(pm.bytes_up) == float(rm.bytes_up)
