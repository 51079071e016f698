"""The port's checkpoint layer (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``.

* Layout, both ways: a snapshot either package writes of the same run has
  the same keys, shapes and dtypes for every plane (the generator's key
  excepted: ``state/.rng`` for the reference's threefry key,
  ``state/.rng_torch`` for the port's ``torch.Generator`` state), and each
  package reads the other's with the same values.
* A snapshot the reference wrote after two rounds continues in the port for
  three more, with the reference's draws injected, at ``ROUND_ATOL`` of the
  reference's own continuation — on both reference routes.
* Kill and resume inside the port is bitwise on every field, the generator
  included.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    N_CLIENTS,
    ROUND_ATOL,
    assert_close,
    assert_states_equal,
    client_data,
    data_setup,
    flat_rows,
    flat_tree,
    jax_tree,
    np_params,
    port_cfg,
    port_engine,
    ref_cfg,
    ref_draw_chain,
    ref_engine,
    small_cfg,
    torch_batches,
)
from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.checkpoint import load_fed_run as ref_load_fed_run
from repro.checkpoint import load_flat as ref_load_flat
from repro.checkpoint import save_fed_run as ref_save_fed_run
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro_torch.checkpoint import latest_step, load_fed_run, load_flat, save_checkpoint, save_fed_run
from repro_torch.configs.base import CompressionConfig, FaultConfig
from repro_torch.core.engine import RoundInputs
from repro_torch.launch.fed_train import restore_run

torch.set_num_threads(1)

# the planes a snapshot may carry, by run: client states, the second moment,
# resident top-k residual rows, bf16 momentum, the host store with its
# residual store
LAYOUT_CASES = {
    "fedcm": dict(algo="fedcm"),
    "scaffold": dict(algo="scaffold"),
    "fedadam": dict(algo="fedadam"),
    "topk": dict(algo="fedcm", compression=RefCompressionConfig(kind="topk", topk_frac=0.1)),
    "bf16-momentum": dict(algo="fedcm", momentum_dtype="bfloat16"),
    "host-store": dict(algo="scaffold", population_store="host",
                       compression=RefCompressionConfig(kind="topk", topk_frac=0.1)),
}
STORE_IDS = np.array([4, 1], np.int32)


def _store_rows(seed, p):
    return np.random.default_rng(seed).normal(size=(len(STORE_IDS), p)).astype(np.float32)


def _ref_snapshot(d, kw):
    """The reference's snapshot of a fresh run on ``kw`` (store rows
    written for two clients), and its state."""
    eng, _ = ref_engine(ref_cfg(**kw))
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(1))
    if eng.population is not None:
        p = eng.population.plane_size
        eng.population.scatter(STORE_IDS, _store_rows(7, p))
        eng.residual_population.scatter(STORE_IDS, _store_rows(8, p))
    ref_save_fed_run(d, 2, st, population=eng.population, residuals=eng.residual_population)
    return st


def _port_snapshot(d, kw):
    """The port's snapshot of a fresh run on ``kw``, as ``_ref_snapshot``."""
    eng = port_engine(port_cfg(ref_cfg(**kw)))
    st = eng.init(eng.spec.unravel(torch.tensor(flat_tree(np_params()))),
                  torch.Generator().manual_seed(1))
    if eng.population is not None:
        p = eng.spec.size
        eng.population.scatter(STORE_IDS, _store_rows(7, p))
        eng.residual_population.scatter(STORE_IDS, _store_rows(8, p))
    save_fed_run(d, 2, st, eng.spec, population=eng.population,
                 residuals=eng.residual_population)
    return eng, st


def _layout(flat):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in flat.items()}


def _np(v):
    return np.asarray(v.float() if isinstance(v, torch.Tensor) else jnp.asarray(v, jnp.float32))


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_reference_snapshot_is_read_by_the_port(case, tmp_path):
    d = str(tmp_path)
    st = _ref_snapshot(d, LAYOUT_CASES[case])
    ref_flat, ref_meta = ref_load_flat(d)
    flat, meta = load_flat(d)
    assert meta == ref_meta == {"step": 2}
    assert _layout(flat) == _layout(ref_flat)
    for k in flat:
        np.testing.assert_array_equal(_np(flat[k]), _np(ref_flat[k]), err_msg=k)
    # and into a port state, plane for plane, with the stores rebuilt
    eng = port_engine(port_cfg(ref_cfg(**LAYOUT_CASES[case])))
    like = eng.init(eng.spec.unravel(torch.zeros(eng.spec.size)), torch.Generator())
    got, pop, res, meta = load_fed_run(d, None, like, eng.spec, num_clients=N_CLIENTS)
    assert got.rng is None and meta["step"] == 2  # a threefry key: the caller seeds
    np.testing.assert_array_equal(got.params.numpy(), flat_tree(st.params))
    np.testing.assert_array_equal(_np(got.server.momentum), flat_tree(st.server.momentum))
    assert got.server.momentum.dtype == like.server.momentum.dtype
    assert int(got.server.round) == 0
    for mine, theirs in ((got.server.second_moment, st.server.second_moment),
                         (got.client_states, st.client_states), (got.residuals, st.residuals)):
        assert (mine is None) == (theirs is None)
    if got.client_states is not None:
        np.testing.assert_array_equal(got.client_states.numpy(), flat_rows(st.client_states))
    if pop is not None:
        np.testing.assert_array_equal(pop.to_pytree()["rows"],
                                      _store_rows(7, eng.spec.size)[np.argsort(STORE_IDS)])
        assert res.touched == 2


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_port_snapshot_is_read_by_the_reference(case, tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _ref_snapshot(ref_dir, LAYOUT_CASES[case])
    eng, st = _port_snapshot(port_dir, LAYOUT_CASES[case])
    want = _layout(ref_load_flat(ref_dir)[0])
    flat, meta = ref_load_flat(port_dir)
    got = _layout(flat)
    # the generator's key is each package's own
    assert want.pop("state/.rng") == ((2,), "uint32")
    assert got.pop("state/.rng_torch") == ((5056,), "uint8")
    assert got == want
    assert meta == {"step": 2, "rng_device": "cpu"}
    np.testing.assert_array_equal(np.asarray(flat["state/.rng_torch"]), st.rng.get_state().numpy())
    tree = eng.spec.unravel(st.params)
    for path, leaf in (("0/w", tree[0]["w"]), ("2/b", tree[2]["b"])):
        np.testing.assert_array_equal(np.asarray(flat[f"state/.params/{path}"]), leaf.numpy())
    if eng.population is not None:
        np.testing.assert_array_equal(np.asarray(flat["population/ids"]), np.sort(STORE_IDS))
    # the reference's template restore refuses it by the generator's key
    ref_eng, _ = ref_engine(ref_cfg(**LAYOUT_CASES[case]))
    like = ref_eng.init(jax_tree(np_params()), jax.random.PRNGKey(1))
    with pytest.raises(KeyError, match="state/.rng"):
        ref_load_checkpoint(port_dir, None, {"state": like})


class _Data(types.SimpleNamespace):
    """The reference's device-resident data: what its round loops read."""


@pytest.mark.parametrize("route", ["kernel", "jnp"])
@pytest.mark.parametrize("algo,store", [("fedcm", "resident"), ("scaffold", "resident"),
                                        ("fedadam", "resident"), ("scaffold", "host")])
def test_reference_snapshot_continues_in_the_port(route, algo, store, tmp_path):
    """Two reference rounds, a snapshot, three more rounds on each side of
    the restore — the port on the reference's draws."""
    d = str(tmp_path)
    cfg = ref_cfg(algo=algo, use_fused_kernel=(route == "kernel"), population_store=store)
    eng, _ = ref_engine(cfg)
    cx, cy = client_data()
    data = _Data(client_x=jnp.asarray(cx), client_y=jnp.asarray(cy), num_clients=N_CLIENTS)
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(11))
    st, _ = eng.run_rounds(st, data, 2)
    ref_save_fed_run(d, 2, st, population=eng.population)
    rst, rpop, _, _ = ref_load_fed_run(d, None, st, num_clients=N_CLIENTS)
    if rpop is not None:
        eng.population._rows = rpop._rows
    chain = ref_draw_chain(eng, cx, cy, rst.rng, 3, t0=2)
    ref_end, _ = eng.run_rounds(rst, data, 3)

    peng = port_engine(port_cfg(cfg))
    like = peng.init(peng.spec.unravel(torch.zeros(peng.spec.size)), torch.Generator())
    pst, pop, _, meta = load_fed_run(d, None, like, peng.spec, num_clients=N_CLIENTS)
    assert meta["step"] == 2 and int(pst.server.round) == 2
    inputs = [RoundInputs(torch_batches(c["batches"]), torch.tensor(c["ids"]),
                          torch.tensor(c["mask"]), torch.tensor(c["n_clipped"])) for c in chain]
    if store == "host":
        peng.population._rows = pop._rows
        it = iter(inputs)
        pst, _, _ = peng.run_rounds_async_on(pst, lambda _: next(it), 3, pipeline_depth=1,
                                             staleness=0)
    else:
        for inp in inputs:
            pst, _ = peng.round_step(pst, inp.batches, inp.ids, inp.mask, inp.n_clipped)
    assert int(pst.server.round) == int(ref_end.server.round) == 5
    assert_close(pst.params, flat_tree(ref_end.params), atol=ROUND_ATOL, what="params")
    assert_close(pst.server.momentum, flat_tree(ref_end.server.momentum), atol=ROUND_ATOL,
                 what="momentum")
    if algo == "fedadam":
        assert_close(pst.server.second_moment, flat_tree(ref_end.server.second_moment),
                     atol=ROUND_ATOL, what="second moment")
    if store == "host":
        want = eng.population.to_pytree()
        got = peng.population.to_pytree()
        np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
        assert_close(got["rows"], np.asarray(want["rows"]), atol=ROUND_ATOL, what="store rows")
    elif algo == "scaffold":
        assert_close(pst.client_states, flat_rows(ref_end.client_states), atol=ROUND_ATOL,
                     what="client states")


# ------------------------------------------------------------ in-port resume
def _kill_and_resume(cfg, tmp_path, n_before, n_after):
    """``n_before + n_after`` straight rounds against ``n_before``, a
    snapshot, a fresh engine restored from it, and ``n_after`` more.
    Returns ``((state, engine) straight, (state, engine) resumed)``."""
    eng_a, st_a, data = data_setup(cfg)
    st_a, _ = eng_a.run_rounds(st_a, data, n_before)
    st_a, _ = eng_a.run_rounds(st_a, data, n_after)

    eng_b, st_b, _ = data_setup(cfg)
    st_b, _ = eng_b.run_rounds(st_b, data, n_before)
    save_fed_run(str(tmp_path), n_before, st_b, eng_b.spec,
                 population=getattr(eng_b.population, "inner", eng_b.population),
                 residuals=eng_b.residual_population)
    assert latest_step(str(tmp_path)) == n_before
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))  # the rename commits

    eng_c, like, _ = data_setup(cfg)  # the resumed process
    st_c, r = restore_run(eng_c, like, str(tmp_path), seed=0)
    assert r == n_before
    st_c, _ = eng_c.run_rounds(st_c, data, n_after)
    return (st_a, eng_a), (st_c, eng_c)


def _assert_runs_equal(a, b):
    (st_a, eng_a), (st_b, eng_b) = a, b
    assert_states_equal(st_a, st_b)
    assert torch.equal(st_a.rng.get_state(), st_b.rng.get_state())
    for x, y in ((eng_a.population, eng_b.population),
                 (eng_a.residual_population, eng_b.residual_population)):
        assert (x is None) == (y is None)
        if x is not None:
            px, py = x.to_pytree(), y.to_pytree()
            np.testing.assert_array_equal(px["ids"], py["ids"])
            np.testing.assert_array_equal(px["rows"], py["rows"])


def test_kill_and_resume_is_bitwise_resident_with_drops(tmp_path):
    cfg = small_cfg(algo="fedcm", fault=FaultConfig(drop_rate=0.2, seed=1))
    _assert_runs_equal(*_kill_and_resume(cfg, tmp_path, 3, 3))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_kill_and_resume_is_bitwise_with_compression(kind, tmp_path):
    cfg = small_cfg(algo="fedcm", compression=CompressionConfig(kind=kind, topk_frac=0.1, seed=5))
    a, b = _kill_and_resume(cfg, tmp_path, 2, 2)
    _assert_runs_equal(a, b)
    assert (a[0].residuals is not None) == (kind == "topk")


@pytest.mark.parametrize("compression", [None, CompressionConfig(kind="topk", topk_frac=0.1)],
                         ids=["f32", "topk"])
def test_kill_and_resume_is_bitwise_on_the_host_store(compression, tmp_path):
    cfg = small_cfg(algo="scaffold", population_store="host", compression=compression,
                    fault=FaultConfig(drop_rate=0.1, seed=0))
    a, b = _kill_and_resume(cfg, tmp_path, 2, 2)
    _assert_runs_equal(a, b)
    assert a[1].population.touched > 0


# ---------------------------------------------------------------- refusals
def test_a_generator_resumes_only_on_its_device_type(tmp_path):
    eng, st, _ = data_setup(small_cfg())
    save_fed_run(str(tmp_path / "a"), 1, st, eng.spec)
    flat, meta = load_flat(str(tmp_path / "a"))
    assert meta["rng_device"] == "cpu"
    save_checkpoint(str(tmp_path / "b"), 1, flat, meta={"rng_device": "cuda"})
    assert load_flat(str(tmp_path / "b"))[0].keys() == flat.keys()
    with pytest.raises(ValueError, match="cuda generator; it cannot resume on cpu"):
        load_fed_run(str(tmp_path / "b"), 1, st, eng.spec)


def test_reference_master_planes_are_what_the_port_resumes_from(tmp_path):
    """A reference run with bf16 params keeps f32 master planes; the port's
    f32 params plane loads from them, and refuses bf16 leaves without them."""
    from repro.utils.trees import tree_cast

    cfg = ref_cfg(algo="scaffold", use_fused_kernel=True)  # its master keeps client states
    eng, _ = ref_engine(cfg)
    cx, cy = client_data()
    data = _Data(client_x=jnp.asarray(cx), client_y=jnp.asarray(cy), num_clients=N_CLIENTS)
    st = eng.init(tree_cast(jax_tree(np_params()), jnp.bfloat16), jax.random.PRNGKey(1))
    st, _ = eng.run_rounds(st, data, 1)
    assert st.master is not None
    ref_save_fed_run(str(tmp_path / "m"), 1, st)
    peng = port_engine(port_cfg(cfg))
    like = peng.init(peng.spec.unravel(torch.zeros(peng.spec.size)), torch.Generator())
    got, _, _, _ = load_fed_run(str(tmp_path / "m"), None, like, peng.spec)
    np.testing.assert_array_equal(got.params.numpy(), np.asarray(st.master.params))
    np.testing.assert_array_equal(got.client_states.numpy(), np.asarray(st.master.client_states))
    assert not np.array_equal(got.params.numpy(), flat_tree(st.params))  # not the bf16 leaves
    ref_save_fed_run(str(tmp_path / "n"), 1, st._replace(master=None))
    with pytest.raises(ValueError, match="master planes"):
        load_fed_run(str(tmp_path / "n"), None, like, peng.spec)


def test_resume_from_a_reference_snapshot_seeds_the_ports_generator(tmp_path, capsys):
    _ref_snapshot(str(tmp_path), LAYOUT_CASES["fedcm"])
    eng, like, _ = data_setup(small_cfg())
    st, r = restore_run(eng, like, str(tmp_path), seed=4)
    assert r == 2 and st.rng is not None
    assert torch.equal(st.rng.get_state(), torch.Generator().manual_seed(7).get_state())
    assert "threefry" in capsys.readouterr().out


def test_resume_refuses_a_snapshot_without_the_host_store(tmp_path):
    eng, st, _ = data_setup(small_cfg(algo="scaffold"))
    save_fed_run(str(tmp_path), 1, st, eng.spec)  # resident client states, no store
    eng_h, like, _ = data_setup(small_cfg(algo="scaffold", population_store="host"))
    with pytest.raises(ValueError, match="no population store"):
        restore_run(eng_h, like, str(tmp_path), seed=0)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_run(eng_h, like, str(tmp_path / "empty"), seed=0)
