"""The port's async ring (``FederatedEngine.run_rounds_async``): its own
contracts, and the ring under faults and compression against the reference.

In-port, bit for bit: D = 1, S = 0 is the sync loop ``run_rounds`` for all
eleven specs and under every wire encoding.  The fill folds nothing, every later iteration folds one entry, the
drain folds the rest, and a run shorter than the fill drains all of it.

Against the reference on its draws (``ring_parity`` feeds them through
``run_rounds_async_on``, the loop ``run_rounds_async`` runs): faults
(drops, NaN corruption, quarantine) and int8 / top-k uplinks ride the ring
from launch to fold.  The states compared are those after the loop's D + 1
launches, whose two folded cohorts both launched from the start state, so a
stochastic-rounding flip cannot compound (``FLIP_MAX`` rule,
tests/_torch_parity.py).  The clean-uplink parity of every (D, S, γ) is in
tests/test_torch_async_ref_kernel.py and tests/test_torch_async_ref_jnp.py.

A staleness convergence smoke on the reference's quadratic toy holds the
distance criterion the reference meets; its loss criterion fails in the
reference itself (ROADMAP queue C) and is not used.
"""
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_states_equal, count_flips, data_setup, ring_parity, small_cfg,
)
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro.configs.base import CompressionConfig as RefCompressionConfig
from repro.configs.base import FaultConfig as RefFaultConfig
from repro_torch.core.engine import FederatedEngine, RoundMetrics, make_eval_fn, metrics_to_host
from repro_torch.core.flat import CohortUplink, FlatSpec, ring_push
from repro_torch.models.small import mlp_classifier

torch.set_num_threads(1)

ALL_ALGOS = ("fedacg", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedcm", "feddyn",
             "fedprox", "fedyogi", "mimelite", "scaffold")
SHARED = RoundMetrics._fields  # every sync metric has an async twin


def _pair(cfg, n_rounds, **async_kw):
    """(sync run, async run) of the port on ``cfg`` from the same weights,
    generator seed and data."""
    eng, st, data = data_setup(cfg)
    s_sync, m_sync = eng.run_rounds(st, data, n_rounds)
    eng, st, data = data_setup(cfg)
    s_async, m_async = eng.run_rounds_async(st, data, n_rounds, **async_kw)
    return s_sync, metrics_to_host(m_sync), s_async, metrics_to_host(m_async)


# ------------------------------------------------------------------ D = 1 ≡ sync
@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_depth1_is_the_sync_loop_bitwise(algo):
    cfg = small_cfg(algo=algo, participation="bernoulli", staleness_discount=0.9)
    s_sync, m_sync, s_async, m_async = _pair(cfg, 3, pipeline_depth=1, staleness=0)
    assert_states_equal(s_sync, s_async)
    for f in SHARED:
        np.testing.assert_array_equal(m_sync[f], m_async[f], err_msg=f)
    np.testing.assert_array_equal(m_async["folded"], [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(m_async["eval_acc"], [-1.0, -1.0, -1.0])


@pytest.mark.parametrize("algo, kind", [("scaffold", "int8"), ("mimelite", "int8"),
                                        ("scaffold", "bf16"), ("fedcm", "topk"),
                                        ("scaffold", "topk")])
def test_depth1_is_the_sync_loop_bitwise_compressed(algo, kind):
    """Under faults and every wire encoding the entry carries the wire
    representation (an int8 or bf16 ``QPlane``, a sparse top-k delta) from
    launch to fold on both schedules; D = 1, S = 0 folds it the round it
    launched, as the sync round does."""
    cfg = small_cfg(algo=algo, compression=CompressionConfig(kind=kind, topk_frac=0.1),
                    fault=FaultConfig(drop_rate=0.2, corrupt_rate=0.2))
    s_sync, m_sync, s_async, m_async = _pair(cfg, 3, pipeline_depth=1, staleness=0)
    assert_states_equal(s_sync, s_async)
    for f in SHARED:
        np.testing.assert_array_equal(m_sync[f], m_async[f], err_msg=f)


# ------------------------------------------------------------------ fill, fold, drain
def test_fill_fold_drain():
    cfg = small_cfg(algo="scaffold", staleness_discount=0.9)
    eng, st, data = data_setup(cfg)
    st, ms = eng.run_rounds_async(st, data, 6, pipeline_depth=3, staleness=1)
    host = metrics_to_host(ms)
    np.testing.assert_array_equal(host["folded"], [0, 0, 1, 1, 1, 1])
    assert np.all(host["delta_norm"][:2] == 0.0) and np.all(host["delta_norm"][2:] > 0.0)
    assert int(st.server.round) == 6
    eng2, st2, data2 = data_setup(cfg)
    gen = st2.rng
    st2, _, pending = eng2.run_rounds_async_on(
        st2, lambda s: eng2._draw_round(gen, s.server.round, data2), 6,
        pipeline_depth=3, staleness=1, drain=False)
    assert len(pending) == 2 and all(isinstance(e, CohortUplink) for e in pending)
    assert not torch.equal(st.params, st2.params)  # drain=False leaves work in flight
    drained = eng2.drain_async(st2, pending, 3)
    assert_states_equal(st, drained)  # draining later is the drained run
    for s in (st, st2):
        assert torch.isfinite(s.params).all()


def test_run_shorter_than_the_fill_drains_every_launch():
    cfg = small_cfg()
    eng, st0, data = data_setup(cfg)
    start = st0.params.clone()
    st, ms = eng.run_rounds_async(st0, data, 2, pipeline_depth=4, staleness=0)
    np.testing.assert_array_equal(metrics_to_host(ms)["folded"], [0, 0])
    assert not torch.equal(st.params, start)  # both launches drained


def test_ring_push_rotates_oldest_first():
    a, b, c = (CohortUplink(i, None, None, None, None, None) for i in range(3))
    assert ring_push((), a) == (a, ())  # D = 1: the entry folds the round it launches
    oldest, pending = ring_push((a, b), c)
    assert oldest is a and pending == (b, c)


def test_async_validates_arguments():
    eng, st, data = data_setup(small_cfg())
    for kw in ({"pipeline_depth": 0}, {"staleness": -1}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            eng.run_rounds_async(st, data, 2, **kw)
    with pytest.raises(ValueError, match="n_rounds"):
        eng.run_rounds_async(st, data, 0)
    with pytest.raises(ValueError, match="predict_fn"):
        eng.run_rounds_async(st, data, 2, eval_every=1)
    host, hst, _ = data_setup(small_cfg(population_store="host"))
    with pytest.raises(ValueError, match="in-loop eval"):
        host.run_rounds_async(hst, data, 2, eval_every=1, predict_fn=lambda p, x: x,
                              eval_data=(None, None))


def test_eval_cadence():
    cfg = small_cfg(algo="fedcm")
    eng, st, data = data_setup(cfg)
    model = mlp_classifier((8, 16, 16, 4))
    x = data.client_x.reshape(-1, 8)
    y = data.client_y.reshape(-1).long()
    st, ms = eng.run_rounds_async(st, data, 4, pipeline_depth=2, staleness=1, eval_every=2,
                                  eval_data=(x, y), predict_fn=model.apply, drain=False)
    acc = metrics_to_host(ms)["eval_acc"]
    np.testing.assert_array_equal(acc[[0, 2]], [-1.0, -1.0])
    assert 0.0 <= acc[1] <= 1.0
    # the last on-cadence eval reads the post-fold params the loop returns
    assert acc[3] == np.float32(make_eval_fn(model.apply)(eng.spec.unravel(st.params), x, y))


# ------------------------------------------------------------------ staleness smoke
def _quadratic(staleness_discount=0.9):
    """The reference's heterogeneous quadratic toy
    (tests/test_run_rounds.py::_quadratic_setup): client i's points sit
    around its own center; loss ½·mean‖w − x‖², optimum the mean of all
    points."""
    rng = np.random.default_rng(0)
    N, n_per, d = 12, 32, 6
    centers = 3.0 + rng.normal(size=(N, 1, d)) * 2.0
    pts = centers + 0.1 * rng.normal(size=(N, n_per, d))
    data = SimpleNamespace(client_x=torch.tensor(pts, dtype=torch.float32),
                           client_y=torch.zeros((N, n_per), dtype=torch.int32))

    def quad_loss(params, batch):
        diff = params["w"][:, None, :] - batch["x"]
        return 0.5 * torch.mean(torch.sum(diff * diff, dim=-1), dim=-1)

    cfg = FedConfig(algo="fedcm", num_clients=N, cohort_size=4, local_steps=4,
                    participation="fixed", eta_l=0.2, eta_l_decay=1.0, weight_decay=0.0,
                    staleness_discount=staleness_discount)
    params = {"w": torch.zeros(d)}
    eng = FederatedEngine(cfg, quad_loss, FlatSpec.from_tree(params), batch_size=8,
                          device="cpu")
    state = eng.init(params, torch.Generator().manual_seed(3))
    return eng, data, state, pts.reshape(-1, d).mean(axis=0)


@pytest.mark.parametrize("depth, stale", [(2, 1), (4, 2)])
def test_staleness_converges_on_quadratic(depth, stale):
    eng, data, state, w_star = _quadratic()
    state, ms = eng.run_rounds_async(state, data, 80, pipeline_depth=depth, staleness=stale)
    w = state.params.numpy()
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(metrics_to_host(ms)["loss"]))
    assert np.linalg.norm(w - w_star) < 0.15 * np.linalg.norm(w_star)


# ------------------------------------------------------------------ lossy ring vs reference
LOSSY = {
    "scaffold-int8": ("scaffold", {"compression": RefCompressionConfig(kind="int8", seed=3)}),
    "mimelite-int8": ("mimelite", {"compression": RefCompressionConfig(kind="int8", seed=3)}),
    "fedcm-topk": ("fedcm", {"compression": RefCompressionConfig(kind="topk", topk_frac=0.1)}),
    "fedcm-faults": ("fedcm", {"fault": RefFaultConfig(drop_rate=0.3, corrupt_rate=0.4,
                                                       corrupt_mode="nan", seed=1)}),
    "scaffold-int8-faults": ("scaffold", {
        "compression": RefCompressionConfig(kind="int8", seed=3),
        "fault": RefFaultConfig(drop_rate=0.3, corrupt_rate=0.4, corrupt_mode="nan", seed=2)}),
    "fedcm-topk-faults": ("fedcm", {
        "compression": RefCompressionConfig(kind="topk", topk_frac=0.1),
        "fault": RefFaultConfig(drop_rate=0.3, corrupt_rate=0.4, corrupt_mode="inf", seed=4)}),
}


@lru_cache(maxsize=None)
def _lossy(case):
    algo, kw = LOSSY[case]
    return ring_parity(algo, 2, 1, 0.9, "kernel", **kw)


@pytest.mark.parametrize("case", sorted(LOSSY))
def test_lossy_ring_matches_reference(case):
    r = _lossy(case)
    ref, port, start = r["ref"], r["port"], r["start"]
    for f in ("n_active", "n_dropped", "n_quarantined", "folded", "quorum_skipped"):
        np.testing.assert_array_equal(port["metrics"][f], ref["metrics"][f], err_msg=f)
    for key in ("params", "momentum", "client_states", "residuals"):
        got, want = port["scan"][key], ref["scan"][key]
        assert (got is None) == (want is None), key
        if got is not None:
            count_flips(got, want, start.get(key, np.zeros_like(want)), f"{case} {key}")
    assert np.all(np.isfinite(port["drained"]["params"]))


def test_lossy_ring_exercises_its_faults():
    """The fault cases drop and quarantine someone on the ring."""
    for case in ("fedcm-faults", "scaffold-int8-faults", "fedcm-topk-faults"):
        m = _lossy(case)["port"]["metrics"]
        assert m["n_dropped"].sum() > 0 and m["n_quarantined"].sum() > 0, case


def test_lossy_ring_keeps_the_uplink_compressed_in_flight():
    """Under int8 the ring's entries hold the QPlane of every wire plane
    (SCAFFOLD's state delta included); under top-k the sparse delta."""
    from repro_torch.core.compress import QPlane, TopKPlane
    for kind, algo, planes, rep in (("int8", "scaffold", ("delta", "state_delta"), QPlane),
                                    ("topk", "fedcm", ("delta",), TopKPlane)):
        cfg = small_cfg(algo=algo, compression=CompressionConfig(kind=kind, topk_frac=0.1))
        eng, st, data = data_setup(cfg)
        _, _, pending = eng.run_rounds_async_on(
            st, lambda s: eng._draw_round(st.rng, s.server.round, data), 2,
            pipeline_depth=3, staleness=0, drain=False)
        for e in pending:
            for name in planes:
                assert isinstance(getattr(e, name), rep), (kind, name)

