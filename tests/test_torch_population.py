"""The population layer: host store, availability sampler, streaming data.

Against the reference (numpy and jnp on the same inputs):
``StreamingClientData`` bitwise (shards, round batches, full batches, test
split), ``availability_log_weights`` at ``RTOL``, the host store's packed
layout both ways and the ``FaultyStore`` failure stream.  The port's sampler
draws from a ``torch.Generator``, so it is held to the reference's
statistical checks instead (zipf favours low ids, diurnal moves with t,
dropout thins but never empties, overflow is counted).

In-port, bit for bit: the host store ≡ the resident ``(N, P)`` plane, sync
and async, for scaffold, feddyn and fedcm (cohorts of 3 out of 6 clients
overlap, so rows are re-read after a scatter), and under int8 and top-k (the
residual store ≡ the resident residual plane); a run whose store fails and
retries ≡ one that never failed.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_parity import DIMS, RTOL, assert_close, data_setup, small_cfg
from repro.configs.base import FedConfig as RefFedConfig
from repro.data import population as refpop
import repro_torch.core.engine as engine_mod
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.engine import (
    FederatedEngine, check_supported, cohort_capacity, metrics_to_host, sample_cohort_ex,
)
from repro_torch.core.flat import FlatSpec
from repro_torch.data import population as pop
from repro_torch.models.small import classification_loss, mlp_classifier

torch.set_num_threads(1)


# ------------------------------------------------------------------ streaming data
@pytest.mark.parametrize("seed", [0, 7])
def test_streaming_client_dataset_is_the_references(seed):
    ref = refpop.StreamingClientData(100_000, dim=8, n_classes=4, n_per_client=20, seed=seed)
    got = pop.StreamingClientData(100_000, dim=8, n_classes=4, n_per_client=20, seed=seed)
    np.testing.assert_array_equal(got.means, ref.means)
    np.testing.assert_array_equal(got.maps, ref.maps)
    for cid in (0, 3, 999, 99_999):
        (x, y), (rx, ry) = got.client_dataset(cid), ref.client_dataset(cid)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert x.dtype == np.float32 and y.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 7])
def test_streaming_batches_are_the_references(seed):
    ref = refpop.StreamingClientData(5_000, dim=8, n_classes=4, seed=seed)
    got = pop.StreamingClientData(5_000, dim=8, n_classes=4, seed=seed)
    ids = np.array([3, 4_999, 41, 7], np.int32)
    for batch_seed in (0, 12345):
        b, rb = (d.host_round_batches(ids, batch_seed, 3, 5) for d in (got, ref))
        for k in ("x", "y"):
            np.testing.assert_array_equal(b[k], rb[k])
        assert b["x"].shape == (4, 3, 5, 8)
    f, rf = got.host_full_batches(ids), ref.host_full_batches(ids)
    for k in ("x", "y"):
        np.testing.assert_array_equal(f[k], rf[k])


@pytest.mark.parametrize("n_test", [100, 2_000])
def test_streaming_test_set_is_the_references(n_test):
    for a, b in zip(pop.StreamingClientData(10, seed=3).test_set(n_test),
                    refpop.StreamingClientData(10, seed=3).test_set(n_test)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ availability
AVAIL = [
    ({"availability": "zipf"}, 0),
    ({"availability": "zipf", "zipf_exponent": 1.5}, 0),
    ({"availability": "diurnal"}, 0),
    ({"availability": "diurnal", "diurnal_period": 10.0, "diurnal_amplitude": 0.95}, 5),
    ({"availability": "diurnal", "diurnal_period": 7.0, "diurnal_amplitude": 1.0}, 17),
]


@pytest.mark.parametrize("kw, t", AVAIL)
def test_availability_log_weights_match_reference(kw, t):
    ref = refpop.availability_log_weights(RefFedConfig(num_clients=1000, **kw), t=t)
    cfg = FedConfig(num_clients=1000, **kw)
    for tt in (t, torch.tensor(t, dtype=torch.int32)):
        assert_close(pop.availability_log_weights(cfg, tt).numpy(), np.asarray(ref), rtol=RTOL,
                     atol=1e-6)
    if t == 0:  # None means round 0
        assert_close(pop.availability_log_weights(cfg).numpy(), np.asarray(ref), rtol=RTOL,
                     atol=1e-6)


def test_uniform_availability_has_no_weights_and_is_the_plain_draw():
    for participation in ("fixed", "bernoulli"):
        cfg = FedConfig(num_clients=50, cohort_size=10, participation=participation)
        assert pop.availability_log_weights(cfg) is None
        assert refpop.availability_log_weights(RefFedConfig(num_clients=50)) is None
        gen = torch.Generator().manual_seed(7)
        ids, mask, _ = sample_cohort_ex(gen, cfg, "cpu")
        gen.manual_seed(7)  # the plain draw, by hand: a permutation's head, then s
        cap = cohort_capacity(cfg)
        assert torch.equal(ids, torch.randperm(50, generator=gen)[:cap])
        if participation == "bernoulli":
            s = (torch.rand(50, generator=gen) < 0.2).sum().clamp(1, cap)
            assert torch.equal(mask, torch.arange(cap) < s)
        else:
            assert bool(mask.all())


def test_zipf_availability_biases_low_ids():
    cfg_u = FedConfig(num_clients=1000, cohort_size=50, participation="fixed")
    cfg_z = replace(cfg_u, availability="zipf", zipf_exponent=1.5)
    gen = torch.Generator().manual_seed(0)
    mean_u, mean_z = [], []
    for _ in range(20):
        mean_u.append(sample_cohort_ex(gen, cfg_u, "cpu")[0].float().mean().item())
        ids = sample_cohort_ex(gen, cfg_z, "cpu")[0]
        assert ids.unique().numel() == 50  # without replacement
        mean_z.append(ids.float().mean().item())
    assert np.mean(mean_z) < 0.5 * np.mean(mean_u)


def test_diurnal_availability_is_time_dependent():
    cfg = FedConfig(num_clients=200, cohort_size=20, participation="fixed",
                    availability="diurnal", diurnal_period=10.0, diurnal_amplitude=0.95)
    draws = {}
    for t in (0, 5):  # half a period later the phase has turned by π
        gen = torch.Generator().manual_seed(3)
        draws[t] = np.sort(sample_cohort_ex(gen, cfg, "cpu", t=torch.tensor(t))[0].numpy())
    assert not np.array_equal(draws[0], draws[5])
    assert not torch.allclose(pop.availability_log_weights(cfg, 0),
                              pop.availability_log_weights(cfg, 5))


def test_dropout_thins_but_never_empties():
    cfg = FedConfig(num_clients=100, cohort_size=16, participation="fixed", dropout_rate=0.5)
    gen, active = torch.Generator().manual_seed(0), []
    for _ in range(50):
        n = int(sample_cohort_ex(gen, cfg, "cpu")[1].sum())
        assert 1 <= n <= 16
        active.append(n)
    assert np.mean(active) < 12  # ~8 expected at rate 0.5
    empty = replace(cfg, dropout_rate=0.97, allow_empty_cohort=True)
    assert any(int(sample_cohort_ex(gen, empty, "cpu")[1].sum()) == 0 for _ in range(50))


def test_bernoulli_clip_is_counted():
    # N = 40, S = 30 at capacity sigma 0 → cap = 30, p = 0.75: the draw
    # exceeds its mean in ~42 % of rounds (the reference's check)
    cfg = FedConfig(num_clients=40, cohort_size=30, participation="bernoulli",
                    bernoulli_capacity_sigma=0.0)
    cap = cohort_capacity(cfg)
    assert cap == 30
    gen, clipped = torch.Generator().manual_seed(0), 0
    for _ in range(200):
        ids, mask, n_clipped = sample_cohort_ex(gen, cfg, "cpu")
        assert ids.shape == (cap,) and mask.shape == (cap,) and int(n_clipped) >= 0
        if int(n_clipped) > 0:
            clipped += 1
            assert int(mask.sum()) == cap  # clipped ⇒ mask saturated
    assert 0.25 < clipped / 200 < 0.65


def test_bernoulli_nonuniform_thins_by_inclusion_probability():
    cfg = FedConfig(num_clients=400, cohort_size=20, participation="bernoulli",
                    availability="zipf")
    cap = cohort_capacity(cfg)
    q = torch.clamp(20 * torch.softmax(pop.availability_log_weights(cfg), 0), 0, 1)
    gen, sizes = torch.Generator().manual_seed(0), []
    for _ in range(100):
        ids, mask, _ = sample_cohort_ex(gen, cfg, "cpu")
        s = int(mask.sum())
        assert torch.equal(mask, torch.arange(cap) < s) and 1 <= s <= cap
        assert ids.unique().numel() == cap
        sizes.append(s)
    assert abs(np.mean(sizes) - float(q.sum())) < 2.0  # E[s] = Σ q_i


def test_unknown_availability_and_store_raise():
    with pytest.raises(ValueError, match="lunar"):
        pop.availability_log_weights(FedConfig(availability="lunar"))
    with pytest.raises(ValueError, match="lunar"):
        check_supported(FedConfig(availability="lunar"))
    with pytest.raises(ValueError, match="disk"):
        pop.make_population_store(FedConfig(population_store="disk"), 4)


# ------------------------------------------------------------------ store mechanics
def test_host_store_gather_scatter_and_packing():
    store = pop.HostPopulationStore(1000, plane_size=4)
    assert store.gather(np.array([5, 900])).tolist() == [[0] * 4, [0] * 4]
    rows = np.arange(8, dtype=np.float32).reshape(2, 4)
    store.scatter(np.array([900, 5]), rows)
    np.testing.assert_array_equal(store.gather(np.array([5])), rows[1:])
    assert store.touched == 2 and store.nbytes == 2 * 4 * 4
    with pytest.raises(ValueError):
        store.scatter(np.array([1]), np.zeros((1, 3), np.float32))
    packed = store.to_pytree()
    assert packed["ids"].tolist() == [5, 900] and packed["ids"].dtype == np.int32
    again = pop.HostPopulationStore.from_pytree(packed, 1000)
    np.testing.assert_array_equal(again.gather(np.array([5, 900])),
                                  store.gather(np.array([5, 900])))


def test_host_store_layout_is_the_references():
    rng = np.random.default_rng(0)
    ours, ref = pop.HostPopulationStore(10_000, 6), refpop.HostPopulationStore(10_000, 6)
    for _ in range(4):
        ids = rng.choice(10_000, 5, replace=False)
        rows = rng.normal(size=(5, 6)).astype(np.float32)
        ours.scatter(ids, rows)
        ref.scatter(ids, rows)
    a, b = ours.to_pytree(), ref.to_pytree()
    for k in ("ids", "rows"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    # a reference store's pytree loads into the port's store
    loaded = pop.HostPopulationStore.from_pytree(b, 10_000)
    probe = np.concatenate([b["ids"], [1, 2, 3]])
    np.testing.assert_array_equal(loaded.gather(probe), ref.gather(probe))
    empty = pop.HostPopulationStore(10, 6).to_pytree()
    assert empty["rows"].shape == (0, 6) and empty["ids"].shape == (0,)


def test_faulty_store_failure_stream_is_the_references():
    def fails(store):
        out = []
        for _ in range(200):
            try:
                store.gather(np.array([1]))
                out.append(False)
            except (pop.TransientStoreError, refpop.TransientStoreError):
                out.append(True)
        return out

    a = fails(pop.FaultyStore(pop.HostPopulationStore(10, 2), 0.3, seed=5))
    b = fails(refpop.FaultyStore(refpop.HostPopulationStore(10, 2), 0.3, seed=5))
    assert a == b and 20 < sum(a) < 100


def test_store_io_backs_off_and_reraises(monkeypatch):
    cfg = small_cfg(algo="scaffold", population_store="host",
                    fault=FaultConfig(store_failure_rate=1.0, store_max_retries=3,
                                      store_backoff_base=0.02, store_backoff_cap=0.05))
    eng, _, _ = data_setup(cfg)
    slept = []
    monkeypatch.setattr(engine_mod.time, "sleep", slept.append)
    with pytest.raises(pop.TransientStoreError):
        eng._store_io(eng.population.gather, np.array([0]))
    assert slept == pytest.approx([0.02, 0.04, 0.05])  # capped, then re-raised


# ------------------------------------------------------------------ store ≡ resident
def _dense_rows(store, n, p):
    tree = store.to_pytree()
    dense = np.zeros((n, p), np.float32)
    dense[tree["ids"]] = tree["rows"]
    return dense


def _pair_runs(cfg, run, **kw):
    """(resident, host) runs of ``run`` ("run_rounds" / "run_rounds_async")
    from the same weights, generator seed and device-resident data."""
    out = {}
    for store in ("resident", "host"):
        eng, st, data = data_setup(replace(cfg, population_store=store))
        st, ms = getattr(eng, run)(st, data, 5, **kw)
        out[store] = (eng, st, metrics_to_host(ms))
    return out


@pytest.mark.parametrize("run, kw", [("run_rounds", {}),
                                     ("run_rounds_async", {"pipeline_depth": 2, "staleness": 1})],
                         ids=["sync", "async"])
@pytest.mark.parametrize("algo", ["scaffold", "feddyn", "fedcm"])
def test_store_is_resident_bitwise(algo, run, kw):
    cfg = small_cfg(algo=algo, staleness_discount=0.9)
    out = _pair_runs(cfg, run, **kw)
    (_, sr, mr), (eng_h, sh, mh) = out["resident"], out["host"]
    assert sh.client_states is None and sh.residuals is None  # no (N, P) plane
    assert torch.equal(sr.params, sh.params)
    assert torch.equal(sr.server.momentum, sh.server.momentum)
    for f in mr:
        np.testing.assert_array_equal(mr[f], mh[f], err_msg=f)
    if sr.client_states is not None:
        np.testing.assert_array_equal(
            _dense_rows(eng_h.population, cfg.num_clients, eng_h.spec.size),
            sr.client_states.numpy())
    else:
        assert eng_h.population is None


@pytest.mark.parametrize("algo, kind", [("scaffold", "int8"), ("scaffold", "topk"),
                                        ("fedcm", "topk")])
def test_store_is_resident_bitwise_compressed(algo, kind):
    """Under a compressed uplink, sync: the client-state store and the top-k
    residual store hold the resident planes' rows bit for bit."""
    cfg = small_cfg(algo=algo, participation="bernoulli",
                    compression=CompressionConfig(kind=kind, topk_frac=0.1))
    out = _pair_runs(cfg, "run_rounds")
    (_, sr, mr), (eng_h, sh, mh) = out["resident"], out["host"]
    assert sh.client_states is None and sh.residuals is None
    assert torch.equal(sr.params, sh.params)
    assert torch.equal(sr.server.momentum, sh.server.momentum)
    for f in mr:
        np.testing.assert_array_equal(mr[f], mh[f], err_msg=f)
    n, p = cfg.num_clients, eng_h.spec.size
    for store, plane in ((eng_h.population, sr.client_states),
                         (eng_h.residual_population, sr.residuals)):
        assert (store is None) == (plane is None)
        if store is not None:
            np.testing.assert_array_equal(_dense_rows(store, n, p), plane.numpy())
    if kind == "topk":  # the residual rows live in their own store
        assert eng_h.residual_population.touched > 0


@pytest.mark.parametrize("run, kw", [("run_rounds", {}),
                                     ("run_rounds_async", {"pipeline_depth": 2, "staleness": 1})],
                         ids=["sync", "async"])
def test_store_retries_never_change_the_math(run, kw):
    base = small_cfg(algo="scaffold", population_store="host",
                     compression=CompressionConfig(kind="topk", topk_frac=0.1))
    flaky = replace(base, fault=FaultConfig(store_failure_rate=0.3, store_backoff_base=0.0))
    runs = {}
    for name, cfg in (("clean", base), ("flaky", flaky)):
        eng, st, data = data_setup(cfg)
        st, ms = getattr(eng, run)(st, data, 5, **kw)
        runs[name] = (eng, st, metrics_to_host(ms))
    (ea, sa, ma), (eb, sb, mb) = runs["clean"], runs["flaky"]
    assert torch.equal(sa.params, sb.params)
    for f in ma:
        if f != "n_retries":
            np.testing.assert_array_equal(ma[f], mb[f], err_msg=f)
    assert ma["n_retries"].sum() == 0 and mb["n_retries"].sum() > 0
    np.testing.assert_array_equal(ea.population.to_pytree()["rows"],
                                  eb.population.to_pytree()["rows"])


def test_store_requires_init():
    eng, st, data = data_setup(small_cfg(algo="scaffold", population_store="host"))
    eng.population = None  # a hand-built state that skipped init()
    with pytest.raises(RuntimeError, match="population store"):
        eng.run_rounds(st, data, 1)
    eng, st, data = data_setup(small_cfg(population_store="host",
                                         compression=CompressionConfig(kind="topk")))
    assert eng.population is None and eng.residual_population is not None
    eng.residual_population = None
    with pytest.raises(RuntimeError, match="residual store"):
        eng.run_rounds_async(st, data, 1)


# ------------------------------------------------------------------ streaming end to end
def _streaming_engine(cfg):
    model = mlp_classifier(DIMS)
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=4, device="cpu")
    return eng, eng.init(params, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("algo, run", [("scaffold", "run_rounds"),
                                       ("mimelite", "run_rounds_async"),
                                       ("feddyn", "run_rounds_async")])
def test_streaming_store_end_to_end_bounded_memory(algo, run):
    cfg = FedConfig(algo=algo, num_clients=5_000, cohort_size=4, local_steps=2,
                    participation="bernoulli", population_store="host",
                    availability="zipf", dropout_rate=0.2, staleness_discount=0.9)
    task = pop.StreamingClientData(cfg.num_clients, dim=DIMS[0], n_classes=DIMS[-1], seed=0)
    eng, st = _streaming_engine(cfg)
    st, ms = getattr(eng, run)(st, task, 4, **({} if run == "run_rounds" else
                                               {"pipeline_depth": 2, "staleness": 1}))
    host = metrics_to_host(ms)
    assert st.client_states is None and np.all(np.isfinite(host["loss"]))
    assert int(st.server.round) == 4
    if eng.algo.needs_client_state:
        assert 0 < eng.population.touched <= 4 * cohort_capacity(cfg)
    else:
        assert eng.population is None
    assert torch.isfinite(st.params).all()
