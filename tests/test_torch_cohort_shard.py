"""Cohort sharding in the port: one process a shard, gloo on the CPU.

The contract is the reference's (tests/test_cohort_shard.py), kept within
the port: a cohort group changes WHERE the cohort computes — rank r owns
rows ``[r·C_loc, (r+1)·C_loc)`` of the padded cohort end to end, and the
fold is an ``all_to_all`` to column blocks, the fold on each block, then an
``all_gather`` — and nothing about WHAT is computed.  Four gloo ranks must
give the unsharded engine's planes and per-round metrics bit for bit, for
every registered algorithm, sync and on the ring, for ragged cohorts, under
faults and under each wire format; every rank must end with rank 0's
planes; and the sharded port meets the reference's unsharded round on the
reference's draws at ``RTOL`` / ``ATOL`` (tests/_torch_parity.py).  The
specs registered at runtime (tests/_torch_user_specs.py: the mixed
affine-direction + ``server_fn`` spec of the reference's test, the escape
hatches, a ``server_fn`` over client state) hold the same contract on 4 and
on 2 ranks: their means come from ``scatter_means``.  ``cohort_mean_scatter``
on 2 and 4 ranks is bitwise the unsharded ``masked_mean``.

Bitwise on the CPU needs one thread on both sides: every rank and this
process run ``torch.set_num_threads(1)``.  The ranks run the bodies of
tests/_torch_shard_ranks.py (no JAX: a spawned rank re-imports them); each
world is started once, by a module-scoped fixture, and runs many cases;
the tests then assert one case each.
"""
import time

import numpy as np
import pytest
import torch

import jax

from _torch_parity import (
    ATOL, RTOL, B as PARITY_B, DIMS as PARITY_DIMS, assert_close, client_data, jax_tree,
    np_params, port_cfg, ref_cfg, ref_draws, ref_engine, ref_state_numpy, ring_start,
)
from _torch_shard_ranks import (
    case, hang, killed_rank, run_case, run_injected, unsharded_mean, world,
)
from _torch_user_specs import registered
from repro_torch.configs.base import FedConfig
from repro_torch.core.engine import FederatedEngine
from repro_torch.core.flat import FlatSpec, pad_cohort, plane_chunk
from repro_torch.core.registry import list_algorithms
from repro_torch.launch.mesh import (
    RankFailure, check_cards, make_cohort_group, resolve_backend, spawn_cohort,
)
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.sharding.rules import padded_cohort

torch.set_num_threads(1)

N_RANKS = 4
ALGOS = tuple(sorted(list_algorithms()))
FAULTS = {"drop_rate": 0.2, "corrupt_rate": 0.3, "corrupt_mode": "nan",
          "quarantine_norm_mult": 2.0}
CASES = (
    [case(f"sync-{a}", a) for a in ALGOS]
    + [case(f"ring-{a}", a, rounds=4, ring=(2, 1)) for a in ALGOS]
    + [case("ragged-fedcm-fixed", "fedcm", cohort=10),
       case("ragged-fedcm-bernoulli", "fedcm", cohort=10, participation="bernoulli"),
       case("ragged-scaffold", "scaffold", cohort=10),
       case("ragged-scaffold-ring-d3", "scaffold", cohort=10, rounds=5, ring=(3, 0)),
       case("faults-fedcm", "fedcm", fault=FAULTS),
       case("int8-scaffold", "scaffold", compression="int8"),
       case("bf16-fedcm", "fedcm", compression="bf16"),
       case("topk-fedcm", "fedcm", compression="topk")]
)
# runtime-registered specs (registered in every rank and around the
# unsharded runs); also run on a 2-rank world
USER_CASES = [case("sync-_test_mixed", "_test_mixed"),
              case("ring-_test_mixed", "_test_mixed", rounds=4, ring=(2, 1)),
              case("ragged-_test_mixed", "_test_mixed", cohort=10, participation="bernoulli"),
              case("int8-_test_mixed", "_test_mixed", compression="int8"),
              case("sync-_test_escape", "_test_escape"),
              case("sync-_test_escape_state", "_test_escape_state")]
USER_NAMES = [c["name"] for c in USER_CASES]
CASES = CASES + USER_CASES
MEAN_AGGS = ("float32", "bfloat16")
CASE_NAMES = [c["name"] for c in CASES]
ONE_RANK = [case(f"one-rank-{a}", a, cohort_shard=1) for a in ("fedcm", "scaffold", "fedadam")]
COLUMN_DTYPES = ("float32", "int8", "bfloat16")
INJECTED = ("fedcm", "scaffold")
PLANES = ("params", "momentum", "second_moment", "client_states", "residuals")
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 30.0, 120.0


def _assert_same(got, want, what):
    """Two results (``run_case`` / ``run_injected``) equal bit for bit:
    every state plane and every per-round metric."""
    for key in PLANES:
        a, b = got["state"][key], want["state"][key]
        assert (a is None) == (b is None), f"{what}: {key}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {key}")
    assert got["state"]["round"] == want["state"]["round"]
    assert set(got["metrics"]) == set(want["metrics"])
    for key, v in want["metrics"].items():
        np.testing.assert_array_equal(got["metrics"][key], v, err_msg=f"{what}: {key}")


# ---------------------------------------------------------------- the worlds


def _injected_jobs():
    """The reference's unsharded round (its Pallas route, interpret mode) on
    its own draws from ``ring_start``, and the port's job on the same
    draws and state: ``{algo: (reference planes, job)}``.  Cohort 3 over 4
    ranks pads to 4 rows: rank 3 owns a pad row only."""
    out = {}
    for algo in INJECTED:
        cfg = ref_cfg(algo=algo, use_fused_kernel=True)
        reng, _ = ref_engine(cfg)
        start = ring_start()
        cx, cy = client_data()
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(7))
        st = reng.init(jax_tree(np_params()), jax.random.PRNGKey(0))
        st = st._replace(server=st.server._replace(momentum=jax_tree(start["momentum"])))
        if st.client_states is not None:
            st = st._replace(client_states=jax_tree(start["client_states"]))
        rst, _ = reng.round_step(st, jax.tree_util.tree_map(jax.numpy.asarray, batches),
                                 jax.numpy.asarray(ids), jax.numpy.asarray(mask))
        job = {"cfg": port_cfg(cfg), "params": np_params(), "momentum": start["momentum"],
               "client_states": start["client_states"] if st.client_states is not None else None,
               "dims": PARITY_DIMS, "batch": PARITY_B,
               "draws": [{"batches": batches, "ids": ids, "mask": mask}]}
        out[algo] = (ref_state_numpy(rst), job)
    return out


@pytest.fixture(scope="module")
def injected():
    return _injected_jobs()


@pytest.fixture(scope="module")
def four_ranks(injected):
    """One 4-rank gloo world: every case of ``CASES``, the column layout for
    three dtypes and the injected reference rounds.  Returns each rank's
    results by job."""
    jobs = ([("case", c) for c in CASES] + [("columns", d) for d in COLUMN_DTYPES]
            + [("injected", injected[a][1]) for a in INJECTED]
            + [("mean_scatter", a) for a in MEAN_AGGS])
    ranks = spawn_cohort(world, N_RANKS, args=(jobs,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                         deadline_s=WORLD_DEADLINE_S)
    names = (CASE_NAMES + [f"columns-{d}" for d in COLUMN_DTYPES]
             + [f"injected-{a}" for a in INJECTED] + [f"mean-{a}" for a in MEAN_AGGS])
    return [dict(zip(names, r)) for r in ranks]


@pytest.fixture(scope="module")
def two_ranks():
    """A 2-rank gloo world: the runtime-registered specs' cases and the
    scattered mean."""
    jobs = [("case", c) for c in USER_CASES] + [("mean_scatter", a) for a in MEAN_AGGS]
    ranks = spawn_cohort(world, 2, args=(jobs,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                         deadline_s=WORLD_DEADLINE_S)
    names = USER_NAMES + [f"mean-{a}" for a in MEAN_AGGS]
    return [dict(zip(names, r)) for r in ranks]


@pytest.fixture(scope="module")
def one_rank():
    """A 1-rank world: the ``ONE_RANK`` cases (the group comes from
    ``cfg.cohort_shard = 1``), then a config asking for 2 shards."""
    jobs = [("case", c) for c in ONE_RANK] + [("refusal", case("two-shards", "fedcm",
                                                                cohort_shard=2))]
    (results,) = spawn_cohort(world, 1, args=(jobs,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                              deadline_s=WORLD_DEADLINE_S)
    return dict(zip([c["name"] for c in ONE_RANK] + ["two-shards"], results))


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded engine on every case, in this process."""
    with registered():
        return {c["name"]: run_case(dict(c, cohort_shard=0)) for c in CASES + ONE_RANK}


# ---------------------------------------------------------------- sharded ≡ unsharded


@pytest.mark.parametrize("name", CASE_NAMES)
def test_four_ranks_match_the_unsharded_engine_bitwise(name, four_ranks, unsharded):
    got = four_ranks[0][name]
    assert got["shards"] == N_RANKS and unsharded[name]["shards"] == 0
    _assert_same(got, unsharded[name], name)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_every_rank_ends_with_rank_zeros_planes(name, four_ranks):
    for r in range(1, N_RANKS):
        _assert_same(four_ranks[r][name], four_ranks[0][name], f"{name} rank {r}")


def test_the_cases_exercise_padding_faults_and_the_ring(unsharded):
    """The cases are what their names say: ragged cohorts pad, the fault
    case drops and quarantines, bernoulli leaves rows inactive, the ring
    fills before it folds."""
    assert padded_cohort(10, N_RANKS) == 12
    m = unsharded["faults-fedcm"]["metrics"]
    assert m["n_dropped"].sum() > 0 and m["n_quarantined"].sum() > 0
    assert (unsharded["ragged-fedcm-bernoulli"]["metrics"]["n_active"] < 18).any()
    np.testing.assert_array_equal(unsharded["ring-fedcm"]["metrics"]["folded"], [0, 1, 1, 1])
    np.testing.assert_array_equal(
        unsharded["ragged-scaffold-ring-d3"]["metrics"]["folded"], [0, 0, 1, 1, 1])


@pytest.mark.parametrize("name", USER_NAMES)
def test_two_ranks_match_the_unsharded_engine_bitwise(name, two_ranks, unsharded):
    """The runtime-registered specs on 2 ranks: rank 0 the unsharded
    engine's planes and metrics bit for bit, rank 1 rank 0's."""
    assert two_ranks[0][name]["shards"] == 2
    _assert_same(two_ranks[0][name], unsharded[name], name)
    _assert_same(two_ranks[1][name], two_ranks[0][name], f"{name} rank 1")


@pytest.mark.parametrize("agg", MEAN_AGGS)
def test_cohort_mean_scatter_is_the_unsharded_masked_mean_bitwise(agg, two_ranks, four_ranks):
    """``cohort_mean_scatter`` of each rank's rows (a ragged cohort of 10
    with inactive rows, padded to 10 / 12) on 2 and 4 ranks: every rank
    holds the whole-plane ``masked_mean``, bit for bit."""
    want = unsharded_mean(agg)
    for world_ranks in (two_ranks, four_ranks):
        for r in world_ranks:
            np.testing.assert_array_equal(r[f"mean-{agg}"], want)


@pytest.mark.parametrize("name", [c["name"] for c in ONE_RANK])
def test_one_rank_world_matches_the_unsharded_engine_bitwise(name, one_rank, unsharded):
    assert one_rank[name]["shards"] == 1
    _assert_same(one_rank[name], unsharded[name], name)


@pytest.mark.parametrize("dtype", COLUMN_DTYPES)
def test_cohort_to_columns_gives_each_rank_its_column_block(dtype, four_ranks):
    assert all(four_ranks[r][f"columns-{dtype}"] for r in range(N_RANKS))


# ---------------------------------------------------------------- vs the reference


@pytest.mark.parametrize("algo", INJECTED)
def test_sharded_port_meets_the_reference_round(algo, four_ranks, injected):
    ref, job = injected[algo]
    got = four_ranks[0][f"injected-{algo}"]
    for key in ("params", "momentum", "client_states"):
        assert (got["state"][key] is None) == (ref[key] is None), key
        if ref[key] is not None:
            assert_close(got["state"][key], ref[key], rtol=RTOL, atol=ATOL, what=key)
    _assert_same(got, run_injected(job), f"injected {algo} vs the unsharded port")
    for r in range(1, N_RANKS):
        _assert_same(four_ranks[r][f"injected-{algo}"], got, f"injected {algo} rank {r}")


# ---------------------------------------------------------------- layout and refusals


def test_padded_cohort_and_pad_cohort():
    assert [padded_cohort(c, n) for c, n in ((16, 4), (10, 4), (25, 2), (25, 4), (10, 1))] == \
        [16, 12, 26, 28, 10]
    a = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(pad_cohort(a, 5), [[0, 1], [2, 3], [4, 5], [4, 5], [4, 5]])
    np.testing.assert_array_equal(pad_cohort(a, 5, "zero")[3:], np.zeros((2, 2)))
    assert pad_cohort(None, 5) is None
    assert pad_cohort({"y": torch.arange(3)}, 4)["y"].tolist() == [0, 1, 2, 2]


def test_plane_chunk_is_a_view_at_each_ranks_offset():
    x = torch.arange(22026, dtype=torch.float32)
    chunks = [plane_chunk(x, r, 4) for r in range(4)]
    assert [c.shape[0] for c in chunks] == [5507] * 4
    assert all(c.is_contiguous() for c in chunks)
    np.testing.assert_array_equal(torch.cat(chunks)[:22026], x)
    np.testing.assert_array_equal(chunks[3][-2:], [0.0, 0.0])  # the pad columns


def test_refuses_the_host_store_with_sharding():
    model = mlp_classifier((8, 16, 4))
    spec = FlatSpec.from_tree(model.init(torch.Generator().manual_seed(0)))
    cfg = FedConfig(algo="scaffold", num_clients=32, cohort_size=4, population_store="host",
                    cohort_shard=2)
    with pytest.raises(ValueError, match="population_store='host'.*cohort sharding"):
        FederatedEngine(cfg, classification_loss(model.apply), spec, device="cpu")


def test_refuses_cohort_shard_without_a_group():
    model = mlp_classifier((8, 16, 4))
    spec = FlatSpec.from_tree(model.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="none is initialized.*spawn_cohort"):
        FederatedEngine(FedConfig(cohort_shard=2), classification_loss(model.apply), spec,
                        device="cpu")
    with pytest.raises(ValueError, match="none is initialized"):
        make_cohort_group(4)


def test_refuses_a_group_of_another_size(one_rank):
    assert "cohort_shard=2 but the process group has 1 ranks" in one_rank["two-shards"]


def test_refuses_more_cards_than_are_visible():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"wants {n + 1} CUDA cards? .* only {n} are visible"):
        check_cards(n + 1, "cuda", "nccl")
    with pytest.raises(ValueError, match="visible"):
        spawn_cohort(world, n + 1, args=([],), device="cuda")
    assert resolve_backend("cpu", None) == "gloo" and resolve_backend("cuda", None) == "nccl"
    with pytest.raises(ValueError, match="nccl"):
        resolve_backend("cpu", "nccl")


# ---------------------------------------------------------------- failing worlds


def test_a_killed_rank_fails_the_world_at_once():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match=r"rank\(s\) \[1\] exited without a result") as e:
        spawn_cohort(killed_rank, 2, device="cpu", timeout_s=WORLD_TIMEOUT_S,
                     deadline_s=WORLD_DEADLINE_S)
    assert e.value.exitcodes[1] == 9
    assert time.monotonic() - t0 < 60.0


def test_a_world_past_its_deadline_is_killed():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="deadline"):
        spawn_cohort(hang, 1, args=(120.0,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                     deadline_s=3.0)
    assert time.monotonic() - t0 < 60.0
