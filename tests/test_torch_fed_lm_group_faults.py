"""The fault layer and the escape hatches on a model group and on a grid,
against the port's unsharded round and the reference's ``round_step``.

The rounds are tests/test_torch_fed_lm_group.py's (reduced llama, the same
numpy-seeded weights, ids and minibatches), now with ``cfg.fault`` or a
user spec of ``_torch_user_specs``:

* faults: drop + deadline; corrupt ``nan`` + quarantine; corrupt ``noise``
  + quarantine with ``quarantine_norm_mult``; each × fedcm and scaffold.
  The reference's threefry draws (``_torch_parity.ref_round_draws``: the
  whole ``(C, P)`` noise rows) are injected into the port, unsharded and
  on every rank (each rank takes its own columns of the rows,
  ``GroupPlane.columns``), while the reference computes them itself;
* the escape hatches: ``_test_escape`` (a ``direction_fn`` normalizing by
  a client's whole-plane norm and a ``server_fn``) and ``_test_mixed`` (an
  affine row with the ``server_fn``), which see whole planes gathered over
  the group.

Each case runs on one world of 2 and one of 4 gloo ranks (a model group)
and one 2 × 2 grid (the cohort over data beside the group).  Checked: the
joined params at ``RTOL`` / ``ROUND_ATOL``, the momentum within
``GRAD_REL_L2`` relative L2, each round's loss and norms at ``LM_RTOL`` /
``LM_ATOL``, ``n_active``, ``n_dropped`` and ``n_quarantined`` exactly and
the round metrics equal on every rank.  Every quarantine decision by norm
reports its margin (the least relative distance of an active row's whole
norm from the threshold) in the failure message: a group norm summed in
another order moves a row by ~1e-7 relative.  Then two rounds on the
engine's own hash draws, whose noise each rank draws for its own columns
(``draws.normal_at``), against the unsharded run, and the column map
itself: every leaf's columns against ``join_shares`` and the whole-row
draw, for llama, ``llama-kv2`` and mamba2 on 2 and 4 ranks.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_grid_ranks as grid_ranks
import _torch_train_ranks as ranks_mod
from _torch_parity import (
    GRAD_REL_L2, LM_ATOL, LM_RTOL, ROUND_ATOL, RTOL, assert_close, port_cfg, ref_round_draws,
)
from test_torch_fed_lm_group import (
    B, WORLD_DEADLINE_S, WORLD_TIMEOUT_S, _ref_cfg, _setup, rel_l2,
)
from test_torch_model_parallel import port_model_cfg
from test_torch_registry_api import _ref_registered
from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core.engine import FederatedEngine as RefEngine
from repro.models import build_model as ref_build_model
from repro_torch.core.flat import FlatSpec
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.models.layers import ParallelContext
from repro_torch.sharding.rules import param_specs
from repro_torch.sharding.shard import group_plane, join_shares, param_shapes, shard_params
from repro_torch.utils import draws
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

WORLDS = (2, 4)
GRID = (2, 2)  # (data, model)
VARIANT = "llama3.2-1b"
FAULTS = {
    "drop-deadline": dict(drop_rate=0.3, deadline=1.2, seed=5),
    "nan-quarantine": dict(corrupt_rate=0.4, corrupt_mode="nan", seed=6),
    "noise-quarantine": dict(corrupt_rate=0.3, corrupt_mode="noise", noise_scale=10.0,
                             quarantine_norm_mult=3.0, seed=7),
}
DRAWN_ROUNDS = 2
# (case id, algorithm or user spec, fault or None)
CASES = ([(f"{a}-{f}", a, f) for f in FAULTS for a in ("fedcm", "scaffold")]
         + [(s, s, None) for s in ("_test_escape", "_test_mixed")])
COUNTERS = ("n_active", "n_dropped", "n_quarantined", "quorum_skipped", "bytes_up",
            "bytes_down")


def ref_fed(algo, fault):
    cfg = _ref_cfg(algo)
    return cfg if fault is None else replace(cfg, fault=RefFaultConfig(**FAULTS[fault]))


@lru_cache(maxsize=None)
def job(case):
    """The rank body's job of ``case``: the group test's rounds with the
    reference's fault draws of each round injected."""
    _, algo, fault = case
    base = _setup(VARIANT, algo)[1]
    rcfg = ref_fed(algo, fault)
    size = sum(x.size for x in tree_leaves(base["params"]))
    rounds = []
    for t, d in enumerate(base["rounds"]):
        d = dict(d)
        if fault is not None:
            got = ref_round_draws(rcfg, t, d["ids"], size)
            d["draws"] = {k: v.numpy() for k, v in got._asdict().items() if v is not None}
        rounds.append(d)
    spec = () if algo in ("fedcm", "scaffold") else (algo,)
    drawn = DRAWN_ROUNDS if case[0] == "fedcm-noise-quarantine" else 0
    return dict(base, fed=port_cfg(rcfg), rounds=rounds, specs=spec, run_rounds=drawn)


@lru_cache(maxsize=None)
def unsharded(case):
    return ranks_mod.fed_case(job(case))


@lru_cache(maxsize=None)
def group_world(n):
    jobs = [job(c) for c in CASES]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {c: [per_rank[r][i] for r in range(n)] for i, c in enumerate(CASES)}


@lru_cache(maxsize=None)
def grid_world():
    data, model = GRID
    jobs = [dict(job(c), run_rounds=0) for c in CASES]
    per_rank = spawn_cohort(grid_ranks.world, data * model, args=(data, model, jobs),
                            device="cpu", timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {c: [per_rank[r][i] for r in range(data * model)] for i, c in enumerate(CASES)}


def ranks_of(case, where):
    """The model shares of one model group (data rank 0's on the grid)."""
    if where == "grid":
        return grid_world()[case][:GRID[1]]
    return group_world(where)[case]


def everyone(case, where):
    return grid_world()[case] if where == "grid" else group_world(where)[case]


def joined(case, where, key):
    """The whole ``(P,)`` plane ``key`` from the model shares' planes."""
    return join_planes(job(case)["cfg"], ranks_of(case, where), key)


def join_planes(cfg, ranks, key):
    """The whole ``(P,)`` plane ``key`` from each model rank's plane of it
    (rank order): its share's leaves raveled in order."""
    n = len(ranks)
    shapes = param_shapes(cfg)
    specs = param_specs(shapes, cfg, n)
    views = [FlatSpec.from_tree(shard_params(shapes, specs, r, n)).views(
        torch.as_tensor(got[key])) for r, got in enumerate(ranks)]
    return np.concatenate([join_shares([v[i] for v in views], d, n).reshape(-1).numpy()
                           for i, d in enumerate(tree_leaves(specs))])


def ref_rounds(rcfg, algo, base):
    """The reference's ``round_step`` rounds of the job ``base`` under its
    config ``rcfg`` (it draws its own faults; the user specs registered):
    each round's loss and counters, and the planes after the last."""
    rmodel = ref_build_model(_setup(VARIANT, algo)[0])

    def ref_loss(p, b):
        return rmodel.loss_fn(p, {"tokens": b["x"], "labels": b["y"]})[0]

    rows = []
    with _ref_registered():
        reng = RefEngine(rcfg, ref_loss, batch_size=B)
        st = reng.init(jax.tree_util.tree_map(jnp.asarray, base["params"]),
                       jax.random.PRNGKey(1))
        for d in base["rounds"]:
            full = None if "full" not in d else {k: jnp.asarray(v, jnp.int32)
                                                 for k, v in d["full"].items()}
            st, m = reng.round_step(st, {k: jnp.asarray(v, jnp.int32)
                                         for k, v in d["batches"].items()},
                                    jnp.asarray(d["ids"], jnp.int32), jnp.asarray(d["mask"]),
                                    full_batches=full)
            rows.append({k: float(getattr(m, k)) for k in ("loss", "n_active", "n_dropped",
                                                           "n_quarantined")})

    def flat(tree):
        return None if tree is None else np.concatenate(
            [np.asarray(x, np.float32).reshape(-1) for x in jax.tree_util.tree_leaves(tree)])

    return {"metrics": rows, "params": flat(st.params), "momentum": flat(st.server.momentum),
            "second_moment": flat(st.server.second_moment)}


@lru_cache(maxsize=None)
def reference(case):
    _, algo, fault = case
    return ref_rounds(ref_fed(algo, fault), algo, job(case))


def _margins(ranks) -> str:
    return f"quarantine margins per rank: {[r['margins'] for r in ranks]}"


WHERE = [*WORLDS, "grid"]
RUNS = [(c, w) for w in WHERE for c in CASES]


def _ids(run):
    case, where = run
    return f"{case[0]}-{where if where == 'grid' else f'{where}ranks'}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_joined_planes_match_the_unsharded_round(run):
    case, where = run
    want = unsharded(case)
    ranks = everyone(case, where)
    why = _margins(ranks)
    for r, got in enumerate(ranks):
        assert got["metrics"] == ranks[0]["metrics"], f"rank {r}: another round metric"
    for i, (a, b) in enumerate(zip(ranks[0]["metrics"], want["metrics"])):
        for key in ("loss", "delta_norm", "momentum_norm"):
            assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i} {key}")
        for key in COUNTERS:
            assert a[key] == b[key], f"round {i} {key}; {why}"
    assert_close(joined(case, where, "params"), want["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what=f"params; {why}")
    assert rel_l2(joined(case, where, "momentum"), want["momentum"]) <= GRAD_REL_L2, why


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_joined_planes_match_the_references_round_step(run):
    case, where = run
    ref = reference(case)
    ranks = everyone(case, where)
    why = _margins(ranks)
    for i, (row, want) in enumerate(zip(ranks[0]["metrics"], ref["metrics"])):
        assert_close(row["loss"], want["loss"], rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i}")
        for key in ("n_active", "n_dropped", "n_quarantined"):
            assert row[key] == want[key], f"round {i} {key}: {row[key]} vs {want[key]}; {why}"
    assert_close(joined(case, where, "params"), ref["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what=f"params; {why}")
    assert rel_l2(joined(case, where, "momentum"), ref["momentum"]) <= GRAD_REL_L2, why


def test_the_fault_cases_drop_and_quarantine_clients():
    """The faults act: over the cases' rounds some client is dropped,
    corrupted with NaN and quarantined, and corrupted with noise and
    quarantined by its norm (the reference's counters)."""
    total = {f: [0.0, 0.0] for f in FAULTS}
    for case in CASES:
        if case[2] is not None:
            for m in reference(case)["metrics"]:
                total[case[2]][0] += m["n_dropped"]
                total[case[2]][1] += m["n_quarantined"]
    assert total["drop-deadline"][0] > 0, total
    assert total["nan-quarantine"][1] > 0 and total["noise-quarantine"][1] > 0, total


@pytest.mark.parametrize("n", WORLDS)
def test_rounds_on_the_engines_own_hash_draws_match_the_unsharded_run(n):
    """``run_rounds`` with the noise fault on the engine's own draws: each
    rank draws its own columns of the one stream, so the counters are the
    unsharded run's and the joined params match."""
    case = ("fedcm-noise-quarantine", "fedcm", "noise-quarantine")
    want = unsharded(case)
    ranks = group_world(n)[case]
    for r, got in enumerate(ranks):
        for a, b in zip(got["drawn_metrics"], want["drawn_metrics"]):
            for key in ("n_active", "n_dropped", "n_quarantined"):
                assert a[key] == b[key], f"rank {r} {key}; {_margins(ranks)}"
    assert_close(joined(case, n, "drawn"), want["drawn"], rtol=RTOL, atol=ROUND_ATOL,
                 what="params")


# ------------------------------------------------------------------ the column map
MAP_CASES = [(v, n) for v in ("llama3.2-1b", "llama-kv2", "mamba2-1.3b") for n in WORLDS]


def _map_cfg(variant):
    kw = {"n_kv_heads": 2} if variant == "llama-kv2" else {}
    arch = "llama3.2-1b" if variant == "llama-kv2" else variant
    return port_model_cfg(replace(ref_reduced(ref_get_config(arch)), **kw))


@pytest.mark.parametrize("variant,n", MAP_CASES)
def test_columns_are_the_shares_of_the_whole_plane(variant, n):
    """Each leaf's columns on each rank are that rank's share of the whole
    plane's index (``shard_params`` of an index tree), the shares join back
    to the whole index (``join_shares``), every column is held, and the
    column-indexed draw is bitwise the whole-row draw's columns."""
    cfg = _map_cfg(variant)
    shapes = param_shapes(cfg)
    specs = param_specs(shapes, cfg, n)
    sizes = [t.numel() for t in tree_leaves(shapes)]
    whole = torch.arange(sum(sizes), dtype=torch.int32)
    index = FlatSpec.from_tree(shapes).unravel(whole, dtype=torch.int32)
    ids, t = torch.tensor([4, 0, 2]), torch.tensor(3)
    z = draws.normal(11, t, 4, ids, len(whole))
    per_rank, held = [], torch.zeros(len(whole), dtype=torch.bool)
    for r in range(n):
        share = shard_params(shapes, specs, r, n)
        group = group_plane(FlatSpec.from_tree(share), cfg, ParallelContext(None, r, n))
        want = tree_leaves(shard_params(index, specs, r, n))
        cols = [group.columns(i, "cpu") for i in range(len(want))]
        for i, (c, w) in enumerate(zip(cols, want)):
            assert c.dtype == torch.int32
            assert torch.equal(c, w.reshape(-1)), f"rank {r} leaf {i}"
            got = draws.normal_at(11, t, 4, ids, c)
            assert torch.equal(got, z[:, c.long()]), f"rank {r} leaf {i}"
            held[c.long()] = True
        per_rank.append(want)
    assert bool(held.all())
    for i, d in enumerate(tree_leaves(specs)):
        back = join_shares([leaves[i] for leaves in per_rank], d, n)
        assert torch.equal(back.reshape(-1), tree_leaves(index)[i].reshape(-1))


def test_columns_take_int64_past_two_to_the_31():
    """llama3.2-1b as published has 1.24e9 elements (int32); a plane of
    2^31 or more takes int64 indices."""
    cfg = port_model_cfg(ref_reduced(ref_get_config("llama3.2-1b")))
    spec = FlatSpec.from_tree(shard_params(param_shapes(cfg), param_specs(
        param_shapes(cfg), cfg, 2), 0, 2))
    group = group_plane(spec, cfg, ParallelContext(None, 0, 2))
    big = group._replace(whole_size=2 ** 31)
    assert group.columns(0, "cpu").dtype == torch.int32
    assert big.columns(0, "cpu").dtype == torch.int64
    assert torch.equal(big.columns(0, "cpu"), group.columns(0, "cpu").long())
