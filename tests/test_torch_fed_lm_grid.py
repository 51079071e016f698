"""A federated round on a grid of data × model ranks, the reference's
``fed_dryrun`` layout: the cohort split over the data group and each
client's model tensor-sharded over the model group, against the port's
unsharded round and the reference's ``round_step``.

The cases are tests/test_torch_fed_lm_group.py's: the same numpy-seeded
weights and injected draws, three rounds of fedcm, scaffold, mimelite and
fedadam over reduced llama and ``llama-kv2``, a fixed cohort of 3 (which 2
data ranks pad to 4).  Here they run on 2 × 2 and 2 × 1 grids of gloo
ranks (``launch.mesh.make_grid``; one world a shape runs every case): each
rank's engine has ``cohort_group`` its data group and ``model_group`` a
plane over its model group, draws nothing (the draws are injected), runs
its ``(C_loc, P_r)`` rows and folds over the data group on its share's
columns (``scatter_fold``).  Checked, at tests/test_torch_fed_lm.py's
tolerances (each round's loss and norms at ``LM_RTOL`` / ``LM_ATOL``, the
params at ``RTOL`` / ``ROUND_ATOL``, the momentum and FedAdam's second
moment within ``GRAD_REL_L2`` relative L2): the model shares of data rank
0, joined, against the unsharded round and the reference's; every data
rank's planes bitwise equal to data rank 0's (``x`` and ``m`` stay
replicated over data); every rank's round metrics the same.  The cases
that ROADMAP A.16 (e) 4 names still raise on a grid (the fault layer and
the escape hatches on a grid: tests/test_torch_fed_lm_group_faults.py).
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import _torch_grid_ranks as ranks_mod
from _torch_parity import GRAD_REL_L2, LM_ATOL, LM_RTOL, ROUND_ATOL, RTOL, assert_close, port_cfg
from _torch_user_specs import registered
from test_torch_fed_lm_group import (
    CASES, REFUSED, WORLD_DEADLINE_S, WORLD_TIMEOUT_S, _engine, _ref_cfg, _setup, reference,
    rel_l2, unsharded,
)
from test_torch_model_parallel import port_model_cfg
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro_torch.core.flat import FlatSpec
from repro_torch.launch import federated_llm
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.sharding.rules import param_specs
from repro_torch.sharding.shard import join_shares, param_shapes, shard_params
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

GRIDS = ((2, 2), (2, 1))  # (data, model)


@lru_cache(maxsize=None)
def sharded(data, model):
    """Every case on one world of ``data`` × ``model`` gloo ranks."""
    jobs = [dict(_setup(*c)[1], run_rounds=0) for c in CASES]
    per_rank = spawn_cohort(ranks_mod.world, data * model, args=(data, model, jobs),
                            device="cpu", timeout_s=WORLD_TIMEOUT_S,
                            deadline_s=WORLD_DEADLINE_S)
    return {c: [per_rank[r][i] for r in range(data * model)] for i, c in enumerate(CASES)}


def joined(variant, algo, grid, key):
    """The whole ``(P,)`` plane ``key`` from data rank 0's model shares."""
    data, model = grid
    cfg = _setup(variant, algo)[1]["cfg"]
    shapes = param_shapes(cfg)
    specs = param_specs(shapes, cfg, model)
    per_rank = [FlatSpec.from_tree(shard_params(shapes, specs, m, model)).views(
        torch.as_tensor(sharded(*grid)[(variant, algo)][m][key])) for m in range(model)]
    return np.concatenate([
        join_shares([leaves[i] for leaves in per_rank], dim, model).reshape(-1).numpy()
        for i, dim in enumerate(tree_leaves(specs))])


GRID_CASES = [(v, a, g) for g in GRIDS for v, a in CASES]


def _ids(case):
    return f"{case[0]}-{case[1]}-{case[2][0]}x{case[2][1]}"


@pytest.mark.parametrize("case", GRID_CASES, ids=_ids)
def test_joined_planes_match_the_unsharded_round(case):
    variant, algo, grid = case
    want = unsharded(variant, algo)
    ranks = sharded(*grid)[(variant, algo)]
    for r, got in enumerate(ranks):
        assert got["metrics"] == ranks[0]["metrics"], f"rank {r}: another round metric"
        for key in ("params", "momentum", "second_moment"):  # replicated over data
            if got[key] is not None:
                np.testing.assert_array_equal(got[key], ranks[r % grid[1]][key], err_msg=key)
    for i, (a, b) in enumerate(zip(ranks[0]["metrics"], want["metrics"])):
        assert_close(a["loss"], b["loss"], rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i} loss")
        for key in ("delta_norm", "momentum_norm"):
            assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=key)
        for key in ("n_active", "bytes_up", "bytes_down"):
            assert a[key] == b[key], key
    assert_close(joined(variant, algo, grid, "params"), want["params"], rtol=RTOL,
                 atol=ROUND_ATOL, what="params")
    for key in ("momentum", "second_moment"):
        if want[key] is not None:
            assert rel_l2(joined(variant, algo, grid, key), want[key]) <= GRAD_REL_L2, key


@pytest.mark.parametrize("case", GRID_CASES, ids=_ids)
def test_joined_planes_match_the_references_round_step(case):
    variant, algo, grid = case
    ref = reference(variant, algo)
    rank0 = sharded(*grid)[(variant, algo)][0]
    for i, (row, want) in enumerate(zip(rank0["metrics"], ref["losses"])):
        assert_close(row["loss"], want, rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i} loss")
    assert_close(joined(variant, algo, grid, "params"), ref["params"], rtol=RTOL,
                 atol=ROUND_ATOL, what="params")
    for key in ("momentum", "second_moment"):
        if ref[key] is not None:
            assert rel_l2(joined(variant, algo, grid, key), ref[key]) <= GRAD_REL_L2, key


@pytest.mark.parametrize("what", [w for w in REFUSED if w != "cohort-shard"])
def test_what_a_grid_does_not_run_raises(what):
    """Each case ROADMAP A.16 (e) 4 names raises under a model group with the
    cohort sharded beside it, before any process group is asked for."""
    fed = replace(port_cfg(_ref_cfg("fedcm")), cohort_shard=2, **REFUSED[what])
    with registered():
        with pytest.raises(NotImplementedError, match=r"A\.16 \(e\) 4"):
            _engine(fed)


def test_federated_llm_on_a_grid_reports_every_rank():
    """``run(..., model_parallel=2, cohort_shard=2)``: four ranks, the
    unsharded run's round metrics on each."""
    cfg = port_model_cfg(ref_reduced(ref_get_config("llama3.2-1b")))
    kw = dict(n_clients=4, cohort=3, local_steps=2, batch=2, seq=16, rounds=2, device="cpu")
    plain = federated_llm.run(cfg, **kw)
    res = federated_llm.run(cfg, model_parallel=2, cohort_shard=2, **kw)
    assert res.n_params == plain.n_params and len(res.by_rank) == 4
    for a, b in zip(res.rounds, plain.rounds):
        for key in ("loss", "momentum_norm", "delta_norm"):
            assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=key)
    for mine in res.by_rank:  # on the CPU the wrappers take their plain versions
        assert mine["rounds"] == res.rounds and not any(mine["launches"].values())
