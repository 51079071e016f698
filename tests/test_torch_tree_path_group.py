"""The per-leaf tree path (``use_flat_plane=False``) on a model group, the
reference's own route for model-sharded params, against the port's
unsharded tree path and the reference's ``round_step`` on its tree path.

The rounds are tests/test_torch_fed_lm_group.py's (reduced llama, the same
numpy-seeded weights, ids and minibatches): fedcm, scaffold, mimelite and
fedadam; fedcm with the noise fault and quarantine by norm (the
reference's per-leaf threefry noise injected into the port, each rank
taking its columns of it, ``GroupPlane.columns``); and the ``_test_escape``
spec, whose ``direction_fn`` and ``server_fn`` see whole leaf trees
gathered over the group (``tree_direction`` / ``tree_server_update`` with
``group=``).  Each runs on one world of 2 and one of 4 gloo ranks whose
state is each rank's share tree.  Checked as in the flat group tests: the
joined params at ``RTOL`` / ``ROUND_ATOL``, the momentum (and FedAdam's
second moment) within ``GRAD_REL_L2`` relative L2, each round's loss and
norms at ``LM_RTOL`` / ``LM_ATOL``, the counters exactly and the round
metrics equal on every rank.  A cohort group beside the model group (the
tree path on a grid) raises, naming its ROADMAP item.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_train_ranks as ranks_mod
from _torch_parity import GRAD_REL_L2, LM_ATOL, LM_RTOL, ROUND_ATOL, RTOL, assert_close, port_cfg
from _torch_user_specs import registered
from test_torch_fed_lm_group import (
    WORLD_DEADLINE_S, WORLD_TIMEOUT_S, _engine, _ref_cfg, _setup, rel_l2,
)
from test_torch_fed_lm_group_faults import COUNTERS, FAULTS, join_planes, ref_rounds
from repro.configs.base import FaultConfig as RefFaultConfig
from repro.core.faults import _per_client_keys
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

WORLDS = (2, 4)
VARIANT = "llama3.2-1b"
# (case id, algorithm or user spec, fault or None)
CASES = ([(a, a, None) for a in ("fedcm", "scaffold", "mimelite", "fedadam")]
         + [("fedcm-noise-quarantine", "fedcm", "noise-quarantine"),
            ("_test_escape", "_test_escape", None)])


def ref_fed(algo, fault):
    cfg = replace(_ref_cfg(algo), use_flat_plane=False)
    return cfg if fault is None else replace(cfg, fault=RefFaultConfig(**FAULTS[fault]))


def tree_draws(cfg, t, ids, shapes):
    """The reference's fault draws of round ``t`` on its tree path: leaf
    i's noise from ``fold_in(client key, i)``, the leaves' columns
    concatenated in order into whole ``(C, P)`` rows."""
    f = cfg.fault
    ids = jnp.asarray(ids)
    kt = jax.random.fold_in(jax.random.PRNGKey(f.seed), t)
    one_u = jax.vmap(lambda k: jax.random.uniform(k, ()))
    out = {"u_corrupt": one_u(_per_client_keys(kt, 3, ids))}
    keys = _per_client_keys(kt, 4, ids)
    out["z_noise"] = jnp.concatenate([jax.vmap(lambda k, i=i, s=s: jax.random.normal(
        jax.random.fold_in(k, i), s, jnp.float32).reshape(-1))(keys)
        for i, s in enumerate(shapes)], axis=1)
    return {k: np.array(v) for k, v in out.items()}


@lru_cache(maxsize=None)
def job(case):
    _, algo, fault = case
    base = _setup(VARIANT, algo)[1]
    rcfg = ref_fed(algo, fault)
    shapes = [x.shape for x in tree_leaves(base["params"])]
    rounds = [dict(d) if fault is None else dict(d, draws=tree_draws(rcfg, t, d["ids"], shapes))
              for t, d in enumerate(base["rounds"])]
    spec = (algo,) if algo.startswith("_test") else ()
    return dict(base, fed=port_cfg(rcfg), rounds=rounds, specs=spec, run_rounds=0)


@lru_cache(maxsize=None)
def unsharded(case):
    return ranks_mod.fed_case(job(case))


@lru_cache(maxsize=None)
def world(n):
    jobs = [job(c) for c in CASES]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {c: [per_rank[r][i] for r in range(n)] for i, c in enumerate(CASES)}


def joined(case, n, key):
    """The whole plane ``key`` from the ranks' share trees (raveled in
    leaf order, the share plane's layout)."""
    return join_planes(job(case)["cfg"], world(n)[case], key)


@lru_cache(maxsize=None)
def reference(case):
    """The reference's tree-path rounds of ``case``."""
    _, algo, fault = case
    return ref_rounds(ref_fed(algo, fault), algo, job(case))


RUNS = [(c, n) for n in WORLDS for c in CASES]


def _ids(run):
    return f"{run[0][0]}-{run[1]}ranks"


def _why(case, n) -> str:
    return f"quarantine margins per rank: {[r['margins'] for r in world(n)[case]]}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_tree_path_on_a_group_matches_the_unsharded_tree_path(run):
    case, n = run
    want = unsharded(case)
    ranks = world(n)[case]
    why = _why(case, n)
    for r, got in enumerate(ranks):
        assert got["metrics"] == ranks[0]["metrics"], f"rank {r}: another round metric"
    for i, (a, b) in enumerate(zip(ranks[0]["metrics"], want["metrics"])):
        for key in ("loss", "delta_norm", "momentum_norm"):
            assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i} {key}")
        for key in COUNTERS:
            assert a[key] == b[key], f"round {i} {key}; {why}"
    assert_close(joined(case, n, "params"), want["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what=f"params; {why}")
    for key in ("momentum", "second_moment"):
        if want[key] is not None:
            assert rel_l2(joined(case, n, key), want[key]) <= GRAD_REL_L2, f"{key}; {why}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_tree_path_on_a_group_matches_the_references_tree_path(run):
    case, n = run
    ref = reference(case)
    ranks = world(n)[case]
    why = _why(case, n)
    for i, (row, want) in enumerate(zip(ranks[0]["metrics"], ref["metrics"])):
        assert_close(row["loss"], want["loss"], rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i}")
        for key in ("n_active", "n_dropped", "n_quarantined"):
            assert row[key] == want[key], f"round {i} {key}; {why}"
    assert_close(joined(case, n, "params"), ref["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what=f"params; {why}")
    for key in ("momentum", "second_moment"):
        if ref[key] is not None:
            assert rel_l2(joined(case, n, key), ref[key]) <= GRAD_REL_L2, f"{key}; {why}"


def test_the_tree_fault_case_quarantines_a_client():
    case = ("fedcm-noise-quarantine", "fedcm", "noise-quarantine")
    assert sum(m["n_quarantined"] for m in reference(case)["metrics"]) > 0


def test_tree_path_on_a_grid_names_its_roadmap_item():
    """The tree path with the cohort over data beside the model group: the
    reference's layout pins the cohort axis under GSPMD, which the port's
    tree path does not do yet."""
    fed = replace(port_cfg(_ref_cfg("fedcm")), use_flat_plane=False, cohort_shard=2)
    with registered():
        with pytest.raises(NotImplementedError, match=r"A\.16 \(e\) 5"):
            _engine(fed)
