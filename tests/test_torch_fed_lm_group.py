"""A federated round whose clients are each a model group (the reference's
``fed_dryrun`` layout: each client's model tensor-sharded over
``"model"``), against the port's unsharded round and the reference's
``round_step``.

The same numpy-seeded weights (``np_weights``) and the same injected draws
(numpy: each round's cohort ids and every client's minibatch indices into
its corpus, and for MimeLite each cohort client's whole corpus) go into (a)
the reference's ``FederatedEngine.round_step`` (its kernel route), (b) the
port's unsharded engine and (c) the port on 2 and 4 gloo ranks, each rank
holding its share's columns of every plane (``model_group=group_plane(...)``,
``cohort_loss_fn(model, parallel)``; one world a size runs every case).
Three rounds of fedcm, scaffold, mimelite and fedadam over reduced llama
and ``llama-kv2`` (four ranks keep ``wk`` / ``wv`` whole: their gradient
is partial on each rank and summed over the group).  The ranks' planes are
joined (``join_shares``) and held to (b) and to (a) at
tests/test_torch_fed_lm.py's tolerances: each round's loss at ``LM_RTOL``
/ ``LM_ATOL``, the params at ``RTOL`` / ``ROUND_ATOL``, the momentum (and
FedAdam's second moment) within ``GRAD_REL_L2`` relative L2.  The round
metrics (loss, ‖Δ‖ and ‖Δ_t‖ over the whole plane) are equal on every rank.
Then two rounds on the engine's own draws (``run_rounds``, each rank's
generator seeded alike, the engine checking the first round's draws across
ranks) against the unsharded run, and each case that ROADMAP A.16 (e) 4
names raises.  The fault layer, the escape hatches and the tree path on a
group: tests/test_torch_fed_lm_group_faults.py, test_torch_tree_path_group.py.
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
from test_torch_model_parallel import np_weights, port_model_cfg
from repro.configs.base import FedConfig as RefFedConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core.engine import FederatedEngine as RefEngine
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.engine import FederatedEngine
from repro_torch.core.flat import FlatSpec
from repro_torch.data import LMFederatedData, federated_lm_corpora
from repro_torch.launch import federated_llm
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.models.layers import ParallelContext
from repro_torch.models.model import build_model, cohort_loss_fn
from repro_torch.sharding.rules import param_specs
from repro_torch.sharding.shard import group_plane, join_shares, param_shapes, shard_params
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

N, COHORT, K, B, S, N_SEQ, ROUNDS = 6, 3, 2, 2, 16, 8, 3
WORLDS = (2, 4)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 120.0, 600.0
ALGOS = ("fedcm", "scaffold", "mimelite", "fedadam")
ETA_G = {"fedadam": 0.03}
VARIANTS = {"llama3.2-1b": ("llama3.2-1b", {}), "llama-kv2": ("llama3.2-1b", {"n_kv_heads": 2})}
DRAWN_ROUNDS = 2


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref_cfg(algo) -> RefFedConfig:
    return RefFedConfig(algo=algo, num_clients=N, cohort_size=COHORT, local_steps=K, alpha=0.1,
                        eta_l=0.05, eta_g=ETA_G.get(algo, 1.0), weight_decay=1e-4,
                        participation="fixed", use_fused_kernel=True)


@lru_cache(maxsize=None)
def _setup(variant, algo):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    toks = federated_lm_corpora(cfg.vocab_size, N, S + 1, N_SEQ)
    cx, cy = toks[..., :-1], toks[..., 1:]
    rng = np.random.default_rng(4)
    rounds = []
    for _ in range(ROUNDS):
        ids = rng.permutation(N)[:COHORT]
        idx = rng.integers(0, N_SEQ, size=(COHORT, K, B))
        d = {"ids": ids, "mask": np.ones(COHORT, bool),
             "batches": {"x": cx[ids[:, None, None], idx], "y": cy[ids[:, None, None], idx]}}
        if algo == "mimelite":
            d["full"] = {"x": cx[ids], "y": cy[ids]}
        rounds.append(d)
    job = {"kind": "fed", "cfg": cfg, "fed": port_cfg(_ref_cfg(algo)),
           "params": np_weights(cfg, 1), "rounds": rounds, "B": B, "tokens": toks,
           "run_rounds": DRAWN_ROUNDS if algo == "fedcm" else 0}
    return rcfg, job


CASES = [(v, a) for v in VARIANTS for a in ALGOS]


@lru_cache(maxsize=None)
def unsharded(variant, algo):
    """(b): the port's unsharded rounds, through the ranks' own body."""
    return ranks_mod.fed_case(_setup(variant, algo)[1])


@lru_cache(maxsize=None)
def sharded(n):
    """(c): every case on one world of ``n`` gloo ranks."""
    jobs = [_setup(*c)[1] for c in CASES]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {c: [per_rank[r][i] for r in range(n)] for i, c in enumerate(CASES)}


@lru_cache(maxsize=None)
def reference(variant, algo):
    """(a): the reference's rounds on the same draws: per round its loss,
    and its params / momentum / second moment after the last."""
    rcfg, job = _setup(variant, algo)
    rmodel = ref_build_model(rcfg)

    def ref_loss(p, b):
        return rmodel.loss_fn(p, {"tokens": b["x"], "labels": b["y"]})[0]

    reng = RefEngine(_ref_cfg(algo), ref_loss, batch_size=B)
    st = reng.init(jax.tree_util.tree_map(jnp.asarray, job["params"]), jax.random.PRNGKey(1))
    losses = []
    for d in job["rounds"]:
        full = None if "full" not in d else {k: jnp.asarray(v, jnp.int32)
                                             for k, v in d["full"].items()}
        st, m = reng.round_step(st, {k: jnp.asarray(v, jnp.int32) for k, v in
                                     d["batches"].items()}, jnp.asarray(d["ids"], jnp.int32),
                                jnp.asarray(d["mask"]), full_batches=full)
        losses.append(float(m.loss))

    def flat(tree):
        return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                               for x in jax.tree_util.tree_leaves(tree)])

    sm = st.server.second_moment
    return {"losses": losses, "params": flat(st.params), "momentum": flat(st.server.momentum),
            "second_moment": None if sm is None else flat(sm)}


def joined(variant, algo, n, key):
    """The whole ``(P,)`` plane ``key`` from every rank's share of it."""
    cfg = _setup(variant, algo)[1]["cfg"]
    shapes = param_shapes(cfg)
    specs = tree_leaves(param_specs(shapes, cfg, n))
    ranks = sharded(n)[(variant, algo)]
    per_rank = []
    for r, got in enumerate(ranks):
        share = shard_params(shapes, param_specs(shapes, cfg, n), r, n)
        spec = FlatSpec.from_tree(share)
        per_rank.append(spec.views(torch.as_tensor(got[key])))
    return np.concatenate([
        join_shares([leaves[i] for leaves in per_rank], dim, n).reshape(-1).numpy()
        for i, dim in enumerate(specs)])


RANK_CASES = [(v, a, n) for n in WORLDS for v, a in CASES]


def _ids(case):
    return f"{case[0]}-{case[1]}-{case[2]}ranks"


@pytest.mark.parametrize("case", RANK_CASES, ids=_ids)
def test_joined_planes_match_the_unsharded_round(case):
    variant, algo, n = case
    want = unsharded(variant, algo)
    for r, got in enumerate(sharded(n)[(variant, algo)]):
        for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            assert_close(a["loss"], b["loss"], rtol=LM_RTOL, atol=LM_ATOL,
                         what=f"rank {r} round {i} loss")
            for key in ("delta_norm", "momentum_norm"):
                assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=key)
            for key in ("n_active", "bytes_up", "bytes_down"):
                assert a[key] == b[key], key
    assert_close(joined(variant, algo, n, "params"), want["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what="params")
    for key in ("momentum", "second_moment"):
        if want[key] is not None:
            assert rel_l2(joined(variant, algo, n, key), want[key]) <= GRAD_REL_L2, key


@pytest.mark.parametrize("case", RANK_CASES, ids=_ids)
def test_joined_planes_match_the_references_round_step(case):
    variant, algo, n = case
    ref = reference(variant, algo)
    got = sharded(n)[(variant, algo)]
    for r, rank in enumerate(got):
        assert rank["metrics"] == got[0]["metrics"], f"rank {r}: another round metric"
        for i, (row, want) in enumerate(zip(rank["metrics"], ref["losses"])):
            assert_close(row["loss"], want, rtol=LM_RTOL, atol=LM_ATOL, what=f"round {i} loss")
    assert_close(joined(variant, algo, n, "params"), ref["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what="params")
    start = np.concatenate([x.reshape(-1) for x in tree_leaves(_setup(variant, algo)[1]["params"])])
    assert float(np.abs(ref["params"] - start).max()) > 10 * ROUND_ATOL  # the rounds moved it
    for key in ("momentum", "second_moment"):
        if ref[key] is not None:
            assert rel_l2(joined(variant, algo, n, key), ref[key]) <= GRAD_REL_L2, key


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rounds_on_the_engines_own_draws_match_the_unsharded_run(variant, n):
    """``run_rounds`` from a generator seeded alike on every rank: the
    engine checks that the ranks drew the same cohort and minibatches, and
    the joined params match the unsharded run's."""
    want = unsharded(variant, "fedcm")["drawn"]
    assert_close(joined(variant, "fedcm", n, "drawn"), want, rtol=RTOL, atol=ROUND_ATOL,
                 what="params")


# ------------------------------------------------------------ what raises
def _engine(fed, parallel=None, **kw):
    cfg = _setup("llama3.2-1b", "fedcm")[1]["cfg"]
    parallel = parallel or ParallelContext(None, 0, 2)
    shapes = param_shapes(cfg)
    share = shard_params(shapes, param_specs(shapes, cfg, 2), 0, 2)
    spec = FlatSpec.from_tree(share)
    return FederatedEngine(fed, cohort_loss_fn(build_model(cfg), parallel), spec, batch_size=B,
                           device="cpu", model_group=group_plane(spec, cfg, parallel), **kw)


REFUSED = {
    "int8": {"compression": CompressionConfig(kind="int8")},
    "bf16": {"compression": CompressionConfig(kind="bf16")},
    "topk": {"compression": CompressionConfig(kind="topk")},
    "host-store": {"population_store": "host"},
    "cohort-shard": {"cohort_shard": 2},
}


@pytest.mark.parametrize("what", REFUSED)
def test_what_a_model_group_does_not_run_raises(what):
    """Each A.16 (e) 4 case raises.  Cohort sharding no longer does (the grid,
    tests/test_torch_fed_lm_grid.py): the engine passes the model group's
    check and asks for the cohort's process group, which this process has
    not got."""
    fed = replace(port_cfg(_ref_cfg("fedcm")), **REFUSED[what])
    lifted = what == "cohort-shard"
    with registered():
        with pytest.raises(ValueError if lifted else NotImplementedError,
                           match="spawn_cohort" if lifted else r"A\.16 \(e\) 4"):
            _engine(fed)


def test_the_async_ring_under_a_model_group_raises():
    eng = _engine(port_cfg(_ref_cfg("fedcm")))
    data = LMFederatedData(_setup("llama3.2-1b", "fedcm")[1]["tokens"], device="cpu")
    with pytest.raises(NotImplementedError, match=r"A\.16 \(e\) 4"):
        eng.run_rounds_async(None, data, 2, pipeline_depth=2, staleness=1)


def test_payload_bytes_are_the_whole_models():
    cfg = _setup("llama3.2-1b", "fedcm")[1]["cfg"]
    whole = sum(t.numel() * 4 for t in tree_leaves(param_shapes(cfg)))
    pay = _engine(port_cfg(_ref_cfg("scaffold"))).payload_bytes()
    assert pay == {"down_per_client": 2 * whole, "up_per_client": 2 * whole}


def test_federated_llm_on_two_ranks_reports_every_rank():
    cfg = port_model_cfg(ref_reduced(ref_get_config("llama3.2-1b")))
    kw = dict(n_clients=4, cohort=2, local_steps=2, batch=2, seq=16, rounds=2, device="cpu")
    plain = federated_llm.run(cfg, **kw)
    res = federated_llm.run(cfg, model_parallel=2, **kw)
    assert res.n_params == plain.n_params and len(res.by_rank) == 2
    assert sum(r["share_params"] for r in res.by_rank) < 2 * plain.n_params
    for a, b in zip(res.rounds, plain.rounds):
        for key in ("loss", "momentum_norm", "delta_norm"):
            assert_close(a[key], b[key], rtol=LM_RTOL, atol=LM_ATOL, what=key)
    for mine in res.by_rank:  # on the CPU the wrappers take their plain versions
        assert mine["rounds"] == res.rounds and not any(mine["launches"].values())


def test_federated_llm_cli_on_two_ranks(capfd):
    assert federated_llm.main(["--device", "cpu", "--model-parallel", "2"]) == 0
    out = capfd.readouterr().out
    assert "round  20" in out and "loss " in out
