"""Training on a model group (the reference's ``"model"``-axis train step)
against the unsharded step, in the port and in the reference.

The same numpy-seeded weights (``np_weights``) and batch go into (a) the
reference's ``build_train_step(...).fn`` (reduced llama, on a one-device
mesh of ``Auto`` axes), (b) the port's unsharded ``build_train_step`` and
(c) the port on 2 and 4 gloo ranks (``spawn_cohort(..., device="cpu")``,
one world a size running every case; each rank slices its share with
``shard_params`` and steps it with ``build_train_step(cfg, knobs,
parallel)``).  Each case takes two steps under two knob sets: one
microbatch with ``remat="none"``, and two microbatches with
``remat="dots"``.  Checked: every rank's params, and both AdamW moments,
against (b)'s slice of them; the replicated parts (whole and partial)
bitwise equal across ranks; the same loss and grad norm on every rank;
and, for reduced llama, the ranks' shares joined (``join_shares``) against
(a).

The variants are tests/test_torch_model_parallel.py's and
test_torch_model_parallel_ssm.py's, chosen for the leaves a rank reads only
in part: ``llama-kv2`` (four ranks keep ``wk`` / ``wv`` whole and pick kv
heads), ``odd-heads`` (two ranks repeat kv heads a q head at a time; four
run attention and the MLP whole), qwen3 (the QK-norms' scales), dbrx and
maverick (the router; maverick's shared expert is the group's MLP),
mamba2 (``A_log`` / ``D_skip`` / ``dt_bias``, B's and C's columns of
``w_in`` and the conv), a mamba2 whose 6 SSD heads four ranks do not
divide (the block whole), zamba2 with a tail layer (the shared block) and
seamless (the cross-attention's K/V of the encoder output).

Tolerances.  The loss and the grad norm at ``LM_RTOL`` / ``LM_ATOL``
(tests/_torch_parity.py).  Each leaf's update after two steps (new − old
params) within ``UPDATE_REL_L2`` relative L2 (AdamW's g / (|g| + ε) moves
an element whose gradient lies within its rounding noise of 0 by a sizeable
part of lr, see chip_smoke.py); each moment leaf within ``GROUP_REL_L2``:
the group sums each layer's partial products in another order than the
unsharded GEMM, and the two steps compound it; measured ≤ 2.3e-5 relative
L2 over these cases (zamba2's second moment), and up to 1.1e-4 on other
seeded batches.  The updates measured ≤ 3.9e-4 (dbrx).  bf16 knobs
(``moment_dtype``, ``grad_accum_dtype``) are held to the reference within
``BF16_RTOL`` relative L2: a value on a rounding tie of an f32 difference
apart lands one bf16 ulp away.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh

import _torch_train_ranks as ranks_mod
from _torch_parity import BF16_RTOL, LM_ATOL, LM_RTOL, UPDATE_REL_L2, assert_close
from test_torch_model_parallel import np_weights, port_model_cfg
from repro.configs.base import ShapeConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch.steps import Knobs as RefKnobs
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.optim.optimizers import adamw as ref_adamw
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.launch.steps import Knobs, build_train_step
from repro_torch.sharding.rules import GROUP_USES, _keys, group_use, param_specs, split_dim
from repro_torch.sharding.shard import join_shares, param_shapes, share_parts, take
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

torch.set_num_threads(1)

B, S, S_SRC, STEPS, LR = 4, 12, 9, 2, 1e-3
WORLDS = (2, 4)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 120.0, 600.0
GROUP_REL_L2 = 2e-4
KNOBS = ({"microbatches": 1, "remat": "none"}, {"microbatches": 2, "remat": "dots"})
VARIANTS = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "llama-kv2": ("llama3.2-1b", {"n_kv_heads": 2}),
    "odd-heads": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3, "d_ff": 510}),
    "qwen3": ("qwen3-14b", {}),
    "dbrx": ("dbrx-132b", {}),
    "maverick": ("llama4-maverick-400b-a17b", {}),
    "mamba2": ("mamba2-1.3b", {}),
    "mamba2-6heads": ("mamba2-1.3b", {"d_model": 96}),
    "zamba2-tail": ("zamba2-7b", {"n_layers": 3}),
    "seamless": ("seamless-m4t-large-v2", {}),
}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@lru_cache(maxsize=None)
def _setup(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encoder_decoder:
        batch = {"src_embeds": rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32),
                 "tgt_tokens": toks, "labels": batch["labels"]}
    knobs = [dict(k, learning_rate=LR) for k in KNOBS]
    return rcfg, {"kind": "train", "cfg": cfg, "params": np_weights(cfg, 1), "batch": batch,
                  "steps": STEPS, "knobs": knobs}


@lru_cache(maxsize=None)
def unsharded(variant):
    """(b): the port's unsharded steps, through the ranks' own body."""
    return ranks_mod.train_case(_setup(variant)[1])


@lru_cache(maxsize=None)
def sharded(n):
    """(c): every variant on one world of ``n`` gloo ranks; per variant the
    ranks' results in rank order."""
    jobs = [_setup(v)[1] for v in VARIANTS]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {v: [per_rank[r][i] for r in range(n)] for i, v in enumerate(VARIANTS)}


CASES = [(v, n, k) for n in WORLDS for v in VARIANTS for k in range(len(KNOBS))]


def _ids(case):
    v, n, k = case
    return f"{v}-{n}ranks-{'M{microbatches}-{remat}'.format(**KNOBS[k])}"


def _specs(cfg, n):
    return tree_leaves(param_specs(param_shapes(cfg), cfg, n))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_ranks_share_steps_as_the_unsharded_slice(case):
    variant, n, k = case
    job = _setup(variant)[1]
    want = unsharded(variant)[k]
    start = tree_leaves(job["params"])
    for r, got in enumerate(sharded(n)[variant]):
        got = got[k]
        for (l, g), (lw, gw) in zip(got["metrics"], want["metrics"]):
            assert_close(l, lw, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} loss")
            assert_close(g, gw, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} grad norm")
        for i, dim in enumerate(_specs(job["cfg"], n)):
            def mine(a):
                return take(torch.as_tensor(a), dim, r, n).numpy()

            p0 = mine(start[i])
            upd = rel_l2(got["params"][i] - p0, mine(want["params"][i]) - p0)
            assert upd <= UPDATE_REL_L2, (r, i, "update", upd)
            for key in ("m", "v"):
                err = rel_l2(got[key][i], mine(want[key][i]))
                assert err <= GROUP_REL_L2, (r, i, key, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_replicated_parts_loss_and_grad_norm_are_equal_on_every_rank(case):
    variant, n, k = case
    ranks = [got[k] for got in sharded(n)[variant]]
    for r, got in enumerate(ranks):
        assert got["digest"] == ranks[0]["digest"], f"rank {r}: a replicated part differs"
        assert got["metrics"] == ranks[0]["metrics"], f"rank {r}"
        assert np.isfinite(got["metrics"]).all()


# ------------------------------------------------------- against the reference
def _ref_step(rcfg, knobs):
    """The reference's ``build_train_step(...).fn`` and its AdamW, on a
    one-device mesh whose axes are ``Auto`` (the reference's
    ``make_test_mesh`` makes them ``Explicit``, which its sharding
    constraints refuse on one CPU)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    rk = RefKnobs(param_dtype="float32", **knobs)
    bundle = ref_build_train_step(rcfg, ShapeConfig("t", "train", seq_len=S, global_batch=B),
                                  mesh, rk)
    return ref_adamw(rk.learning_rate, moment_dtype=jnp.dtype(rk.moment_dtype)), bundle.fn, mesh


@lru_cache(maxsize=None)
def reference(variant, k):
    """(a): two of the reference's steps from the same weights and batch."""
    rcfg, job = _setup(variant)
    opt, fn, mesh = _ref_step(rcfg, job["knobs"][k])
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    state = opt.init(params)
    batch = {key: jnp.asarray(v, jnp.int32) for key, v in job["batch"].items()}
    metrics = []
    with mesh:
        for _ in range(STEPS):
            params, state, m = fn(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = jax.tree_util.tree_leaves
    return {"params": [np.asarray(x) for x in leaves(params)],
            "m": [np.asarray(x) for x in leaves(state[1])],
            "v": [np.asarray(x) for x in leaves(state[2])], "metrics": metrics}


REF_CASES = [(n, k) for n in WORLDS for k in range(len(KNOBS))]


@pytest.mark.parametrize("n,k", REF_CASES,
                         ids=[_ids(("llama3.2-1b", n, k)) for n, k in REF_CASES])
def test_joined_shares_match_the_references_train_step(n, k):
    job = _setup("llama3.2-1b")[1]
    ref = reference("llama3.2-1b", k)
    ranks = [got[k] for got in sharded(n)["llama3.2-1b"]]
    for (l, g), (lr, gr) in zip(ranks[0]["metrics"], ref["metrics"]):
        assert_close(l, lr, rtol=LM_RTOL, atol=LM_ATOL, what="loss")
        assert_close(g, gr, rtol=LM_RTOL, atol=LM_ATOL, what="grad norm")
    start = tree_leaves(job["params"])
    for i, dim in enumerate(_specs(job["cfg"], n)):
        def joined(key):
            return join_shares([torch.as_tensor(got[key][i]) for got in ranks], dim, n).numpy()

        upd = rel_l2(joined("params") - start[i], ref["params"][i] - start[i])
        assert upd <= UPDATE_REL_L2, (i, "update", upd)
        for key in ("m", "v"):
            err = rel_l2(joined(key), ref[key][i])
            assert err <= GROUP_REL_L2, (i, key, err)


BF16_KNOBS = ({"moment_dtype": "bfloat16"},
              {"grad_accum_dtype": "bfloat16", "microbatches": 2})


@pytest.mark.parametrize("knobs", BF16_KNOBS, ids=["bf16-moments", "bf16-accumulator"])
def test_bf16_knobs_match_the_references_step(knobs):
    """One step from the same f32 weights under each bf16 knob: the moments'
    dtype is the knob's, and the update and moments are within
    ``BF16_RTOL`` of the reference's."""
    rcfg, job = _setup("llama3.2-1b")
    kw = dict(knobs, remat="none", learning_rate=LR)
    opt, fn, mesh = _ref_step(rcfg, kw)
    rparams = jax.tree_util.tree_map(jnp.asarray, job["params"])
    batch = {key: jnp.asarray(v, jnp.int32) for key, v in job["batch"].items()}
    with mesh:
        rnew, rstate, rmet = fn(rparams, opt.init(rparams), batch)
    step = build_train_step(job["cfg"], Knobs(**kw))
    params = ranks_mod._share(job["cfg"], job["params"], None)
    new, state, met = step.fn(params, step.opt.init(params),
                              {key: torch.as_tensor(v) for key, v in job["batch"].items()})
    assert_close(met["loss"], rmet["loss"], rtol=LM_RTOL, atol=LM_ATOL, what="loss")
    assert_close(met["grad_norm"], rmet["grad_norm"], rtol=BF16_RTOL, atol=LM_ATOL)
    mdt = getattr(torch, knobs.get("moment_dtype", "float32"))
    for p, rp, p0, m, v, rm, rv in zip(tree_leaves(new), jax.tree_util.tree_leaves(rnew),
                                       tree_leaves(params), tree_leaves(state[1]),
                                       tree_leaves(state[2]),
                                       jax.tree_util.tree_leaves(rstate[1]),
                                       jax.tree_util.tree_leaves(rstate[2])):
        assert m.dtype == v.dtype == mdt
        p0 = p0.numpy()
        assert rel_l2(p.numpy() - p0, np.asarray(rp) - p0) <= BF16_RTOL
        for a, b in ((m, rm), (v, rv)):
            assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) <= BF16_RTOL


def test_bad_knob_dtype_is_refused():
    cfg = reduced(get_config("llama3.2-1b"))
    with pytest.raises(ValueError, match="moment_dtype"):
        build_train_step(cfg, Knobs(moment_dtype="float16"))


# ------------------------------------------------------------- the rules
@pytest.mark.parametrize("variant", VARIANTS)
def test_group_use_of_every_leaf(variant):
    """``group_use`` by hand: the split leaves are ``split_dim``'s; of the
    whole ones, ``wk`` / ``wv`` and the QK-norms' scales are partial when
    the q heads split, mamba2's per-head vectors when the SSD heads split,
    the router when the experts split; every other leaf is whole."""
    cfg = _setup(variant)[1]["cfg"]
    shapes = param_shapes(cfg)
    for n in WORLDS:
        heads = cfg.n_heads % n == 0
        ssd = bool(cfg.ssm_heads) and cfg.ssm_heads % n == 0 and cfg.ssm_heads >= n
        experts = bool(cfg.n_experts) and cfg.n_experts % n == 0
        for path, leaf in tree_flatten_with_path(shapes)[0]:
            keys = _keys(path)
            use = group_use(keys, tuple(leaf.shape), n, cfg)
            assert use in GROUP_USES
            if split_dim(keys, tuple(leaf.shape), n, cfg) is not None:
                assert use == "split", keys
            elif keys[-1] in ("wk", "wv", "q_norm", "k_norm"):
                assert use == ("partial" if heads else "whole"), keys
            elif keys[-1] in ("A_log", "D_skip", "dt_bias"):
                assert use == ("partial" if ssd else "whole"), keys
            elif keys[-1] == "router":
                assert use == ("partial" if experts else "whole"), keys
            else:
                assert use == "whole", keys
        parts = share_parts(cfg, n)
        assert len(parts) == len(tree_leaves(shapes))


def test_join_shares_inverts_take():
    cfg = _setup("mamba2")[1]["cfg"]
    whole = ranks_mod._share(cfg, _setup("mamba2")[1]["params"], None)
    for n in WORLDS:
        for leaf, dim in zip(tree_leaves(whole), _specs(cfg, n)):
            shares = [take(leaf, dim, r, n) for r in range(n)]
            assert torch.equal(join_shares(shares, dim, n), leaf)


# ------------------------------------------------------------------ the CLI
SMALL = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16", "--log-every", "2",
         "--warmup", "2", "--seed", "3"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_cli_on_two_ranks_logs_the_unsharded_losses(arch, capfd):
    """The log (stderr: ``MetricLogger``) of rank 0 is the unsharded run's,
    each row's loss and grad norm; rank 1 logs nothing."""
    argv = ["--arch", arch, *SMALL, "--remat", "dots"]
    assert train.main([*argv, "--model-parallel", "2"]) == 0
    group = [line.split("] ", 1)[-1] for line in capfd.readouterr().err.splitlines()
             if "step=" in line]
    assert train.main(argv) == 0
    plain = [line.split("] ", 1)[-1] for line in capfd.readouterr().err.splitlines()
             if "step=" in line]
    assert [s.split(" tok_per_s")[0] for s in group] == [s.split(" tok_per_s")[0]
                                                         for s in plain]
    assert any("step=4" in s for s in group)


def test_run_model_parallel_reports_every_rank():
    args = train.build_parser().parse_args(["--arch", "llama3.2-1b", *SMALL,
                                            "--model-parallel", "2"])
    res = train.run(args, echo=False)
    assert len(res.by_rank) == 2
    for mine in res.by_rank:
        assert mine["losses"] == res.losses and mine["peak_bytes"] is None
        assert not any(mine["launches"].values())  # training takes the plain route
    shapes = param_shapes(reduced(get_config("llama3.2-1b")))
    assert sum(res.param_counts.values()) == sum(t.numel() for t in tree_leaves(shapes))


def test_snapshots_under_a_group_are_refused(tmp_path):
    """No longer refused: a model group's ``--ckpt-dir`` snapshot is the
    unsharded layout, which an unsharded run resumes, its losses within
    ``LM_RTOL`` of the group's straight run's."""
    argv = ["--arch", "llama3.2-1b", *SMALL, "--ckpt-every", "2"]
    group = train.run(train.build_parser().parse_args(
        [*argv, "--model-parallel", "2", "--ckpt-dir", str(tmp_path / "g")]), echo=False)
    (tmp_path / "u").mkdir()
    (tmp_path / "u" / "step_2.msgpack").write_bytes((tmp_path / "g" / "step_2.msgpack")
                                                    .read_bytes())
    res = train.run(train.build_parser().parse_args([*argv, "--ckpt-dir", str(tmp_path / "u")]),
                    echo=False)
    assert res.start_step == 2 and len(res.losses) == 2
    for a, b in zip(res.losses, group.losses[2:]):
        assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL)


def test_bad_model_parallel_flag_is_rejected():
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--model-parallel", "0"])
