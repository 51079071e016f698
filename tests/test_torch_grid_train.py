"""Training on a grid of data × model ranks (the reference's ``("data",
"model")`` mesh with FSDP storage over data) against the unsharded step,
in the port and, for reduced llama, in the reference.

The same numpy-seeded weights (``np_weights``) and batch of ``B`` rows go
into (a) the reference's ``build_train_step(...).fn`` (reduced llama, on a
one-device mesh of ``Auto`` axes, as tests/test_torch_train_group.py builds
it), (b) the port's unsharded ``build_train_step`` and (c) the port on 2 ×
1, 1 × 2, 2 × 2 and 4 × 1 grids of gloo ranks (``spawn_cohort(...,
device="cpu")``, one world a shape running every case): each rank takes
its FSDP share with ``grid_take`` and its data row's block of the batch,
and steps them with ``build_train_step(cfg, knobs, parallel)``.  Each case
takes two steps under two knob sets: one microbatch with ``remat="none"``,
and two microbatches with ``remat="dots"``.  Checked: every rank's params
and both AdamW moments against (b)'s share of them; the parts the model
group replicates bitwise equal along each model row and the leaves the
data group replicates bitwise equal down each data column; the same loss
and grad norm on every rank; and, for reduced llama, the grid's shares
joined (``join_shares(..., fsdp=, data=)``) against (a).

The MoE (reduced dbrx) routes each data rank's tokens at the capacity of
its own tokens, and averages each rank's load-balance loss over the data
group, as the reference's mesh does (ROADMAP queue C).  At a capacity where
nothing drops (``capacity_factor = E / k``), and with no load-balance loss
(a product of two means over the tokens, which a mean over shards does not
give), the grid is held to the unsharded step; at one where each data
shard drops tokens (``capacity_factor = 0.5``, the load-balance loss on) it
is held to the port's unsharded step that routes each data row's block on
its own (``microbatches`` = D times the grid's: each microbatch is one data
row's block, or a microbatch of it), and shown to differ from the
unsharded step over the whole batch.

Tolerances as tests/test_torch_train_group.py's: the loss and grad norm at
``LM_RTOL`` / ``LM_ATOL``, each leaf's update within ``UPDATE_REL_L2``
relative L2, each moment within ``GROUP_REL_L2``: the grid sums each
gradient over the data ranks (a reduce-scatter, an ``all_reduce``) in
another order than the unsharded step's one product over the batch.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh

import _torch_grid_ranks as ranks_mod
from _torch_parity import LM_ATOL, LM_RTOL, UPDATE_REL_L2, assert_close
from test_torch_model_parallel import np_weights, port_model_cfg
from test_torch_train_group import GROUP_REL_L2, rel_l2
from repro.configs.base import ShapeConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch.steps import Knobs as RefKnobs
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.optim.optimizers import adamw as ref_adamw
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import _keys, param_specs
from repro_torch.sharding.shard import (
    grid_take, init_params_sharded, join_shares, param_shapes, share_fsdp,
)
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

torch.set_num_threads(1)

B, S, S_SRC, STEPS, LR = 8, 12, 9, 2, 1e-3
GRIDS = ((2, 1), (1, 2), (2, 2), (4, 1))  # (data, model)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 120.0, 600.0
KNOBS = ({"microbatches": 1, "remat": "none"}, {"microbatches": 2, "remat": "dots"})
VARIANTS = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "llama-kv2": ("llama3.2-1b", {"n_kv_heads": 2}),
    "odd-heads": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3, "d_ff": 510}),
    "mamba2": ("mamba2-1.3b", {}),
    "zamba2-tail": ("zamba2-7b", {"n_layers": 3}),
    "seamless": ("seamless-m4t-large-v2", {}),
    # E / k: nothing drops; no load-balance loss, a product of two means
    "moe-no-drop": ("dbrx-132b", {"capacity_factor": 2.0, "load_balance_loss": 0.0}),
    "moe-drop": ("dbrx-132b", {"capacity_factor": 0.5}),
}
DROPS = ("moe-drop",)


@lru_cache(maxsize=None)
def _setup(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encoder_decoder:
        batch = {"src_embeds": rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32),
                 "tgt_tokens": toks, "labels": batch["labels"]}
    knobs = [dict(k, learning_rate=LR) for k in KNOBS]
    return rcfg, {"kind": "train", "cfg": cfg, "params": np_weights(cfg, 2), "batch": batch,
                  "steps": STEPS, "knobs": knobs}


@lru_cache(maxsize=None)
def unsharded(variant, per_shard: int = 1):
    """(b): the port's unsharded steps, through the ranks' own body; with
    ``per_shard`` = D each knob set's microbatches times D, so that each
    microbatch routes one data row's tokens as a grid of D rows does."""
    job = dict(_setup(variant)[1])
    job["knobs"] = [dict(k, microbatches=k["microbatches"] * per_shard) for k in job["knobs"]]
    return ranks_mod.train_case(job)


@lru_cache(maxsize=None)
def sharded(data, model):
    """(c): every variant on one world of ``data`` × ``model`` gloo ranks;
    per variant the ranks' results in rank order."""
    jobs = [_setup(v)[1] for v in VARIANTS]
    per_rank = spawn_cohort(ranks_mod.world, data * model, args=(data, model, jobs),
                            device="cpu", timeout_s=WORLD_TIMEOUT_S,
                            deadline_s=WORLD_DEADLINE_S)
    return {v: [per_rank[r][i] for r in range(data * model)] for i, v in enumerate(VARIANTS)}


CASES = [(v, g, k) for g in GRIDS for v in VARIANTS for k in range(len(KNOBS))]


def _ids(case):
    v, (d, m), k = case
    return f"{v}-{d}x{m}-{'M{microbatches}-{remat}'.format(**KNOBS[k])}"


def _leaf_keys(cfg):
    return [(_keys(p), tuple(t.shape)) for p, t in tree_flatten_with_path(param_shapes(cfg))[0]]


def _grid_share(cfg, a, keys, r, grid):
    data, model = grid
    return grid_take(torch.as_tensor(a), keys, cfg, r % model, model, r // model, data).numpy()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_ranks_fsdp_share_steps_as_the_unsharded_slice(case):
    variant, grid, k = case
    job = _setup(variant)[1]
    cfg = job["cfg"]
    want = unsharded(variant, grid[0] if variant in DROPS else 1)[k]
    start = tree_leaves(job["params"])
    for r, got in enumerate(sharded(*grid)[variant]):
        got = got[k]
        for (l, g), (lw, gw) in zip(got["metrics"], want["metrics"]):
            assert_close(l, lw, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} loss")
            assert_close(g, gw, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} grad norm")
        for i, (keys, _) in enumerate(_leaf_keys(cfg)):
            def mine(a):
                return _grid_share(cfg, a, keys, r, grid)

            p0 = mine(start[i])
            upd = rel_l2(got["params"][i] - p0, mine(want["params"][i]) - p0)
            assert upd <= UPDATE_REL_L2, (r, keys, "update", upd)
            for key in ("m", "v"):
                err = rel_l2(got[key][i], mine(want[key][i]))
                assert err <= GROUP_REL_L2, (r, keys, key, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_replicated_parts_loss_and_grad_norm_are_equal_on_every_rank(case):
    variant, (data, model), k = case
    ranks = [got[k] for got in sharded(data, model)[variant]]
    for r, got in enumerate(ranks):
        row, col = ranks[r - r % model], ranks[r % model]
        for tree, (dig_row, dig_col) in enumerate(got["digests"]):
            assert dig_row == row["digests"][tree][0], f"rank {r}: a model-replicated part"
            assert dig_col == col["digests"][tree][1], f"rank {r}: a data-replicated leaf"
        assert got["metrics"] == ranks[0]["metrics"], f"rank {r}"
        assert np.isfinite(got["metrics"]).all()


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] > 1], ids=lambda g: f"{g[0]}x{g[1]}")
def test_a_dropping_moe_on_the_grid_is_not_the_whole_batchs_step(grid):
    """Where each data shard's capacity drops tokens, the grid's step (held
    above to each shard's own routing) differs from the unsharded step
    over the whole batch by far more than the tolerance."""
    got = sharded(*grid)["moe-drop"][0][0]
    whole = unsharded("moe-drop")[0]
    assert abs(got["metrics"][0][0] - whole["metrics"][0][0]) > 100 * LM_ATOL


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] > 1], ids=lambda g: f"{g[0]}x{g[1]}")
def test_dots_recomputes_the_fsdp_gathers_and_none_keeps_them(grid):
    """Reduced llama (tied embeddings, 2 one-layer periods): a forward
    gathers the embedding and each period once, and each gather's backward
    is one reduce-scatter.  Under ``remat="none"`` nothing is gathered
    again; under ``"dots"`` each period's gather is redone in backward (its
    output is not among the products ``dots_policy`` keeps), the
    embedding's (outside the checkpointed periods) is not."""
    cfg = _setup("llama3.2-1b")[1]["cfg"]
    per_forward, periods = 1 + cfg.n_layers, cfg.n_layers
    none, dots = (sharded(*grid)["llama3.2-1b"][0][k]["counts"] for k in range(len(KNOBS)))
    forwards = [STEPS * kn["microbatches"] for kn in KNOBS]
    assert none["data_all_gather"] == none["data_reduce_scatter"] == forwards[0] * per_forward
    assert dots["data_reduce_scatter"] == forwards[1] * per_forward
    assert dots["data_all_gather"] == forwards[1] * (per_forward + periods)


# ------------------------------------------------------- against the reference
def _ref_step(rcfg, knobs):
    """tests/test_torch_train_group.py's ``_ref_step`` at this file's batch:
    the reference's step and AdamW on a one-device mesh of ``Auto`` axes."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))
    rk = RefKnobs(param_dtype="float32", **knobs)
    bundle = ref_build_train_step(rcfg, ShapeConfig("t", "train", seq_len=S, global_batch=B),
                                  mesh, rk)
    return ref_adamw(rk.learning_rate, moment_dtype=jnp.dtype(rk.moment_dtype)), bundle.fn, mesh


@lru_cache(maxsize=None)
def reference(k):
    """(a): two of the reference's steps from the same weights and batch."""
    rcfg, job = _setup("llama3.2-1b")
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


REF_CASES = [(g, k) for g in GRIDS for k in range(len(KNOBS))]


@pytest.mark.parametrize("grid,k", REF_CASES,
                         ids=[_ids(("llama3.2-1b", g, k)) for g, k in REF_CASES])
def test_joined_shares_match_the_references_train_step(grid, k):
    data, model = grid
    job = _setup("llama3.2-1b")[1]
    cfg = job["cfg"]
    ref = reference(k)
    ranks = [got[k] for got in sharded(data, model)["llama3.2-1b"]]
    for (l, g), (lr, gr) in zip(ranks[0]["metrics"], ref["metrics"]):
        assert_close(l, lr, rtol=LM_RTOL, atol=LM_ATOL, what="loss")
        assert_close(g, gr, rtol=LM_RTOL, atol=LM_ATOL, what="grad norm")
    start = tree_leaves(job["params"])
    specs = tree_leaves(param_specs(param_shapes(cfg), cfg, model))
    for i, (dim, f) in enumerate(zip(specs, share_fsdp(cfg, model, data))):
        def joined(key):
            return join_shares([torch.as_tensor(got[key][i]) for got in ranks], dim, model, f,
                               data).numpy()

        upd = rel_l2(joined("params") - start[i], ref["params"][i] - start[i])
        assert upd <= UPDATE_REL_L2, (i, "update", upd)
        for key in ("m", "v"):
            err = rel_l2(joined(key), ref[key][i])
            assert err <= GROUP_REL_L2, (i, key, err)


# ------------------------------------------------------------ the share draw
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("variant", ["llama3.2-1b", "mamba2", "seamless", "moe-drop"])
def test_an_fsdp_share_is_bitwise_its_slice_of_the_unsharded_draw(variant, grid):
    data, model = grid
    cfg = _setup(variant)[1]["cfg"]
    whole = build_model(cfg).init(torch.Generator().manual_seed(7))
    held = 0
    for r in range(data * model):
        share = init_params_sharded(torch.Generator().manual_seed(7), cfg, r % model, model,
                                    data=data, data_rank=r // model)
        for (keys, _), w, s in zip(_leaf_keys(cfg), tree_leaves(whole), tree_leaves(share)):
            want = grid_take(w, keys, cfg, r % model, model, r // model, data)
            assert torch.equal(s, want), (r, keys)
            held += s.numel()
    total = sum(t.numel() for t in tree_leaves(whole))
    assert held < data * model * total if data > 1 else held >= total


# ------------------------------------------------------------------ the CLI
SMALL = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16", "--log-every", "2",
         "--warmup", "2", "--seed", "3"]


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_cli_on_a_grid_logs_the_unsharded_losses(grid, capfd):
    """Rank 0's log (stderr) is the unsharded run's, row for row, within
    ``LM_RTOL``; every rank saw the same losses."""
    argv = ["--arch", "llama3.2-1b", *SMALL, "--remat", "dots"]
    args = train.build_parser().parse_args([*argv, "--data-parallel", str(grid[0]),
                                            "--model-parallel", str(grid[1])])
    res = train.run(args, echo=False)
    plain = train.run(train.build_parser().parse_args(argv), echo=False)
    assert len(res.by_rank) == grid[0] * grid[1]
    for a, b in zip(res.losses + res.grad_norms, plain.losses + plain.grad_norms):
        assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL)
    for mine in res.by_rank:
        assert mine["losses"] == res.losses and not any(mine["launches"].values())


def test_cli_refuses_a_batch_the_data_axis_does_not_divide():
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--batch", "3", "--data-parallel", "2"])
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--data-parallel", "0"])


def test_a_grids_context_gathers_only_the_leaves_the_rules_name():
    """``fsdp_gather`` takes which leaves are FSDP slices, and along which
    dimension, from ``ParallelContext.fsdp`` (``shard.fsdp_map``, the
    rules' ``fsdp_dim``), and refuses a grid's context that lacks the map;
    the map names a leaf's dimension counted from the last, the same in a
    stacked leaf and in one period's slice of it."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.layers import ParallelContext, fsdp_gather
    from repro_torch.sharding.shard import fsdp_map

    bare = ParallelContext(None, 0, 2, None, 0, 2)
    with pytest.raises(ValueError, match="FSDP"):
        fsdp_gather({"embed": torch.zeros(4, 2)}, bare)
    cfg = reduced(get_config("llama3.2-1b"))
    whole = {_keys(p): tuple(t.shape) for p, t in tree_flatten_with_path(param_shapes(cfg))[0]}
    fm = fsdp_map(cfg, 2, 2)
    assert set(fm) == {k for k, f in zip(whole, share_fsdp(cfg, 2, 2)) if f is not None}
    for keys, d in fm.items():
        assert len(whole[keys]) + d == [f for k, f in zip(whole, share_fsdp(cfg, 2, 2))
                                        if k == keys][0]
    assert fm[("embed",)] == -1 and fm[("periods", "slot0", "attn", "wq")] == -3
    assert fsdp_map(cfg, 2, 1) == {}
