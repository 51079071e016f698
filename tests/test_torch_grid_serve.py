"""Serving on a grid of data × model ranks (the reference's ``batch_specs`` /
``cache_specs`` on a ``("data", "model")`` mesh) against the unsharded
model, in the port and, for reduced llama and zamba2, in the reference.

The same numpy-seeded weights (``np_weights``) go into (a) the reference's
unsharded ``apply`` and ``decode_step`` (llama and zamba2 with a tail
layer), (b) the port's unsharded model and (c) the port on 2 × 1, 1 × 2,
2 × 2 and 4 × 1 grids of gloo ranks (``spawn_cohort(..., device="cpu")``,
a world of 2 ranks for the first two and one of 4 for the others; rank bodies in
tests/_torch_serve_ranks.py).  Each case prefills ``S`` tokens into a cache
of ``CACHE`` positions and decodes ``STEPS`` tokens teacher-forced (the
encoder-decoder: encodes ``S_SRC`` frames and decodes from BOS).  Batches
of 1 and 3 rows do not split over 2 or 4 data ranks, so every rank serves
every row and holds a slab of each attention cache's sequence: the prompt
spans several slabs and decode crosses a slab boundary; a short case
decodes where one slab alone holds valid positions, and starcoder2's
window (8) leaves the first slab with none.  A batch of 4 rows splits:
each data row serves its block, and the oracle is the unsharded model on
that block alone (a MoE routes each row's tokens at its own capacity,
which with ``capacity_factor`` 0.5 drops other tokens than the whole
batch's).  Checked: every step's logits at ``LM_RTOL`` / ``LM_ATOL``, and
bitwise equal on every rank that serves the same rows; each rank's cache
after the prefill and after the last step as its part of the unsharded
cache (its kv heads or SSD heads, then its rows or its slab); the token's
K/V written on exactly one data rank of a split sequence; the data
group's ``all_reduce``s a decode step (three an attention, none where the
batch splits); a 1 × 2 grid bitwise the model group; both
``serve_params`` layouts, with their share bytes and gathers.  The CLI
(``--data-parallel 2 --model-parallel 2``, ``--shape``, ``--ckpt
--follow``) is run end to end.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_serve_ranks as ranks_mod
from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from test_torch_model_parallel import _ref_merge, np_weights, port_model_cfg
from test_torch_model_parallel_ssm import _rank_part
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch.dryrun import LONG_OK as REF_LONG_OK
from repro.launch.dryrun import skip_reason as ref_skip_reason
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.convert import params_from_numpy
from repro_torch.fleet.publisher import ModelPublisher
from repro_torch.launch import serve
from repro_torch.launch.dryrun import LONG_OK
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.launch.steps import Knobs, param_mode
from repro_torch.models.layers import ParallelContext
from repro_torch.models.model import build_model
from repro_torch.models.transformer import period_layout
from repro_torch.sharding.rules import _keys, row_block, seq_slab
from repro_torch.sharding.shard import (
    fsdp_map, grid_take, init_params_sharded, param_shapes, share_bytes, share_fsdp,
)
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

torch.set_num_threads(1)

S, STEPS, CACHE, S_SRC = 11, 5, 16, 8  # decode at positions 11 … 15 of 16
SHORT = (2, 2)  # prompt, steps: decode at 2 and 3, inside the first slab of 4
GRIDS = ((2, 1), (1, 2), (2, 2), (4, 1))  # (data, model)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 120.0, 600.0
VARIANTS = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "starcoder2": ("starcoder2-7b", {}),  # reduced: a window of 8 on every layer
    "zamba2-tail": ("zamba2-7b", {"n_layers": 3}),
    "mamba2": ("mamba2-1.3b", {}),
    "moe-no-drop": ("dbrx-132b", {"capacity_factor": 2.0}),
    "moe-drop": ("dbrx-132b", {"capacity_factor": 0.5}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
# (variant, batch, tag): "fsdp" / "replicated" the serve_params layout,
# "short" the fsdp layout with SHORT's prompt and steps
KEYS = ([(v, b, "fsdp") for v in VARIANTS for b in (1, 4)]
        + [(v, 3, "fsdp") for v in ("llama3.2-1b", "zamba2-tail", "seamless")]
        + [("llama3.2-1b", 1, "short"), ("llama3.2-1b", 4, "replicated"),
           ("moe-no-drop", 4, "replicated"), ("zamba2-tail", 1, "replicated")])
REFERENCED = ("llama3.2-1b", "zamba2-tail")


@lru_cache(maxsize=None)
def _variant(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    rng = np.random.default_rng(4)
    data = {"tokens": rng.integers(0, cfg.vocab_size, size=(4, S + STEPS))}
    if cfg.is_encoder_decoder:
        data = {"src": rng.normal(size=(4, S_SRC, cfg.d_model)).astype(np.float32),
                "tgt": rng.integers(0, cfg.vocab_size, size=(4, STEPS - 1))}
    return rcfg, cfg, np_weights(cfg, 3), data


@lru_cache(maxsize=None)
def _job(key):
    variant, batch, tag = key
    _, cfg, params, data = _variant(variant)
    prompt, steps = SHORT if tag == "short" else (S, STEPS)
    return {"cfg": cfg, "params": params, "batch": batch, "prompt": prompt, "steps": steps,
            "cache_len": CACHE,
            "knobs": Knobs(serve_params="replicated" if tag == "replicated" else "fsdp"),
            **{k: v[:batch] for k, v in data.items()}}


SMALL = ["--device", "cpu", "--prompt-len", "12", "--gen", "6", "--seed", "3"]
GRID = ["--data-parallel", "2", "--model-parallel", "2"]


def _follow_jobs(root):
    """``serve --ckpt DIR --follow`` of reduced llama on a 2 × 2 grid and
    unsharded, each from its own directory holding version 1; version 2 is
    published after decode step 3."""
    cfg = reduced(get_config("llama3.2-1b"))
    first, later = np_weights(cfg, 11), np_weights(cfg, 12)
    jobs = []
    for name in ("grid", "plain"):
        d = root / name
        ModelPublisher(str(d), retain=2).publish(params_from_numpy(first), step=1)
        argv = ["--arch", "llama3.2-1b", *SMALL, "--batch", "4", "--ckpt", str(d), "--follow"]
        jobs.append({"argv": argv + (GRID if name == "grid" else []), "dir": str(d),
                     "later": later, "publish_after": 3})
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(c): every case on a world of 2 gloo ranks (2 × 1, then 1 × 2) and
    on one of 4 (2 × 2, then 4 × 1, then the follow case on 2 × 2): per
    grid and case the ranks' results in rank order; the follow case's
    ranks' and the unsharded server's."""
    jobs = [_job(k) for k in KEYS]
    follow = _follow_jobs(tmp_path_factory.mktemp("follow"))
    out = {}
    for n, grids, extra in ((2, GRIDS[:2], None), (4, GRIDS[2:], follow[0])):
        per_rank = spawn_cohort(ranks_mod.grid_world, n, args=(grids, jobs, extra),
                                device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                deadline_s=WORLD_DEADLINE_S)
        for g in grids:
            out[g] = {k: [per_rank[r][g][i] for r in range(n)] for i, k in enumerate(KEYS)}
        if extra is not None:
            out["follow"] = [per_rank[r]["follow"] for r in range(n)]
    out["follow_plain"] = ranks_mod.follow_case(follow[1])
    return out


def _splits_batch(batch, data):
    return data > 1 and batch % data == 0


def _rows(batch, data, d):
    """The rows data rank ``d`` serves: its block, or all of them."""
    if _splits_batch(batch, data):
        lo, n = row_block(batch, data, d)
        return lo, n
    return 0, batch


@lru_cache(maxsize=None)
def unsharded(key, lo, n):
    """(b): the port's unsharded model on rows ``[lo, lo + n)``, through the
    ranks' own body."""
    return ranks_mod.serve_grid_case(_job(key), rows=slice(lo, lo + n))


@lru_cache(maxsize=None)
def reference(variant):
    """(a): the reference's unsharded prefill of the four rows and their
    teacher-forced decode steps against a cache of ``CACHE`` positions."""
    rcfg, _, params, data = _variant(variant)
    rmodel = ref_build_model(rcfg)
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    toks = jnp.asarray(data["tokens"], jnp.int32)
    logits, rcache, _ = rmodel.apply(rparams, toks[:, :S], return_cache=True)
    cache = jax.tree_util.tree_map(_ref_merge, rmodel.init_cache(rparams, 4, CACHE), rcache)
    out = {"prefill": np.asarray(logits), "decode": []}
    step = jax.jit(rmodel.decode_step)
    for i in range(S, S + STEPS):
        lg, cache = step(rparams, toks[:, i:i + 1], cache, jnp.int32(i))
        out["decode"].append(np.asarray(lg))
    return out


CASES = [(g, k) for g in GRIDS for k in KEYS]


def _ids(case):
    (d, m), (v, b, tag) = case
    return f"{v}-B{b}-{tag}-{d}x{m}"


def _want(case, r):
    (data, model), key = case
    lo, n = _rows(key[1], data, r // model)
    return unsharded(key, lo, n)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_logits_match_the_unsharded_model_on_the_rows_each_rank_serves(case, worlds):
    (data, model), key = case
    ranks = worlds[(data, model)][key]
    for r, got in enumerate(ranks):
        want = _want(case, r)
        assert_close(got["prefill"], want["prefill"], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"rank {r} prefill")
        assert len(got["decode"]) == len(want["decode"]) == _job(key)["steps"]
        for i, (a, b) in enumerate(zip(got["decode"], want["decode"])):
            assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} decode {i}")
        # the ranks serving the same rows feed the next layer the same values
        same = ranks[(r // model) * model] if _splits_batch(key[1], data) else ranks[0]
        for a, b in zip([got["prefill"], *got["decode"]], [same["prefill"], *same["decode"]]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")


REF_CASES = [(g, k) for g in GRIDS for k in KEYS if k[0] in REFERENCED and k[2] != "short"]


@pytest.mark.parametrize("case", REF_CASES, ids=_ids)
def test_logits_match_the_references_unsharded_decode_step(case, worlds):
    (data, model), key = case
    ref = reference(key[0])
    for r, got in enumerate(worlds[(data, model)][key]):
        lo, n = _rows(key[1], data, r // model)
        assert_close(got["prefill"], ref["prefill"][lo:lo + n], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"rank {r} prefill vs reference")
        for i, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
            assert_close(a, b[lo:lo + n], rtol=LM_RTOL, atol=LM_ATOL,
                         what=f"rank {r} decode {i} vs reference")


def _part(key, leaf, cfg, case, r):
    """Rank ``r``'s part of the unsharded cache leaf ``key`` of its rows:
    its model rank's heads, then, where the sequence splits, its slab."""
    (data, model), (_, batch, _) = case
    part = _rank_part(key, leaf, cfg, r % model, model)
    if key in ("k", "v", "cross_k", "cross_v") and data > 1 and batch % data:
        lo, n = seq_slab(part.shape[2], data, r // model)
        part = part[:, :, lo:lo + n]
    return part


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_ranks_cache_is_its_part_of_the_unsharded_cache(case, worlds):
    (data, model), key = case
    cfg = _job(key)["cfg"]
    for r, got in enumerate(worlds[(data, model)][key]):
        want = _want(case, r)
        assert got["cache_keys"] == want["cache_keys"]
        for when in ("cache_prefill", "cache"):
            for name, a, b in zip(got["cache_keys"], got[when], want[when]):
                part = _part(name, b, cfg, case, r)
                assert a.shape == part.shape, (r, when, name)
                assert_close(a, part, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} {when} {name}")


def _attention_applications(cfg):
    """Attention applications a decode step: the decoder-only's attention
    slots; the encoder-decoder's self- and cross-attention a layer."""
    if cfg.is_encoder_decoder:
        return 2 * cfg.n_layers
    slots, n_periods, tail = period_layout(cfg)
    return [s.kind for s in slots].count("attn") * n_periods


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_token_is_written_on_one_data_rank_and_the_slabs_combine_in_three_all_reduces(
        case, worlds):
    """Where the sequence splits, each decode step writes the token's K/V
    on exactly the data rank whose slab holds its position (and on no
    other) and runs three ``all_reduce``s over the data group an attention
    application; elsewhere every rank writes its rows' and runs none."""
    (data, model), key = case
    job = _job(key)
    cfg = job["cfg"]
    ranks = worlds[(data, model)][key]
    split_seq = data > 1 and key[1] % data
    first = 0 if cfg.is_encoder_decoder else job["prompt"]
    n_attn = _attention_applications(cfg)
    for r, got in enumerate(ranks):
        assert got["step_data_all_reduce"] == [3 * n_attn if split_seq else 0] * job["steps"]
    if not n_attn:
        assert all(w is None for got in ranks for w in got["written"])
        return
    for i in range(job["steps"]):
        for m in range(model):
            writers = [d for d in range(data) if ranks[d * model + m]["written"][i]]
            if split_seq:
                assert writers == [(first + i) // (CACHE // data)], (i, m, writers)
            else:
                assert writers == list(range(data)), (i, m, writers)


def _valid_slabs(pos, window, data):
    """The data ranks whose slab of ``CACHE`` holds a position a query at
    ``pos`` sees."""
    n = CACHE // data
    lo = 0 if window is None else max(0, pos - window + 1)
    return sorted({p // n for p in range(lo, pos + 1)})


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] > 1], ids=lambda g: f"{g[0]}x{g[1]}")
def test_steps_with_one_valid_slab_and_a_window_that_empties_one_are_served(grid, worlds):
    """The short case decodes where the first slab alone holds valid
    positions; starcoder2's window leaves the first slab empty at the last
    steps.  Every slab without a valid position adds nothing: the logits
    are the unsharded model's."""
    data, model = grid
    short = [2 + i for i in range(SHORT[1])]
    assert all(_valid_slabs(p, None, data) == [0] for p in short)
    window = _job(("starcoder2", 1, "fsdp"))["cfg"].sliding_window
    empties = [i for i in range(STEPS) if 0 not in _valid_slabs(S + i, window, data)]
    assert empties, "no step whose window leaves the first slab empty"
    for key, steps in ((("llama3.2-1b", 1, "short"), range(SHORT[1])),
                       (("starcoder2", 1, "fsdp"), empties)):
        want = unsharded(key, 0, 1)
        for r, got in enumerate(worlds[grid][key]):
            for i in steps:
                out = got["decode"][i]
                assert np.isfinite(out).all()
                assert_close(out, want["decode"][i], rtol=LM_RTOL, atol=LM_ATOL,
                             what=f"rank {r} step {i}")


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}-B{k[1]}-{k[2]}")
def test_a_one_row_grid_is_the_model_group_bitwise(key, worlds):
    """On 1 × 2 the grid's serving context gives bitwise what the model
    group of the world gives (the path of a model group before grids)."""
    for r, got in enumerate(worlds[(1, 2)][key]):
        group = got["group"]
        for name in ("prefill", "decode", "cache_prefill", "cache"):
            a = got[name] if isinstance(got[name], list) else [got[name]]
            b = group[name] if isinstance(group[name], list) else [group[name]]
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] > 1], ids=lambda g: f"{g[0]}x{g[1]}")
def test_serve_params_replicated_gathers_only_the_expert_banks(grid, worlds):
    """In the fsdp layout every large leaf is gathered over the data group;
    in the replicated one only the leaves under ``moe``: llama gathers
    nothing over data, dbrx its expert banks and routers."""
    data, model = grid
    counts = {k: worlds[grid][k][0]["counts"] for k in KEYS}
    assert counts[("llama3.2-1b", 4, "fsdp")]["data_all_gather"] > 0
    assert counts[("llama3.2-1b", 4, "replicated")]["data_all_gather"] == 0
    assert counts[("zamba2-tail", 1, "replicated")]["data_all_gather"] == 0
    assert counts[("moe-no-drop", 4, "replicated")]["data_all_gather"] > 0


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("variant", ["llama3.2-1b", "moe-drop", "zamba2-tail", "seamless"])
def test_each_layouts_share_is_bitwise_its_slice_of_the_unsharded_draw(variant, grid):
    """``init_params_sharded(..., mode=)`` in both layouts: each share is
    bitwise its slice of the unsharded draw, and its bytes are
    ``share_bytes``; the replicated layout slices only ``moe`` leaves over
    data."""
    data, model = grid
    cfg = _job((variant, 4, "fsdp"))["cfg"]
    whole = build_model(cfg).init(torch.Generator().manual_seed(7))
    keys = [_keys(p) for p, _ in tree_flatten_with_path(param_shapes(cfg))[0]]
    for mode in ("train", "serve"):
        for r in range(data * model):
            share = init_params_sharded(torch.Generator().manual_seed(7), cfg, r % model, model,
                                        data=data, data_rank=r // model, mode=mode)
            held = 0
            for k, w, s in zip(keys, tree_leaves(whole), tree_leaves(share)):
                want = grid_take(w, k, cfg, r % model, model, r // model, data, mode=mode)
                assert torch.equal(s, want), (mode, r, k)
                held += s.numel() * s.element_size()
            assert held == share_bytes(cfg, model, data, mode), (mode, r)
        sliced = [k for k, f in zip(keys, share_fsdp(cfg, model, data, mode)) if f is not None]
        if mode == "serve":
            assert all("moe" in k for k in sliced), sliced
            assert bool(sliced) == (variant.startswith("moe") and data > 1)
    if data > 1:  # the replicated layout holds less than the model share only with experts
        assert share_bytes(cfg, model, data, "train") < share_bytes(cfg, model, data, "serve")
        assert (share_bytes(cfg, model, data, "serve") < share_bytes(cfg, model, 1)) == \
            variant.startswith("moe")


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_a_dropping_moe_split_over_data_is_not_the_whole_batchs_model(grid, worlds):
    """With ``capacity_factor`` 0.5 each data row's block drops other
    tokens than the whole batch does, so the grid is held (above) to the
    unsharded model on each block alone, and differs from the whole
    batch's by far more than the tolerance."""
    data, model = grid
    key = ("moe-drop", 4, "fsdp")
    whole = unsharded(key, 0, 4)
    lo, n = row_block(4, data, data - 1)  # the last block: late in the whole batch's queues
    got = worlds[grid][key][(data - 1) * model]
    assert np.abs(got["prefill"] - whole["prefill"][lo:lo + n]).max() > 100 * LM_ATOL


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("arch,batch", [("llama3.2-1b", "4"), ("zamba2-7b", "1")])
def test_cli_on_a_2x2_grid_serves_the_unsharded_tokens(arch, batch):
    """Rows split over the data ranks (B 4), and the caches' sequence (B 1,
    a 20-deep cache in two slabs): every rank reports the unsharded
    server's tokens for the whole batch."""
    argv = ["--arch", arch, *SMALL, "--batch", batch, "--cache-len", "20"]
    plain = serve.run(serve.build_parser().parse_args(argv))
    argv += GRID
    ranks = serve.run_model_parallel(serve.build_parser().parse_args(argv), argv)
    assert len(ranks) == 4
    for r, res in enumerate(ranks):
        assert res.tokens.shape == plain.tokens.shape == (int(batch), 6)
        np.testing.assert_array_equal(res.tokens, plain.tokens, err_msg=f"rank {r}")
        assert res.finite


def test_the_shape_flag_takes_the_batch_and_the_cache_and_gates_long_500k(capfd):
    """``--shape decode_32k`` takes B 128 and a 32,768-deep cache;
    ``--shape long_500k`` is the ``LONG_OK`` archs' (the reference's set),
    and another arch is refused with the reference's reason."""
    assert LONG_OK == REF_LONG_OK
    shaped = serve.with_shape(serve.build_parser().parse_args(["--shape", "decode_32k"]))
    assert (shaped.batch, shaped.cache_len) == (128, 32768)
    for arch in LONG_OK:
        shaped = serve.with_shape(serve.build_parser().parse_args(
            ["--arch", arch, "--shape", "long_500k"]))
        assert (shaped.batch, shaped.cache_len) == (1, 524288)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama3.2-1b", "--device", "cpu", "--shape", "long_500k"])
    assert ref_skip_reason("llama3.2-1b", "long_500k") in capfd.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--batch", "3", "--data-parallel", "2", "--cache-len", "65"], "does not split"),
    (["--arch", "seamless-m4t-large-v2", "--batch", "3", "--prompt-len", "9",
      "--data-parallel", "2"], "source length"),
    (["--gen", "40", "--cache-len", "50"], "shorter"),
    (["--data-parallel", "0"], "data-parallel"),
])
def test_cli_refuses_what_the_grid_does_not_split(argv, match, capfd):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", *argv])
    assert match in capfd.readouterr().err


@pytest.mark.parametrize("serve_params,mode", [("fsdp", "train"), ("replicated", "serve")])
def test_the_serve_params_flag_sets_the_knobs_layout(serve_params, mode):
    """``--serve-params`` builds the step knobs (``serve.serve_knobs``),
    and the knobs name the layout: ``param_mode`` reads
    ``Knobs.serve_params``, whose default is the reference's "fsdp"."""
    args = serve.build_parser().parse_args(["--serve-params", serve_params])
    assert serve.serve_knobs(args) == Knobs(serve_params=serve_params)
    assert param_mode(serve.serve_knobs(args)) == mode
    assert param_mode(Knobs()) == "train"
    with pytest.raises(ValueError, match="serve_params must be one of"):
        param_mode(Knobs(serve_params="sharded"))


@pytest.mark.parametrize("serve_params,held", [("fsdp", "serve"), ("replicated", "train")])
def test_a_grid_context_of_another_layout_than_the_flags_is_refused(serve_params, held):
    """``serve.run`` on a grid's context whose FSDP leaves are another
    layout's than ``--serve-params`` names raises before it draws a weight."""
    cfg = _job(("moe-no-drop", 4, "fsdp"))["cfg"]
    ctx = ParallelContext(None, 0, 2, None, 0, 2, fsdp=fsdp_map(cfg, 2, 2, held))
    args = serve.build_parser().parse_args([*SMALL, "--batch", "4", "--serve-params",
                                            serve_params])
    with pytest.raises(ValueError, match="another layout"):
        serve.run(args, cfg=cfg, parallel=ctx)


def test_a_cache_the_data_group_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="equal slabs"):
        seq_slab(10, 4, 0)
    assert [seq_slab(16, 4, d) for d in range(4)] == [(0, 4), (4, 4), (8, 4), (12, 4)]


def test_follow_on_a_2x2_grid_swaps_every_rank_at_one_step(worlds):
    """``serve --ckpt DIR --follow`` on 2 × 2: the watch spans the world, so
    all four ranks swap to version 2 at the step the unsharded server
    does, and every rank's tokens are its."""
    plain = worlds["follow_plain"]
    assert (plain["swap_steps"], plain["versions"]) == ([3], [2])
    for r, got in enumerate(worlds["follow"]):
        assert (got["swap_steps"], got["versions"]) == ([3], [2]), r
        np.testing.assert_array_equal(got["tokens"], plain["tokens"], err_msg=f"rank {r}")
