"""The model group (the reference's ``"model"``-axis branches) against the
unsharded model, in the port and in the reference.

The same numpy-seeded weights (``np_weights``: the port's tree of shapes
filled from ``default_rng``) go into (a) the reference's unsharded ``model.apply`` / ``decode_step``,
(b) the port's unsharded model and (c) the port on 2 and 4 gloo ranks
(``spawn_cohort(..., device="cpu")``; each rank slices its share with
``shard_params``).  Each prefills one batch and decodes greedily; the
prefill logits and every decode step's logits of (c) are held to (b) and
to (a) at ``LM_RTOL`` / ``LM_ATOL`` (tests/_torch_parity.py: the
tolerance of every LM test of the port; ``ATOL`` 1e-6 is below the f32
rounding of O(1) logits whose layer sums the group adds in another order,
measured up to 1.3e-6 between (c) and (b)), the greedy tokens are equal across all three and across ranks, no MoE
route differs between (c) and (b), and each rank's decode cache is its
heads of (b)'s.  The reduced configs of seven archs run in f32, plus
llama variants whose ``n_kv_heads`` the group does not divide (``wk`` /
``wv`` kept whole: kv heads picked, or repeated a q head at a time), one
whose heads and hidden layer four ranks do not divide (those layers run
whole on every rank), and one with a ragged vocabulary.  The reference
runs its plain attention route (``use_kernels`` off), the oracle of the
unsharded model's values; the kernels' own parity is tests/test_torch_lm.py.
"""
from dataclasses import fields, replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_model_ranks as ranks_mod
from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.fleet.publisher import ModelPublisher
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.launch import serve
from repro_torch.models.layers import ParallelContext, kv_heads_of
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_params
from repro_torch.sharding.rules import _keys, param_specs
from repro_torch.sharding.shard import init_params_sharded, param_shapes, shard_params
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_unflatten

torch.set_num_threads(1)

B, S, STEPS = 2, 13, 4
WORLDS = (2, 4)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 60.0, 240.0
VARIANTS = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "qwen3": ("qwen3-14b", {}),
    "gemma3": ("gemma3-12b", {}),
    "starcoder2": ("starcoder2-7b", {}),
    "chameleon": ("chameleon-34b", {}),
    "maverick": ("llama4-maverick-400b-a17b", {}),
    "dbrx": ("dbrx-132b", {}),
    # n_kv_heads 2: four ranks keep wk / wv whole and pick kv head 0 or 1
    "llama-kv2": ("llama3.2-1b", {"n_kv_heads": 2}),
    # 6 / 3 heads: two ranks' q heads read kv heads (0, 0, 1) and (1, 2, 2),
    # repeated a q head at a time; four ranks do not divide 6 heads or
    # d_ff 510, so attention and the MLP run whole on every rank
    "odd-heads": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3, "d_ff": 510}),
    # vocab 500 pads to 512 rows: the pad rows are split like the others
    "ragged-vocab": ("qwen3-14b", {"vocab_size": 500}),
}


def port_model_cfg(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's values."""
    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name) for f in fields(ref_cfg)
                          if f.name in names})


def _ref_merge(dst, src):
    """The reference serve's prefill-cache merge (``repro.launch.serve``)."""
    if dst.ndim >= 3 and src.ndim == dst.ndim and dst.shape[2] >= src.shape[2] \
            and dst.shape[:2] == src.shape[:2]:
        return jax.lax.dynamic_update_slice(dst, src.astype(dst.dtype), (0,) * dst.ndim)
    return src.astype(dst.dtype)


def np_weights(cfg, seed: int):
    """A numpy params tree in the reference's layout (the port's, leaf for
    leaf), scaled as the reference's init scales it: the embeddings
    N(0, 0.02²), every matrix N(0, 1/fan_in) with fan_in its input width
    (D for ``wq`` / ``wk`` / ``wv``, H·hd for ``wo``), and the norms'
    (scale − 1), zeros there, N(0, 0.1²) here."""
    rng = np.random.default_rng(seed)

    def leaf(path, t):
        key = path[-1]
        if key in ("embed", "unembed"):
            std = 0.02
        elif "norm" in key:
            std = 0.1
        elif key in ("wq", "wk", "wv"):
            std = t.shape[-3] ** -0.5
        elif key == "wo":
            std = (t.shape[-3] * t.shape[-2]) ** -0.5
        else:  # (…, in, out): the MLPs, the expert banks, the router
            std = t.shape[-2] ** -0.5
        return (std * rng.normal(size=tuple(t.shape))).astype(np.float32)

    flat, treedef = tree_flatten_with_path(param_shapes(cfg))
    return tree_unflatten(treedef, [leaf(_keys(p), t) for p, t in flat])


@lru_cache(maxsize=None)
def _setup(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, size=(B, S))
    job = {"cfg": cfg, "params": np_weights(cfg, 1), "tokens": toks, "steps": STEPS}
    return rcfg, ref_build_model(rcfg), jax.tree_util.tree_map(jnp.asarray, job["params"]), job


@lru_cache(maxsize=None)
def reference(variant):
    """(a): the reference's unsharded prefill and greedy decode."""
    _, rmodel, rparams, job = _setup(variant)
    logits, rcache, _ = rmodel.apply(rparams, jnp.asarray(job["tokens"], jnp.int32),
                                     return_cache=True)
    cache = jax.tree_util.tree_map(_ref_merge, rmodel.init_cache(rparams, B, S + STEPS), rcache)
    out = {"prefill": np.asarray(logits), "decode": []}
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tokens = [tok]
    decode_step = jax.jit(rmodel.decode_step)
    for i in range(STEPS):
        lg, cache = decode_step(rparams, tok, cache, jnp.int32(S + i))
        out["decode"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tokens.append(tok)
    out["tokens"] = np.asarray(jnp.concatenate(tokens, axis=1))
    return out


@lru_cache(maxsize=None)
def unsharded(variant):
    """(b): the port's unsharded model, through the ranks' own body."""
    return ranks_mod.serve_case(_setup(variant)[3])


@lru_cache(maxsize=None)
def sharded(n):
    """(c): every variant on one world of ``n`` gloo ranks; per variant the
    ranks' results in rank order."""
    jobs = [_setup(v)[3] for v in VARIANTS]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {v: [per_rank[r][i] for r in range(n)] for i, v in enumerate(VARIANTS)}


CASES = [(v, n) for n in WORLDS for v in VARIANTS]


def _ids(case):
    return f"{case[0]}-{case[1]}ranks"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_logits_match_the_unsharded_model(case):
    variant, n = case
    got, want, ref = sharded(n)[variant][0], unsharded(variant), reference(variant)
    assert_close(got["prefill"], want["prefill"], rtol=LM_RTOL, atol=LM_ATOL,
                 what="prefill vs port")
    assert_close(got["prefill"], ref["prefill"], rtol=LM_RTOL, atol=LM_ATOL,
                 what="prefill vs reference")
    for i in range(STEPS):
        assert_close(got["decode"][i], want["decode"][i], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"decode {i} vs port")
        assert_close(got["decode"][i], ref["decode"][i], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"decode {i} vs reference")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_greedy_tokens_and_routes_equal_on_every_rank(case):
    variant, n = case
    want, ref = unsharded(variant), reference(variant)
    np.testing.assert_array_equal(want["tokens"], ref["tokens"])
    np.testing.assert_array_equal(want["step_tokens"], want["tokens"])
    for r, got in enumerate(sharded(n)[variant]):
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["step_tokens"], want["tokens"], err_msg=f"rank {r}")
        assert len(got["routes"]) == len(want["routes"])
        for a, b in zip(got["routes"], want["routes"]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}: an MoE route differs")
    if _setup(variant)[0].n_experts:
        assert want["routes"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_caches_the_kv_heads_its_q_heads_read(case):
    """Rank r's decode cache is (b)'s at the kv heads ``kv_heads_of`` names:
    its block of ``n_kv_heads / N``, the heads its q heads read, or all."""
    variant, n = case
    cfg = _setup(variant)[3]["cfg"]
    want = unsharded(variant)["cache"]
    for r, got in enumerate(sharded(n)[variant]):
        heads = kv_heads_of(cfg, ParallelContext(None, r, n))
        assert len(got["cache"]) == len(want)
        for a, b in zip(got["cache"], want):
            assert a.shape[-2] == len(heads)
            assert_close(a, b[..., heads, :], rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} cache")


def _collectives(cfg, n):
    """(all_reduce, all_gather) calls of one forward on ``n`` ranks: the
    embedding's and the logits' when the vocabulary splits, one a layer for
    attention whose heads split, and for an MLP whose hidden layer splits;
    an MoE layer two (its output and aux) plus its shared expert's."""
    vocab = -(-cfg.vocab_size // 256) * 256 % n == 0
    heads = cfg.n_heads % n == 0
    ff = cfg.d_ff % n == 0
    reduce = int(vocab)
    for layer in range(cfg.n_layers):
        moe = cfg.n_experts and (layer + 1) % cfg.moe_every == 0
        reduce += int(heads) + (2 + int(cfg.shared_expert and ff) if moe else int(ff))
    return reduce, int(vocab)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_collective_counts_per_forward(case):
    variant, n = case
    cfg = _setup(variant)[3]["cfg"]
    reduce, gather = _collectives(cfg, n)
    forwards = 1 + STEPS
    for got in sharded(n)[variant]:
        assert got["counts"]["all_reduce"] == forwards * reduce
        assert got["counts"]["all_gather"] == forwards * gather


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_sharded_is_each_ranks_slice_of_the_unsharded_draw(variant, n):
    cfg = _setup(variant)[3]["cfg"]
    whole = init_params(torch.Generator().manual_seed(11), cfg)
    specs = param_specs(whole, cfg, n)
    for r in range(n):
        share = init_params_sharded(torch.Generator().manual_seed(11), cfg, r, n)
        want = shard_params(whole, specs, r, n)
        for a, b in zip(tree_leaves(share), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_params_sharded_through_a_stage_device_is_the_same_share():
    cfg = _setup("dbrx")[3]["cfg"]
    whole = init_params(torch.Generator().manual_seed(3), cfg)
    want = shard_params(whole, param_specs(whole, cfg, 4), 1, 4)
    got = init_params_sharded(torch.Generator().manual_seed(3), cfg, 1, 4, stage="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("flags", [["--ckpt", "{pub}"], ["--ckpt", "{pub}", "--follow"]])
def test_published_params_under_a_group_are_refused(flags, tmp_path):
    """No longer refused: a model group of 2 serves published params (each
    rank its share of the version; ``--follow`` through the group's watch),
    and its tokens are the unsharded server's."""
    cfg = reduced(get_config("llama3.2-1b"))
    ModelPublisher(str(tmp_path), retain=2).publish(
        build_model(cfg).init(torch.Generator().manual_seed(4)), step=1)
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            *[f.format(pub=tmp_path) for f in flags]]
    one = serve.run(serve.build_parser().parse_args(argv))
    argv += ["--model-parallel", "2"]
    for res in serve.run_model_parallel(serve.build_parser().parse_args(argv), argv):
        np.testing.assert_array_equal(res.tokens, one.tokens)
        assert res.stats.served_version == 1


SMALL = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "6", "--seed", "3"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b"])
def test_cli_on_two_ranks_serves_the_unsharded_tokens(arch, capfd):
    argv = ["--arch", arch, *SMALL, "--model-parallel", "2"]
    assert serve.main(argv) == 0
    lines = capfd.readouterr().out.splitlines()
    assert serve.main(["--arch", arch, *SMALL]) == 0
    plain = capfd.readouterr().out.splitlines()
    assert lines[0] == plain[0] and lines[0].startswith(f"arch={arch}-reduced")
    assert lines[-3:] == plain[-3:]  # "sample generations" and the two rows


def test_model_parallel_one_is_todays_path():
    argv = ["--arch", "qwen3-14b", *SMALL, "--temperature", "0.8"]
    res = serve.run(serve.build_parser().parse_args(argv + ["--model-parallel", "1"]))
    plain = serve.run(serve.build_parser().parse_args(argv))
    np.testing.assert_array_equal(res.tokens, plain.tokens)
    two = serve.run_model_parallel(serve.build_parser().parse_args(
        argv + ["--model-parallel", "2"]), argv + ["--model-parallel", "2"])
    for r in two:  # rank 0 samples and broadcasts: every rank feeds its tokens
        np.testing.assert_array_equal(r.tokens, plain.tokens)


def test_bad_model_parallel_flag_is_rejected():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--model-parallel", "0"])
