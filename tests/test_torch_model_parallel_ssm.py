"""The model group on the ssm, hybrid and encoder-decoder archs against the
unsharded model, in the port and in the reference.

The set-up of tests/test_torch_model_parallel.py: the same numpy-seeded
weights (``np_weights``) go into (a) the reference's unsharded model, (b)
the port's unsharded model and (c) the port on 2 and 4 gloo ranks
(``spawn_cohort(..., device="cpu")``; each rank slices its share with
``shard_params``).  The decoder-only variants prefill one batch and decode
greedily (``_torch_model_ranks.serve_case``; the reference's
``model.apply`` / ``decode_step``); seamless encodes seeded source frames,
gives the teacher-forced logits of a target and decodes greedily from BOS 0
(``encdec_case``; the reference's ``encdec.encode`` / ``decode_train`` /
``decode_step``).  Every logit of (c) is held to (b) and to (a) at
``LM_RTOL`` / ``LM_ATOL``, the greedy tokens are equal across all three and
across ranks, and each rank's cache is its heads of (b)'s: the SSM state's
SSD heads, the conv state's x channels of those heads with B's and C's
whole, the self and cross K/V's kv heads (ROADMAP queue C's route
differences: the reference keeps the B > 1 SSM and conv caches whole and
splits the cross K/V by source sequence).  Variants: mamba2-1.3b,
zamba2-7b (a mamba layer and the shared block), zamba2 with a tail mamba
layer, seamless-m4t-large-v2, and a mamba2 whose 6 SSD heads four ranks do
not divide, so its block runs whole there (``counts["mamba_whole"]``).
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_model_ranks as ranks_mod
from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from test_torch_model_parallel import _ref_merge, np_weights, port_model_cfg
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.models.layers import ParallelContext, kv_heads_of
from repro_torch.models.model import build_model
from repro_torch.models.transformer import period_layout
from repro_torch.sharding.rules import check_model_parallel, param_specs
from repro_torch.sharding.shard import init_params_sharded, shard_params
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

B, S, STEPS = 2, 13, 4
S_SRC, S_TGT = 11, 7
WORLDS = (2, 4)
WORLD_TIMEOUT_S, WORLD_DEADLINE_S = 60.0, 240.0
VARIANTS = {
    "mamba2": ("mamba2-1.3b", {}),
    # attn_every 2: a mamba layer, then the shared attention block
    "zamba2": ("zamba2-7b", {}),
    # one period and a tail mamba layer
    "zamba2-tail": ("zamba2-7b", {"n_layers": 3}),
    "seamless": ("seamless-m4t-large-v2", {}),
    # d_inner 192 in 6 SSD heads of 32: two ranks split them, four do not
    "mamba2-6heads": ("mamba2-1.3b", {"d_model": 96}),
}


@lru_cache(maxsize=None)
def _setup(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    cfg = port_model_cfg(rcfg)
    job = {"cfg": cfg, "params": np_weights(cfg, 1), "steps": STEPS}
    rng = np.random.default_rng(2)
    if cfg.is_encoder_decoder:
        job["src"] = rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32)
        job["tgt"] = rng.integers(0, rcfg.vocab_size, size=(B, S_TGT))
    else:
        job["tokens"] = rng.integers(0, rcfg.vocab_size, size=(B, S))
    return rcfg, jax.tree_util.tree_map(jnp.asarray, job["params"]), job


def _reference_encdec(rcfg, rparams, job):
    enc = ref_encdec.encode(rparams, jnp.asarray(job["src"]), cfg=rcfg)
    out = {"enc": np.asarray(enc), "decode": [],
           "train": np.asarray(ref_encdec.decode_train(
               rparams, jnp.asarray(job["tgt"], jnp.int32), enc, cfg=rcfg))}
    cache = ref_encdec.init_decode_cache(rparams, rcfg, B, STEPS, enc)
    tok = jnp.zeros((B, 1), jnp.int32)
    tokens = []
    for i in range(STEPS):
        lg, cache = ref_encdec.decode_step(rparams, tok, cache, jnp.int32(i), cfg=rcfg)
        out["decode"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tokens.append(tok)
    out["tokens"] = np.asarray(jnp.concatenate(tokens, axis=1))
    return out


@lru_cache(maxsize=None)
def reference(variant):
    """(a): the reference's unsharded model."""
    rcfg, rparams, job = _setup(variant)
    if rcfg.is_encoder_decoder:
        return _reference_encdec(rcfg, rparams, job)
    rmodel = ref_build_model(rcfg)
    logits, rcache, _ = rmodel.apply(rparams, jnp.asarray(job["tokens"], jnp.int32),
                                     return_cache=True)
    cache = jax.tree_util.tree_map(_ref_merge, rmodel.init_cache(rparams, B, S + STEPS), rcache)
    out = {"prefill": np.asarray(logits), "decode": []}
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tokens = [tok]
    for i in range(STEPS):
        lg, cache = rmodel.decode_step(rparams, tok, cache, jnp.int32(S + i))
        out["decode"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tokens.append(tok)
    out["tokens"] = np.asarray(jnp.concatenate(tokens, axis=1))
    return out


@lru_cache(maxsize=None)
def unsharded(variant):
    """(b): the port's unsharded model, through the ranks' own body."""
    return ranks_mod.run_case(_setup(variant)[2])


@lru_cache(maxsize=None)
def sharded(n):
    """(c): every variant on one world of ``n`` gloo ranks; per variant the
    ranks' results in rank order."""
    jobs = [_setup(v)[2] for v in VARIANTS]
    per_rank = spawn_cohort(ranks_mod.world, n, args=(jobs,), device="cpu",
                            timeout_s=WORLD_TIMEOUT_S, deadline_s=WORLD_DEADLINE_S)
    return {v: [per_rank[r][i] for r in range(n)] for i, v in enumerate(VARIANTS)}


CASES = [(v, n) for n in WORLDS for v in VARIANTS]


def _ids(case):
    return f"{case[0]}-{case[1]}ranks"


def _logit_fields(cfg):
    return ("enc", "train") if cfg.is_encoder_decoder else ("prefill",)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_logits_match_the_unsharded_model_and_the_reference(case):
    variant, n = case
    cfg = _setup(variant)[2]["cfg"]
    got, want, ref = sharded(n)[variant][0], unsharded(variant), reference(variant)
    for name in _logit_fields(cfg):
        assert_close(got[name], want[name], rtol=LM_RTOL, atol=LM_ATOL, what=f"{name} vs port")
        assert_close(got[name], ref[name], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"{name} vs reference")
    assert len(got["decode"]) == STEPS
    for i in range(STEPS):
        assert_close(got["decode"][i], want["decode"][i], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"decode {i} vs port")
        assert_close(got["decode"][i], ref["decode"][i], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"decode {i} vs reference")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_greedy_tokens_are_equal_everywhere(case):
    variant, n = case
    want, ref = unsharded(variant), reference(variant)
    np.testing.assert_array_equal(want["tokens"], ref["tokens"])
    if "step_tokens" in want:  # launch.steps' prefill and serve steps
        np.testing.assert_array_equal(want["step_tokens"], want["tokens"])
    for r, got in enumerate(sharded(n)[variant]):
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        if "step_tokens" in got:
            np.testing.assert_array_equal(got["step_tokens"], want["tokens"],
                                          err_msg=f"rank {r}")


def _rank_part(key, leaf, cfg, rank, n):
    """Rank ``rank``'s part of the unsharded cache leaf ``key``: the kv
    heads ``kv_heads_of`` names (self and cross K/V), the SSD heads
    ``[r·H/n, (r+1)·H/n)`` of the SSM state (n, B, H, P, N), and of the conv
    state (n, B, k−1, d_inner + 2N) those heads' x channels followed by B's
    and C's whole; the whole leaf when ``n`` does not divide the heads."""
    if key in ("k", "v", "cross_k", "cross_v"):
        return leaf[..., kv_heads_of(cfg, ParallelContext(None, rank, n)), :]
    H = cfg.ssm_heads
    if H % n:
        return leaf
    h = H // n
    if key == "ssm":
        return leaf[:, :, rank * h:(rank + 1) * h]
    d, dl = cfg.ssm_expand * cfg.d_model, h * cfg.ssm_head_dim
    return np.concatenate([leaf[..., rank * dl:(rank + 1) * dl], leaf[..., d:]], axis=-1)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_caches_its_heads_of_the_unsharded_cache(case):
    variant, n = case
    cfg = _setup(variant)[2]["cfg"]
    want = unsharded(variant)
    for r, got in enumerate(sharded(n)[variant]):
        assert got["cache_keys"] == want["cache_keys"]
        for key, a, b in zip(got["cache_keys"], got["cache"], want["cache"]):
            part = _rank_part(key, b, cfg, r, n)
            assert a.shape == part.shape, (key, r)
            assert_close(a, part, rtol=LM_RTOL, atol=LM_ATOL, what=f"rank {r} cache {key}")
    if variant.startswith("mamba2"):
        assert set(want["cache_keys"]) == {"ssm", "conv"}


def _per_forward(cfg, n):
    """(all_reduce, all_gather, mamba_whole) of one decoder-only forward on
    ``n`` ranks: the embedding's all_reduce and the logits' all_gather (the
    vocabulary splits at every variant); a mamba layer two (its norm's sum
    of squares and ``w_out``) when ``n`` divides its SSD heads, else none
    and one whole block; the shared block one for attention and one for
    the MLP."""
    slots, n_periods, tail = period_layout(cfg)
    kinds = [s.kind for s in slots] * n_periods + [s.kind for s in tail]
    split_ssd = cfg.ssm_heads % n == 0
    mamba = kinds.count("mamba")
    reduce = 1 + 2 * mamba * split_ssd + 2 * kinds.count("attn")
    return reduce, 1, mamba * (not split_ssd)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_collective_counts(case):
    """A decoder-only variant's counts over its prefill and ``STEPS`` decode
    steps; seamless': its encode (attention and MLP a layer), its
    teacher-forced pass and ``STEPS`` decode steps (embedding, self- and
    cross-attention and MLP a layer, the logits' all_gather)."""
    variant, n = case
    cfg = _setup(variant)[2]["cfg"]
    if cfg.is_encoder_decoder:
        forward = 1 + 3 * cfg.n_layers
        want = (2 * cfg.n_encoder_layers + (1 + STEPS) * forward, 1 + STEPS, 0)
    else:
        want = tuple((1 + STEPS) * c for c in _per_forward(cfg, n))
    for r, got in enumerate(sharded(n)[variant]):
        c = got["counts"]
        assert (c["all_reduce"], c["all_gather"], c["mamba_whole"]) == want, f"rank {r}"
    if variant == "mamba2-6heads":
        assert (want[2] > 0) == (n == 4)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_sharded_is_each_ranks_slice_of_the_unsharded_draw(variant, n):
    cfg = _setup(variant)[2]["cfg"]
    whole = build_model(cfg).init(torch.Generator().manual_seed(11))
    specs = param_specs(whole, cfg, n)
    for r in range(n):
        share = init_params_sharded(torch.Generator().manual_seed(11), cfg, r, n)
        want = shard_params(whole, specs, r, n)
        for a, b in zip(tree_leaves(share), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_family_is_refused(arch):
    """Every arch's family runs on a group; only an expert count the group
    does not divide is refused (tests/test_torch_model_rules.py)."""
    for n in (2, 4, 16):
        check_model_parallel(get_config(arch), n)


SMALL = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "6", "--seed", "3"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "seamless-m4t-large-v2"])
def test_cli_on_two_ranks_serves_the_unsharded_tokens(arch, capfd):
    assert serve.main(["--arch", arch, *SMALL, "--model-parallel", "2"]) == 0
    lines = capfd.readouterr().out.splitlines()
    assert serve.main(["--arch", arch, *SMALL]) == 0
    plain = capfd.readouterr().out.splitlines()
    if arch.startswith("seamless"):  # "encdec arch=…: encode …", then "sample: […]"
        assert lines[-2].split(":")[0] == plain[-2].split(":")[0] == \
            f"encdec arch={arch}-reduced"
        assert lines[-1] == plain[-1] and lines[-1].startswith("sample:")
    else:
        assert lines[0] == plain[0] and lines[0].startswith(f"arch={arch}-reduced")
        assert lines[-3:] == plain[-3:]  # "sample generations" and the two rows
