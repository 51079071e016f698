"""Port vs reference: the LM serving slice's configs, data and models.

Each model variant is built in both packages from the same config; the
port's params are the reference's ``model.init(PRNGKey(0))`` converted
leaf for leaf (``repro_torch.core.convert.params_from_numpy``).  Prefill
is held to ``model.apply(..., return_cache=True, use_kernels=True)`` (the
reference's Pallas flash-attention and SSD kernels in interpret mode), the
emitted cache included; then 4 teacher-forced ``decode_step``s, each
starting from the reference's merged cache, are compared in logits and in
the whole cache.  The variants: reduced llama3.2-1b (MHA, as ``reduced``
keeps Hkv = H = 4), the same with n_kv_heads = 2 (GQA), the GQA one with a
sliding window of 8 on every other layer, the GQA one with RMS-normed q
and k (``qk_norm``) and an untied unembedding, and reduced mamba2-1.3b.

Tolerance: ``LM_RTOL`` / ``LM_ATOL`` (tests/_torch_parity.py).
"""
from dataclasses import fields, replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.synthetic import make_synthetic_lm as ref_make_synthetic_lm
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config, reduced
from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.data.synthetic import make_synthetic_lm
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

torch.set_num_threads(1)

B, S, STEPS = 2, 21, 4
VARIANTS = {
    "llama-mha": ("llama3.2-1b", {}),
    "llama-gqa": ("llama3.2-1b", {"n_kv_heads": 2}),
    "llama-window": ("llama3.2-1b", {"n_kv_heads": 2, "sliding_window": 8,
                                     "local_global_pattern": (1, 1)}),
    "llama-qknorm-untied": ("llama3.2-1b", {"n_kv_heads": 2, "qk_norm": True,
                                            "tie_embeddings": False}),
    "mamba2": ("mamba2-1.3b", {}),
}


def port_model_cfg(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's values."""
    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name) for f in fields(ref_cfg)
                          if f.name in names})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_merge(dst, src):
    """The reference serve's prefill-cache merge (``repro.launch.serve``)."""
    if dst.ndim >= 3 and src.ndim == dst.ndim and dst.shape[2] >= src.shape[2] \
            and dst.shape[:2] == src.shape[:2]:
        return jax.lax.dynamic_update_slice(dst, src.astype(dst.dtype), (0,) * dst.ndim)
    return src.astype(dst.dtype)


@lru_cache(maxsize=None)
def _run(variant):
    """Both packages' prefill and teacher-forced decode outputs, as numpy."""
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    rmodel, model = ref_build_model(rcfg), build_model(port_model_cfg(rcfg))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np_tree(rparams))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, size=(B, S + STEPS))

    rl, rcache, _ = rmodel.apply(rparams, jnp.asarray(toks[:, :S], jnp.int32),
                                 return_cache=True, use_kernels=True)
    pl, pcache, aux = model.apply(params, torch.as_tensor(toks[:, :S]), return_cache=True)
    out = {"prefill": (np.asarray(rl), to_numpy(pl)),
           "prefill_cache": (_np_tree(rcache), [to_numpy(t) for t in tree_leaves(pcache)]),
           "aux": float(aux), "decode": []}

    rdec = jax.tree_util.tree_map(_ref_merge, rmodel.init_cache(rparams, B, S + STEPS), rcache)
    for t in range(STEPS):
        tok = toks[:, S + t:S + t + 1]
        start = params_from_numpy(_np_tree(rdec))  # each step starts from the reference's cache
        rl, rdec = rmodel.decode_step(rparams, jnp.asarray(tok, jnp.int32), rdec,
                                      jnp.int32(S + t))
        pl, pdec = model.decode_step(params, torch.as_tensor(tok), start, S + t)
        assert pdec is start  # decode writes the cache in place
        out["decode"].append(((np.asarray(rl), to_numpy(pl)),
                              (_np_tree(rdec), [to_numpy(x) for x in tree_leaves(pdec)])))
    return out


def _close_trees(ref_tree, port_leaves, what):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    assert len(ref_leaves) == len(port_leaves)
    for i, (r, p) in enumerate(zip(ref_leaves, port_leaves)):
        assert r.shape == p.shape, (what, i)
        assert_close(p, r, rtol=LM_RTOL, atol=LM_ATOL, what=f"{what} leaf {i}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_logits_match_reference(variant):
    r, p = _run(variant)["prefill"]
    assert p.shape == r.shape == (B, S, 512)
    assert_close(p, r, rtol=LM_RTOL, atol=LM_ATOL)
    assert _run(variant)["aux"] == 0.0


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_cache_matches_reference(variant):
    r, p = _run(variant)["prefill_cache"]
    _close_trees(r, p, "prefill cache")


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_steps_match_reference(variant):
    for t, ((rl, pl), (rc, pc)) in enumerate(_run(variant)["decode"]):
        assert_close(pl, rl, rtol=LM_RTOL, atol=LM_ATOL, what=f"decode step {t} logits")
        _close_trees(rc, pc, f"decode step {t} cache")


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_config_copy_matches_reference(arch, cut):
    ref = ref_get_config(arch)
    port = get_config(arch)
    if cut == "reduced":
        ref, port = ref_reduced(ref), reduced(port)
    for f in fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for prop in ("padded_vocab", "ssm_heads"):
        assert getattr(port, prop) == getattr(ref, prop)
    if port.n_heads:
        assert port.resolved_head_dim == ref.resolved_head_dim


def test_get_config_refuses_unported_and_unknown_archs():
    assert get_config("mamba2_1_3b").name == "mamba2-1.3b"
    with pytest.raises(NotImplementedError, match="A.15"):
        get_config("zamba2-7b")
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("kw", [dict(family="moe", n_experts=4, top_k=2),
                                dict(family="hybrid", attn_every=2),
                                dict(family="encdec", is_encoder_decoder=True),
                                dict(mlp_type="gelu")])
def test_unported_families_are_refused(kw):
    cfg = replace(reduced(get_config("llama3.2-1b")), **kw)
    with pytest.raises(NotImplementedError, match="A.15"):
        build_model(cfg)


@pytest.mark.parametrize("vocab", [512, 37])
def test_make_synthetic_lm_matches_reference_draw_for_draw(vocab):
    np.testing.assert_array_equal(make_synthetic_lm(vocab, 24, 5, seed=3),
                                  ref_make_synthetic_lm(vocab, 24, 5, seed=3))


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_have_the_reference_layout(variant):
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
    ref_shapes = jax.eval_shape(ref_build_model(rcfg).init, jax.random.PRNGKey(0))
    params = build_model(port_model_cfg(rcfg)).init(torch.Generator().manual_seed(0))
    ref_paths = jax.tree_util.tree_flatten_with_path(ref_shapes)[0]
    port_paths = tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_paths] == [p for p, _ in port_paths]
    for (_, r), (path, p) in zip(ref_paths, port_paths):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == str(r.dtype), path
        assert bool(torch.isfinite(p).all()), path


def test_init_cache_has_the_reference_layout():
    for arch in ARCH_IDS:
        rcfg = ref_reduced(ref_get_config(arch))
        ref = jax.eval_shape(lambda: ref_build_model(rcfg).init_cache(None, 3, 40))
        cache = transformer.init_cache(port_model_cfg(rcfg), 3, 40)
        assert [tuple(t.shape) for t in tree_leaves(cache)] == \
            [r.shape for r in jax.tree_util.tree_leaves(ref)]


def test_params_from_numpy_keeps_dtypes():
    import ml_dtypes

    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.ones(4, ml_dtypes.bfloat16)}}
    out = params_from_numpy(tree)
    assert out["a"].dtype == torch.float32 and out["b"]["c"].dtype == torch.bfloat16
