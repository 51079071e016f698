"""Port vs reference: the LM serving slice's configs, data and models.

Each model variant is built in both packages from the same config; the
port's params are the reference's ``model.init(PRNGKey(0))`` converted
leaf for leaf (``repro_torch.core.convert.params_from_numpy``).  Prefill
is held to ``model.apply(..., return_cache=True, use_kernels=True)`` (the
reference's Pallas flash-attention and SSD kernels in interpret mode), the
emitted cache included; then 4 teacher-forced ``decode_step``s, each
starting from the reference's merged cache, are compared in logits and in
the whole cache, and the auxiliary loss in prefill.  The variants: reduced
llama3.2-1b (MHA, as ``reduced`` keeps Hkv = H = 4), the same with
n_kv_heads = 2 (GQA), the GQA one with a sliding window of 8 on every other
layer, the GQA one with RMS-normed q and k (``qk_norm``) and an untied
unembedding, reduced mamba2-1.3b, and the reduced configs of the seven
other decoder-only archs: qwen3 (QK-norm, untied), gemma3 (local/global
(1, 1), window 8, QK-norm), starcoder2 (tanh GELU, window 8), chameleon
(vlm), zamba2 (hybrid: a mamba layer and the shared attention block), the
same with 3 layers (one period and a tail mamba layer), maverick (4
experts, top-1, MoE every other layer, shared expert), dbrx (4 experts,
top-2, every layer MoE) and dbrx with ``capacity_factor=0.25`` (capacity 8
for the prefill's 42 tokens × 2 choices, so choices drop).

Tolerance: ``LM_RTOL`` / ``LM_ATOL`` (tests/_torch_parity.py).
"""
import gc
import weakref
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
    "qwen3": ("qwen3-14b", {}),
    "gemma3": ("gemma3-12b", {}),
    "starcoder2": ("starcoder2-7b", {}),
    "chameleon": ("chameleon-34b", {}),
    "zamba2": ("zamba2-7b", {}),
    "zamba2-tail": ("zamba2-7b", {"n_layers": 3}),
    "maverick": ("llama4-maverick-400b-a17b", {}),
    "dbrx": ("dbrx-132b", {}),
    "dbrx-drop": ("dbrx-132b", {"capacity_factor": 0.25}),
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

    rl, rcache, raux = rmodel.apply(rparams, jnp.asarray(toks[:, :S], jnp.int32),
                                    return_cache=True, use_kernels=True)
    pl, pcache, aux = model.apply(params, torch.as_tensor(toks[:, :S]), return_cache=True)
    out = {"prefill": (np.asarray(rl), to_numpy(pl)),
           "prefill_cache": (_np_tree(rcache), [to_numpy(t) for t in tree_leaves(pcache)]),
           "aux": (np.asarray(raux), to_numpy(aux)), "decode": []}

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


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_aux_matches_reference(variant):
    """The MoE slots' load-balance + z-loss, summed over slots; exactly 0
    for the archs without experts."""
    r, p = _run(variant)["aux"]
    assert p.dtype == r.dtype == np.float32 and p.shape == r.shape == ()
    assert_close(p, r, rtol=LM_RTOL, atol=LM_ATOL)
    assert (p != 0) == (ref_get_config(VARIANTS[variant][0]).n_experts > 0)


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
    """Every arch of the reference's pool is ported now, seamless-m4t
    included (it was refused until the encoder-decoder slice); only an
    unknown name is refused."""
    assert get_config("mamba2_1_3b").name == "mamba2-1.3b"
    assert get_config("seamless-m4t-large-v2").is_encoder_decoder
    assert get_config("seamless_m4t_large_v2").name == "seamless-m4t-large-v2"
    assert len(ARCH_IDS) == 10 and "seamless-m4t-large-v2" in ARCH_IDS
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("kw", [dict(family="encdec", is_encoder_decoder=True)])
def test_unported_families_are_refused(kw):
    """The encoder-decoder family, refused until its slice, now builds: the
    Model has the training members, and its cache needs the encoder output."""
    cfg = replace(reduced(get_config("llama3.2-1b")), n_encoder_layers=1, **kw)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    assert {"enc", "dec", "enc_norm", "dec_norm", "embed", "unembed"} == set(params)
    batch = model.dummy_batch(2, 5)
    loss, metrics = model.loss_fn(params, batch)
    assert bool(torch.isfinite(loss)) and float(metrics["aux"]) == 0.0
    with pytest.raises(ValueError, match="enc_out"):
        model.init_cache(params, 2, 8)


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
    for arch, kw in [(a, {}) for a in ARCH_IDS] + list(VARIANTS.values()):
        rcfg = replace(ref_reduced(ref_get_config(arch)), **kw)
        if rcfg.is_encoder_decoder:  # the self-attention cache and the cross K/V of enc_out
            rmodel = ref_build_model(rcfg)
            rparams = rmodel.init(jax.random.PRNGKey(0))
            enc = np.zeros((3, 7, rcfg.d_model), np.float32)
            ref = jax.eval_shape(lambda: rmodel.init_cache(rparams, 3, 40, jnp.asarray(enc)))
            cache = build_model(port_model_cfg(rcfg)).init_cache(
                params_from_numpy(_np_tree(rparams)), 3, 40, enc_out=torch.as_tensor(enc))
            assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tree_leaves(cache)] \
                == [(r.shape, str(r.dtype)) for r in jax.tree_util.tree_leaves(ref)]
            continue
        ref = jax.eval_shape(lambda: ref_build_model(rcfg).init_cache(None, 3, 40))
        cache = transformer.init_cache(port_model_cfg(rcfg), 3, 40)
        assert [tuple(t.shape) for t in tree_leaves(cache)] == \
            [r.shape for r in jax.tree_util.tree_leaves(ref)]


@pytest.mark.parametrize("variant,param_dtype", [("zamba2-tail", "float32"),
                                                 ("maverick", "bfloat16"),
                                                 ("dbrx", "bfloat16")])
def test_params_from_numpy_carries_the_new_layouts(variant, param_dtype):
    """The reference's params tree, carried leaf for leaf: zamba2's ``tail``
    and ``shared`` subtrees, the MoE leaves with the f32 router beside bf16
    experts; in the reference's leaf order, dtypes and values."""
    arch, kw = VARIANTS[variant]
    rcfg = replace(ref_reduced(ref_get_config(arch)), param_dtype=param_dtype, **kw)
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(2))
    params = params_from_numpy(_np_tree(rparams))
    ref_paths = jax.tree_util.tree_flatten_with_path(rparams)[0]
    port_paths = tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_paths] == [p for p, _ in port_paths]
    for (_, r), (path, t) in zip(ref_paths, port_paths):
        assert str(t.dtype).split(".")[-1] == str(r.dtype), path
        np.testing.assert_array_equal(to_numpy(t), np.asarray(r, np.float32), err_msg=path)
    paths = [p for p, _ in port_paths]
    if variant == "zamba2-tail":
        assert any(p.startswith("['tail']['slot0']['mamba']") for p in paths)
        assert any(p.startswith("['shared']['attn']") for p in paths)
        assert "['periods']['slot1']" not in "".join(paths)  # the shared slot is not stacked
    else:
        moe = {p: t.dtype for p, t in port_paths if "['moe']" in p}
        assert moe and all(d == (torch.float32 if p.endswith("['router']") else
                                 getattr(torch, param_dtype)) for p, d in moe.items())


@pytest.mark.parametrize("variant", ["llama-gqa", "zamba2-tail", "dbrx"])
def test_weights_are_released_without_the_garbage_collector(variant):
    """Prefill and decode leave no reference cycle that holds the weights:
    a full-width model is tens of GB, and a cycle would keep it on the card
    until the collector happened to run (the tree helpers' recursion was
    one)."""
    arch, kw = VARIANTS[variant]
    model = build_model(port_model_cfg(replace(ref_reduced(ref_get_config(arch)), **kw)))
    gc.disable()
    try:
        params = model.init(torch.Generator().manual_seed(0))
        leaf = weakref.ref(tree_leaves(params["periods"])[0])
        toks = torch.zeros((1, 5), dtype=torch.long)
        _, pre, _ = model.apply(params, toks, return_cache=True)
        cache = transformer.init_cache(model.cfg, 1, 6)
        model.decode_step(params, toks[:, :1], cache, 5)
        del params, pre, cache
        assert leaf() is None
    finally:
        gc.enable()


def test_params_from_numpy_keeps_dtypes():
    import ml_dtypes

    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.ones(4, ml_dtypes.bfloat16)}}
    out = params_from_numpy(tree)
    assert out["a"].dtype == torch.float32 and out["b"]["c"].dtype == torch.bfloat16
