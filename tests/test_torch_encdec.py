"""Port vs reference: the encoder-decoder (seamless-m4t-large-v2, reduced:
2 encoder + 2 decoder layers, d_model 256, 4 heads, vocab 512), on the
reference's ``model.init(PRNGKey(0))`` weights converted leaf for leaf
(``repro_torch.core.convert.params_from_numpy``) and the same numpy source
frames and tokens.

Held to the reference: the init layout; ``encode`` on the plain route and
through ``ops.flash_attention`` (its plain version on the CPU, non-causal);
``decode_train``'s logits; ``init_decode_cache``'s cross K/V; 4
teacher-forced ``decode_step``s, each started from the reference's cache,
in logits and the whole cache; and ``serve.run``'s greedy tokens against the
reference's encode + greedy decode on the same injected frames.  Against
itself: the port's decode steps reproduce its own ``decode_train`` logits.

Tolerance: ``LM_RTOL`` / ``LM_ATOL`` (tests/_torch_parity.py); the port's
decode vs its own teacher-forced logits at the reference's own 5e-3
(``tests/test_model_consistency.py``).
"""
import gc
import weakref
from dataclasses import fields
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.data.synthetic import source_frames
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models.model import build_model
from repro_torch.utils.trees import tree_flatten_with_path

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
B, S_SRC, S_TGT, STEPS = 2, 11, 9, 4


def port_model_cfg(ref_cfg) -> ModelConfig:
    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name) for f in fields(ref_cfg)
                          if f.name in names})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _setup():
    rcfg = ref_reduced(ref_get_config(ARCH))
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    src = rng.normal(size=(B, S_SRC, rcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, rcfg.vocab_size, size=(B, S_TGT + STEPS))
    return rcfg, port_model_cfg(rcfg), rparams, src, toks


def _port_params():
    return params_from_numpy(_np(_setup()[2]))


@lru_cache(maxsize=None)
def _ref_enc():
    rcfg, _, rparams, src, _ = _setup()
    return np.array(ref_encdec.encode(rparams, jnp.asarray(src), cfg=rcfg))


def test_init_params_have_the_reference_layout():
    rcfg, cfg, *_ = _setup()
    ref = jax.eval_shape(ref_build_model(rcfg).init, jax.random.PRNGKey(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    ref_paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    port_paths = tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_paths] == [p for p, _ in port_paths]
    for (_, r), (path, p) in zip(ref_paths, port_paths):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == str(r.dtype), path
        assert bool(torch.isfinite(p).all()), path
    assert params["enc"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    assert params["dec"]["cross_attn"]["wk"].shape[0] == cfg.n_layers


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encode_matches_reference(use_kernels):
    """Plain (``attend_direct``, as the reference) and through
    ``ops.flash_attention(causal=False)``, whose plain version runs here."""
    _, cfg, _, src, _ = _setup()
    out = encdec.encode(_port_params(), torch.as_tensor(src), cfg=cfg, use_kernels=use_kernels)
    assert out.shape == (B, S_SRC, cfg.d_model) and out.dtype == torch.float32
    assert_close(out, _ref_enc(), rtol=LM_RTOL, atol=LM_ATOL)


def test_decode_train_logits_match_reference():
    rcfg, cfg, rparams, _, toks = _setup()
    tgt = toks[:, :S_TGT]
    ref = ref_encdec.decode_train(rparams, jnp.asarray(tgt, jnp.int32), jnp.asarray(_ref_enc()),
                                  cfg=rcfg)
    out = encdec.decode_train(_port_params(), torch.as_tensor(tgt), torch.as_tensor(_ref_enc()),
                              cfg=cfg)
    assert out.shape == (B, S_TGT, cfg.padded_vocab)
    assert_close(out, ref, rtol=LM_RTOL, atol=LM_ATOL)


def test_init_decode_cache_cross_kv_match_reference():
    rcfg, cfg, rparams, _, _ = _setup()
    ref = ref_encdec.init_decode_cache(rparams, rcfg, B, S_TGT, jnp.asarray(_ref_enc()))
    cache = encdec.init_decode_cache(_port_params(), cfg, B, S_TGT, torch.as_tensor(_ref_enc()))
    assert sorted(cache) == sorted(ref)
    for k in ("cross_k", "cross_v"):
        assert tuple(cache[k].shape) == ref[k].shape == (cfg.n_layers, B, S_SRC, 4, 64)
        assert_close(cache[k], ref[k], rtol=LM_RTOL, atol=LM_ATOL, what=k)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == ref[k].shape and not cache[k].any()


@lru_cache(maxsize=None)
def _decode_runs():
    """4 teacher-forced steps in both packages, each from the reference's
    cache; and the port's own chain of steps from its own cache."""
    rcfg, cfg, rparams, _, toks = _setup()
    params = _port_params()
    enc = jnp.asarray(_ref_enc())
    rcache = ref_encdec.init_decode_cache(rparams, rcfg, B, STEPS, enc)
    steps = []
    for t in range(STEPS):
        start = params_from_numpy(_np(rcache))
        rl, rcache = ref_encdec.decode_step(rparams, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                            rcache, jnp.int32(t), cfg=rcfg)
        pl, pcache = encdec.decode_step(params, torch.as_tensor(toks[:, t:t + 1]), start, t,
                                        cfg=cfg)
        assert pcache is start  # written in place
        steps.append(((np.asarray(rl), to_numpy(pl)),
                      (_np(rcache), {k: to_numpy(v) for k, v in pcache.items()})))
    own = encdec.init_decode_cache(params, cfg, B, STEPS, torch.as_tensor(_ref_enc()))
    chain = []
    for t in range(STEPS):
        lg, own = encdec.decode_step(params, torch.as_tensor(toks[:, t:t + 1]), own, t, cfg=cfg)
        chain.append(to_numpy(lg)[:, 0])
    return steps, np.stack(chain, axis=1)


def test_decode_steps_match_reference():
    for t, ((rl, pl), (rc, pc)) in enumerate(_decode_runs()[0]):
        assert pl.shape == rl.shape == (B, 1, 512)
        assert_close(pl, rl, rtol=LM_RTOL, atol=LM_ATOL, what=f"decode step {t} logits")
        for k in rc:
            assert_close(pc[k], rc[k], rtol=LM_RTOL, atol=LM_ATOL, what=f"step {t} cache {k}")


def test_decode_steps_reproduce_teacher_forced_logits():
    _, cfg, _, _, toks = _setup()
    full = encdec.decode_train(_port_params(), torch.as_tensor(toks[:, :STEPS]),
                               torch.as_tensor(_ref_enc()), cfg=cfg)
    np.testing.assert_allclose(_decode_runs()[1], to_numpy(full), rtol=5e-3, atol=5e-3)


def test_serve_run_greedy_tokens_match_reference(monkeypatch):
    """``serve.run`` with the reference's weights and the same injected
    source frames: encode (the flash kernel's plain version here), cross
    cache, greedy decode from BOS 0 — the reference's ``_serve_encdec``
    recipe gives the same tokens."""
    rcfg, cfg, rparams, src, _ = _setup()
    gen = 6
    enc = ref_encdec.encode(rparams, jnp.asarray(src), cfg=rcfg)
    cache = ref_encdec.init_decode_cache(rparams, rcfg, B, gen, enc)
    tok = jnp.zeros((B, 1), jnp.int32)
    want = []
    for i in range(gen):
        logits, cache = ref_encdec.decode_step(rparams, tok, cache, jnp.int32(i), cfg=rcfg)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    args = serve.build_parser().parse_args(["--arch", ARCH, "--batch", str(B), "--prompt-len",
                                            str(S_SRC), "--gen", str(gen), "--device", "cpu"])
    monkeypatch.setattr(serve, "build_model", lambda c: build_model(c)._replace(
        init=lambda generator: _port_params()))
    res = serve.run(args, src_embeds=torch.as_tensor(src))
    np.testing.assert_array_equal(res.tokens, np.concatenate(want, axis=1))
    assert res.finite and res.stats.sessions == 1 and res.stats.steps == gen
    assert len(res.prefill_s) == len(res.decode_s) == 1


def test_serve_run_draws_its_frames_from_the_seed():
    args = serve.build_parser().parse_args(["--arch", ARCH, "--batch", "2", "--prompt-len", "5",
                                            "--gen", "4", "--device", "cpu", "--seed", "1"])
    a, b = serve.run(args), serve.run(args)
    assert a.tokens.shape == (2, 4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    cfg = _setup()[1]
    frames = source_frames(2, 5, cfg.d_model, 1 + 2, torch.device("cpu"))
    assert frames.shape == (2, 5, cfg.d_model)
    assert torch.equal(frames, source_frames(2, 5, cfg.d_model, 1 + 2, torch.device("cpu")))
    np.testing.assert_array_equal(serve.run(args, src_embeds=frames).tokens, a.tokens)
    assert a.encoder_decoder


def test_weights_are_released_without_the_garbage_collector():
    _, cfg, *_ = _setup()
    model = build_model(cfg)
    gc.disable()
    try:
        params = model.init(torch.Generator().manual_seed(0))
        leaf = weakref.ref(params["dec"]["self_attn"]["wq"])
        enc = encdec.encode(params, torch.zeros((1, 3, cfg.d_model)), cfg=cfg, use_kernels=True)
        cache = model.init_cache(params, 1, 2, enc_out=enc)
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.long), cache, 0)
        model.loss_fn(params, model.dummy_batch(1, 3))
        del params, cache, enc
        assert leaf() is None
    finally:
        gc.enable()
