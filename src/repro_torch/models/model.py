"""Uniform model API (counterpart of ``repro.models.model``) for the
decoder-only families (dense, moe, ssm, hybrid, vlm):

    params          = model.init(generator)
    logits, cache, aux = model.apply(params, tokens, return_cache=True)   # prefill
    cache           = model.init_cache(params, batch, max_len)
    logits, cache   = model.decode_step(params, token, cache, pos)

``loss_fn`` comes with the training slice (ROADMAP A.15).  The reference's
``use_kernels`` switch has no counterpart: prefill always goes through the
kernels (their plain versions on the CPU).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import transformer


class Model(NamedTuple):
    cfg: Any
    init: Callable[..., Any]
    apply: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def build_model(cfg) -> Model:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not ported yet "
                                  f"(ROADMAP A.15)")
    transformer.period_layout(cfg)  # refuse a ragged layout here, not at first use

    def init(generator):
        return transformer.init_params(generator, cfg)

    def apply(params, tokens, *, cache=None, cache_pos=None, return_cache=False):
        """Returns ``(logits, cache, aux)``."""
        return transformer.forward(params, tokens, cfg=cfg, cache=cache,
                                   cache_pos=cache_pos, return_cache=return_cache)

    def init_cache(params, batch, max_len):
        return transformer.init_cache(cfg, batch, max_len, device=params["embed"].device)

    def decode_step(params, token, cache, pos):
        logits, new_cache, _ = apply(params, token, cache=cache, cache_pos=pos)
        return logits, new_cache

    return Model(cfg, init, apply, init_cache, decode_step)
