"""Uniform model API over all architecture families (counterpart of
``repro.models.model``):

    params             = model.init(generator)
    loss, metrics      = model.loss_fn(params, batch)                      # training
    logits, cache, aux = model.apply(params, tokens, return_cache=True)   # prefill
    cache              = model.init_cache(params, batch, max_len)          # enc-dec: enc_out=
    logits, cache      = model.decode_step(params, token, cache, pos)
    # over a model group: parallel=ParallelContext on apply, loss_fn,
    # init_cache and decode_step, with each rank's share of the params
    batch              = model.dummy_batch(batch, seq_len)
    specs              = model.input_specs(shape)   # meta tensors, for a dry-run
    loss_fn            = cohort_loss_fn(model)   # the federated engine's contract

``use_kernels``: serving's prefill (``apply``, and the encoder-decoder's
``encode``) defaults to the hand-written kernels (their plain versions on
the CPU); ``loss_fn`` defaults to the reference's plain route, which is
the only route training may take: the kernels have no backward, and their
wrappers refuse inputs that require grad.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.layers import ParallelContext, cache_extent, kv_heads_of
from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_reg: float = 0.0
                  ) -> torch.Tensor:
    """Mean token cross entropy in f32.  logits ``(B, S, V)``, labels ``(B, S)``.

    As in the reference: logsumexp over the whole last axis (the padded
    vocab's columns too) around the detached row max.  The label logit is
    gathered; the reference's one-hot einsum adds exactly one nonzero term,
    so the value is the same without a ``(B, S, V)`` one-hot."""
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    logz = m[..., 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(logz - ll)
    if z_reg:
        loss = loss + z_reg * torch.mean(torch.square(logz))
    return loss


class Model(NamedTuple):
    cfg: Any
    init: Callable[..., Any]
    apply: Callable[..., Any]
    loss_fn: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    dummy_batch: Callable[..., Dict[str, torch.Tensor]]
    input_specs: Callable[..., Dict[str, Any]]


TOKEN_DTYPE = torch.int64  # the reference's token ids are int32; torch indexes with int64


def build_model(cfg) -> Model:
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg)
    return _build_decoder_only(cfg)


def _dummy_tokens(cfg, batch: int, seq_len: int):
    """The reference's ``dummy_batch`` draw: ``default_rng(0)`` tokens and
    their labels rolled by one."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq_len))
    return rng, toks, np.roll(toks, -1, axis=1)


def _build_decoder_only(cfg) -> Model:
    transformer.period_layout(cfg)  # refuse a ragged layout here, not at first use

    def init(generator):
        return transformer.init_params(generator, cfg)

    def apply(params, tokens, *, cache=None, cache_pos=None, return_cache=False,
              use_kernels=True, remat="none", parallel=None):
        """Returns ``(logits, cache, aux)``; ``parallel`` runs this rank's
        share of the params on its model group."""
        return transformer.forward(params, tokens, cfg=cfg, cache=cache, cache_pos=cache_pos,
                                   return_cache=return_cache, use_kernels=use_kernels,
                                   remat=remat, parallel=parallel)

    def loss_fn(params, batch, *, parallel=None, remat="none", use_kernels=False):
        """``(loss, {"xent", "aux"})``; over a group (``parallel``) every
        rank gets the same loss from its share of the params."""
        logits, _, aux = apply(params, batch["tokens"], remat=remat, use_kernels=use_kernels,
                               parallel=parallel)
        xe = cross_entropy(logits, batch["labels"])
        return xe + aux, {"xent": xe, "aux": aux}

    def init_cache(params, batch, max_len, parallel=None):
        return transformer.init_cache(cfg, batch, max_len, device=params["embed"].device,
                                      parallel=parallel)

    def decode_step(params, token, cache, pos, parallel=None):
        logits, new_cache, _ = apply(params, token, cache=cache, cache_pos=pos,
                                     parallel=parallel)
        return logits, new_cache

    def dummy_batch(batch, seq_len, device="cpu"):
        _, toks, labels = _dummy_tokens(cfg, batch, seq_len)
        return {"tokens": torch.as_tensor(toks, device=device),
                "labels": torch.as_tensor(labels, device=device)}

    def input_specs(shape, parallel: Optional[ParallelContext] = None, device="meta"):
        """The step's inputs for the workload ``shape`` (``configs.base.SHAPES``)
        as empty tensors on ``device`` (``meta``: shapes and dtypes alone),
        the reference's ``input_specs``: train and prefill ``tokens`` /
        ``labels`` (B, S); decode one ``token`` (B, 1), the S-deep
        ``init_cache`` and ``pos``.  Token ids are ``TOKEN_DTYPE``.
        ``parallel``: what a rank of that group or grid takes, its rows of
        the batch (``cache_extent``) and its cache."""
        S = shape.seq_len
        B = cache_extent(shape.global_batch, S, parallel)[0]
        if shape.kind in ("train", "prefill"):
            return {"tokens": torch.empty((B, S), dtype=TOKEN_DTYPE, device=device),
                    "labels": torch.empty((B, S), dtype=TOKEN_DTYPE, device=device)}
        return {"token": torch.empty((B, 1), dtype=TOKEN_DTYPE, device=device),
                "cache": transformer.init_cache(cfg, shape.global_batch, S, device=device,
                                                parallel=parallel),
                "pos": torch.empty((), dtype=TOKEN_DTYPE, device=device)}

    return Model(cfg, init, apply, loss_fn, init_cache, decode_step, dummy_batch, input_specs)


def cohort_loss_fn(model: Model, parallel=None) -> Callable[..., torch.Tensor]:
    """The federated engine's loss contract for a decoder-only LM:
    ``loss(params, batch) -> (C,)``, with ``params`` leaves ``(C, …)`` (views
    of the engine's ``(C, P)`` cohort plane) and ``batch`` = ``{"x", "y"}``
    token ids ``(C, B, S)``.  Row c is ``model.loss_fn(row_c, {"tokens":
    x[c], "labels": y[c]})[0]`` on the plain route; each leaf is unbound
    into its C rows once, so the rows are disjoint and the gradient of the
    losses' sum is each client's own gradient, stacked.  The
    encoder-decoder's batch carries source frames, and the reference runs
    no federated encoder-decoder, so it is refused.  ``parallel`` runs each
    row on this rank's share of a model group (the reference's
    ``fed_dryrun`` layout: each client's model tensor-sharded over
    ``"model"``); every rank gets the same losses."""
    if model.cfg.is_encoder_decoder:
        raise ValueError(f"{model.cfg.name}: the federated LM loss covers the decoder-only "
                         f"families; the encoder-decoder's batch carries source frames")

    def loss(params, batch) -> torch.Tensor:
        leaves, treedef = tree_flatten_with_path(params)
        rows = [leaf.unbind(0) for _, leaf in leaves]
        out = []
        for c in range(batch["x"].shape[0]):
            row = tree_unflatten(treedef, [r[c] for r in rows])
            out.append(model.loss_fn(row, {"tokens": batch["x"][c], "labels": batch["y"][c]},
                                     parallel=parallel)[0])
        return torch.stack(out)

    return loss


def _build_encdec(cfg) -> Model:
    def init(generator):
        return encdec.init_params(generator, cfg)

    def apply(params, batch, *, use_kernels=False, remat="none", parallel=None):
        """``batch`` holds ``src_embeds`` and ``tgt_tokens``; returns
        ``(logits, None, aux = 0)``."""
        enc_out = encdec.encode(params, batch["src_embeds"], cfg=cfg, use_kernels=use_kernels,
                                remat=remat, parallel=parallel)
        logits = encdec.decode_train(params, batch["tgt_tokens"], enc_out, cfg=cfg, remat=remat,
                                     parallel=parallel)
        return logits, None, logits.new_zeros((), dtype=torch.float32)

    def loss_fn(params, batch, *, parallel=None, remat="none", use_kernels=False):
        logits, _, aux = apply(params, batch, use_kernels=use_kernels, remat=remat,
                               parallel=parallel)
        xe = cross_entropy(logits, batch["labels"])
        return xe, {"xent": xe, "aux": aux}

    def init_cache(params, batch, max_len, enc_out=None, parallel=None):
        if enc_out is None:
            raise ValueError("the encoder-decoder cache needs enc_out")
        return encdec.init_decode_cache(params, cfg, batch, max_len, enc_out, parallel)

    def decode_step(params, token, cache, pos, parallel=None):
        return encdec.decode_step(params, token, cache, pos, cfg=cfg, parallel=parallel)

    def dummy_batch(batch, seq_len, device="cpu"):
        rng, toks, labels = _dummy_tokens(cfg, batch, seq_len)
        src = rng.normal(size=(batch, seq_len, cfg.d_model))
        return {"src_embeds": torch.as_tensor(src, dtype=torch.float32, device=device).to(
                    getattr(torch, cfg.dtype)),
                "tgt_tokens": torch.as_tensor(toks, device=device),
                "labels": torch.as_tensor(labels, device=device)}

    def input_specs(shape, parallel: Optional[ParallelContext] = None, device="meta"):
        """As the decoder-only ``input_specs``: train and prefill
        ``src_embeds`` (B, S, D) in the activation dtype, ``tgt_tokens`` and
        ``labels``; decode ``token``, ``pos`` and the cache of
        ``init_cache``'s layout: self ``k`` / ``v`` and each layer's cross
        K/V over an S-long source, ``(L, B, S, Hkv, hd)`` (on a rank of
        ``parallel``, its rows, kv heads and slabs)."""
        S = shape.seq_len
        B, positions = cache_extent(shape.global_batch, S, parallel)
        adt = getattr(torch, cfg.dtype)
        if shape.kind in ("train", "prefill"):
            return {"src_embeds": torch.empty((B, S, cfg.d_model), dtype=adt, device=device),
                    "tgt_tokens": torch.empty((B, S), dtype=TOKEN_DTYPE, device=device),
                    "labels": torch.empty((B, S), dtype=TOKEN_DTYPE, device=device)}
        kv = (cfg.n_layers, B, positions, len(kv_heads_of(cfg, parallel)),
              cfg.resolved_head_dim)
        return {"token": torch.empty((B, 1), dtype=TOKEN_DTYPE, device=device),
                "cache": {k: torch.empty(kv, dtype=adt, device=device)
                          for k in ("k", "v", "cross_k", "cross_v")},
                "pos": torch.empty((), dtype=TOKEN_DTYPE, device=device)}

    return Model(cfg, init, apply, loss_fn, init_cache, decode_step, dummy_batch, input_specs)
