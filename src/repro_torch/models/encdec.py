"""Encoder-decoder backbone, the SeamlessM4T family (counterpart of
``repro.models.encdec``).

The speech frontend is the allowed stub, as in the reference: the encoder
consumes precomputed frame embeddings ``(B, S_src, D)``.  After that: a
bidirectional encoder stack, a causal decoder stack with cross-attention,
teacher-forced training (``decode_train``), and incremental decoding
(``decode_step``) against a self-attention KV cache written in place at
``pos`` and the cross-attention K/V precomputed once per layer
(``init_decode_cache``).

Layers are stacked on a leading axis (``params["enc"]``, ``params["dec"]``)
as the reference's ``vmap``-ed init lays them out; its ``lax.scan`` over
layers is a Python loop over views.  ``encode`` with ``use_kernels`` sends
the encoder's bidirectional attention through the flash-attention kernel
(``causal=False``), as serving prefill does; training, ``decode_train`` and
the decoder's attention take the reference's plain route.

``parallel`` (a ``layers.ParallelContext``) runs the model on a group of
ranks that each hold their share of the weights
(``repro_torch.sharding.shard``), as the decoder-only model does: the
encoder's and the decoder's attention on the rank's heads, the
cross-attention's K/V of the rank's kv heads (computed once a layer, held
so in the decode cache), the MLP's hidden columns, each with one
``all_reduce``; the vocabulary-split embedding and logits.  On a grid's
FSDP storage each layer's slices are gathered where the stack selects the
layer, inside its checkpointed region (``layers.fsdp_gather``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    BLOCKED_ATTENTION_THRESHOLD,
    Keep,
    ParallelContext,
    _project,
    apply_rope,
    attend_blocked,
    attend_direct,
    cache_extent,
    cross_attention,
    embed_init,
    encode_kv,
    fsdp_gather,
    heads_out,
    init_attention,
    init_mlp,
    init_rmsnorm,
    into_heads,
    keep_under,
    keep_whole,
    kv_heads_of,
    mlp,
    pick_kv_heads,
    rmsnorm,
    self_attention,
    seq_split,
)
from repro_torch.models.transformer import check_remat, embed_tokens, unembed_logits
from repro_torch.sharding.rules import seq_slab
from repro_torch.utils.trees import tree_map


def init_params(generator: torch.Generator, cfg, *, device=None,
                keep: Keep = keep_whole) -> Dict[str, Any]:
    """Random params from ``generator`` (on its device, or on ``device``:
    ``"meta"`` gives the shapes alone) in ``cfg.param_dtype``, in the
    reference's tree layout: untied ``embed`` / ``unembed``, the ``enc`` and
    ``dec`` stacks, ``enc_norm`` and ``dec_norm``.  ``keep(path, leaf)``
    maps each leaf as it is drawn to what is kept of it (``layers.Keep``)."""
    dtype = getattr(torch, cfg.param_dtype)
    dev = device or generator.device
    D, V = cfg.d_model, cfg.padded_vocab
    le, ld = (cfg.n_encoder_layers,), (cfg.n_layers,)
    return {
        "embed": keep(("embed",), embed_init(generator, (V, D), dtype, dev)),
        "unembed": keep(("unembed",), embed_init(generator, (D, V), dtype, dev)),
        "enc": {"norm1": init_rmsnorm(D, dtype, le, dev),
                "attn": init_attention(generator, cfg, dtype, le, dev,
                                       keep_under(keep, "enc", "attn")),
                "norm2": init_rmsnorm(D, dtype, le, dev),
                "mlp": init_mlp(generator, cfg, dtype=dtype, lead=le, device=dev,
                                keep=keep_under(keep, "enc", "mlp"))},
        "dec": {"norm1": init_rmsnorm(D, dtype, ld, dev),
                "self_attn": init_attention(generator, cfg, dtype, ld, dev,
                                            keep_under(keep, "dec", "self_attn")),
                "norm_x": init_rmsnorm(D, dtype, ld, dev),
                "cross_attn": init_attention(generator, cfg, dtype, ld, dev,
                                             keep_under(keep, "dec", "cross_attn")),
                "norm2": init_rmsnorm(D, dtype, ld, dev),
                "mlp": init_mlp(generator, cfg, dtype=dtype, lead=ld, device=dev,
                                keep=keep_under(keep, "dec", "mlp"))},
        "enc_norm": init_rmsnorm(D, dtype, device=dev),
        "dec_norm": init_rmsnorm(D, dtype, device=dev),
    }


def _layers(stacked, n: int):
    for i in range(n):
        yield tree_map(lambda a: a[i], stacked)


def _maybe_remat(fn, remat: str, h):
    """A layer under ``remat``; ``"dots"`` is ``"full"`` here, as in the
    reference's encoder-decoder."""
    return checkpoint(fn, h, use_reentrant=False) if remat in ("full", "dots") else fn(h)


def _embed(params, tokens, cfg, parallel: Optional[ParallelContext]) -> torch.Tensor:
    embed = fsdp_gather({"embed": params["embed"]}, parallel)["embed"]
    return embed_tokens(embed, tokens, cfg, getattr(torch, cfg.dtype), parallel)


def encode(params, src_embeds: torch.Tensor, *, cfg, use_kernels: bool = False,
           remat: str = "none", parallel: Optional[ParallelContext] = None) -> torch.Tensor:
    """src_embeds ``(B, S_src, D)`` from the (stubbed) frontend →
    ``(B, S_src, D)`` in the activation dtype.  Bidirectional attention:
    through the flash kernel with ``use_kernels``, else ``attend_direct``
    (``attend_blocked`` from ``BLOCKED_ATTENTION_THRESHOLD`` frames); over a
    group on the rank's heads, summed by one ``all_reduce`` after ``wo``."""
    check_remat(remat)
    h = src_embeds.to(getattr(torch, cfg.dtype))
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    scale = cfg.resolved_head_dim ** -0.5

    def layer(lp, h):
        p = lp["attn"]
        x = into_heads(rmsnorm(h, lp["norm1"]), p["wq"], cfg, parallel)
        q = _project(x, p["wq"])
        k = pick_kv_heads(_project(x, p["wk"]), cfg, parallel)
        v = pick_kv_heads(_project(x, p["wv"]), cfg, parallel)
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if use_kernels:
            a = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                                scale=scale)
        elif S >= BLOCKED_ATTENTION_THRESHOLD:
            a = attend_blocked(q, k, v, causal=False, window=None, scale=scale,
                               q_positions=positions, kv_positions=positions)
        else:
            a = attend_direct(q, k, v, torch.ones((1, 1, S, S), dtype=torch.bool,
                                                  device=h.device), scale)
        h = h + heads_out(a, p["wo"], cfg, parallel)
        return h + mlp(lp["mlp"], rmsnorm(h, lp["norm2"]), cfg=cfg, parallel=parallel)

    for lp in _layers(params["enc"], cfg.n_encoder_layers):
        h = _maybe_remat(lambda h_, lp=lp: layer(fsdp_gather(lp, parallel, ("enc",)), h_), remat,
                         h)
    return rmsnorm(h, params["enc_norm"])


def decode_train(params, tgt_tokens: torch.Tensor, enc_out: torch.Tensor, *, cfg,
                 remat: str = "none", parallel: Optional[ParallelContext] = None
                 ) -> torch.Tensor:
    """Teacher-forced decoder on the plain route: tgt_tokens ``(B, S_tgt)`` →
    logits ``(B, S_tgt, padded_vocab)`` in the activation dtype."""
    check_remat(remat)
    h = _embed(params, tgt_tokens, cfg, parallel)
    positions = torch.arange(tgt_tokens.shape[1], device=h.device)

    def layer(lp, h):
        a, _ = self_attention(lp["self_attn"], rmsnorm(h, lp["norm1"]), cfg=cfg,
                              positions=positions, is_global=True, use_kernels=False,
                              parallel=parallel)
        h = h + a
        kv = encode_kv(lp["cross_attn"], enc_out, cfg=cfg, parallel=parallel)
        h = h + cross_attention(lp["cross_attn"], rmsnorm(h, lp["norm_x"]), kv, cfg=cfg,
                                parallel=parallel)
        return h + mlp(lp["mlp"], rmsnorm(h, lp["norm2"]), cfg=cfg, parallel=parallel)

    for lp in _layers(params["dec"], cfg.n_layers):
        h = _maybe_remat(lambda h_, lp=lp: layer(fsdp_gather(lp, parallel, ("dec",)), h_), remat,
                         h)
    h = rmsnorm(h, params["dec_norm"])
    unembed = fsdp_gather({"unembed": params["unembed"]}, parallel)["unembed"]
    return unembed_logits(h, unembed, cfg, parallel)


def init_decode_cache(params, cfg, batch: int, max_len: int, enc_out: torch.Tensor,
                      parallel: Optional[ParallelContext] = None) -> Dict[str, torch.Tensor]:
    """Zero self-attention cache ``k`` / ``v`` ``(L, B, max_len, Hkv, hd)`` in
    the activation dtype, and each decoder layer's cross-attention K/V of
    ``enc_out``, ``cross_k`` / ``cross_v`` ``(L, B, S_src, Hkv, hd)``; over a
    group Hkv is the rank's kv heads (``layers.kv_heads_of``) in both.  On
    a grid ``batch`` and ``max_len`` are the served batch's and the whole
    sequence's, and ``enc_out`` the encoding of the rows the rank serves:
    its block of them, or every row, when the data group splits the
    sequence, with the rank's slab of each sequence, the source's too
    (``layers.cache_extent``)."""
    rows, positions = cache_extent(batch, max_len, parallel)
    shape = (cfg.n_layers, rows, positions, len(kv_heads_of(cfg, parallel)),
             cfg.resolved_head_dim)
    dtype = getattr(torch, cfg.dtype)
    cross = [encode_kv(fsdp_gather(lp, parallel, ("dec",))["cross_attn"], enc_out, cfg=cfg,
                       parallel=parallel)
             for lp in _layers(params["dec"], cfg.n_layers)]
    if seq_split(parallel):
        lo, n = seq_slab(enc_out.shape[1], parallel.data_size, parallel.data_rank)
        cross = [{k: t[:, lo:lo + n] for k, t in c.items()} for c in cross]
    return {"k": torch.zeros(shape, dtype=dtype, device=enc_out.device),
            "v": torch.zeros(shape, dtype=dtype, device=enc_out.device),
            "cross_k": torch.stack([c["k"] for c in cross]),
            "cross_v": torch.stack([c["v"] for c in cross])}


def decode_step(params, token: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int, *,
                cfg, parallel: Optional[ParallelContext] = None):
    """token ``(B, 1)`` at position ``pos`` → ``(logits (B, 1, V), cache)``;
    each layer writes its K/V into ``cache`` at ``pos`` in place, and the
    same dict is returned.  On a grid's FSDP storage each layer's slices
    are gathered as the stack selects it, and ``unembed`` where it is read."""
    h = _embed(params, token, cfg, parallel)
    positions = torch.full((1,), int(pos), device=h.device)
    for i, lp in enumerate(_layers(params["dec"], cfg.n_layers)):
        lp = fsdp_gather(lp, parallel, ("dec",))
        a, _ = self_attention(lp["self_attn"], rmsnorm(h, lp["norm1"]), cfg=cfg,
                              positions=positions, is_global=True,
                              cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=pos,
                              parallel=parallel)
        h = h + a
        h = h + cross_attention(lp["cross_attn"], rmsnorm(h, lp["norm_x"]),
                                {"k": cache["cross_k"][i], "v": cache["cross_v"][i]}, cfg=cfg,
                                parallel=parallel)
        h = h + mlp(lp["mlp"], rmsnorm(h, lp["norm2"]), cfg=cfg, parallel=parallel)
    h = rmsnorm(h, params["dec_norm"])
    unembed = fsdp_gather({"unembed": params["unembed"]}, parallel)["unembed"]
    return unembed_logits(h, unembed, cfg, parallel), cache
