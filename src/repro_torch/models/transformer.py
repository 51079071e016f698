"""Decoder-only LM assembly for the dense and ssm families (counterpart of
``repro.models.transformer``).

The layer stack keeps the reference's period layout: each architecture has
a static period of slots, and parameters (and caches) are stacked on a
leading ``n_periods`` axis, so a params tree converts leaf for leaf.  The
reference's ``lax.scan`` over periods is a Python loop here that indexes
the stacked leaves (views, no copies).  The hybrid, MoE, VLM and
encoder-decoder families are not ported (ROADMAP A.15) and are refused by
``period_layout``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (
    embed_init,
    init_attention,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    self_attention,
)
from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class SlotSpec:
    kind: str  # "attn" | "mamba"
    is_global: bool = True  # attention: full vs sliding window


def period_layout(cfg) -> Tuple[List[SlotSpec], int]:
    """Returns ``(period_slots, n_periods)`` for the dense and ssm families;
    raises ``NotImplementedError`` for the families the port does not run."""
    if cfg.family == "ssm":
        return [SlotSpec("mamba")], cfg.n_layers
    if cfg.family != "dense" or cfg.n_experts > 0 or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (experts={cfg.n_experts}) is not ported yet "
            f"(ROADMAP A.15); the port runs the dense and ssm families")
    if cfg.mlp_type != "gated_silu":
        raise NotImplementedError(f"{cfg.name}: mlp_type {cfg.mlp_type!r} is not ported yet "
                                  f"(ROADMAP A.15); the port runs gated_silu")
    if cfg.local_global_pattern is not None:
        n_local, n_global = cfg.local_global_pattern
        slots = [SlotSpec("attn", is_global=False)] * n_local + \
            [SlotSpec("attn", is_global=True)] * n_global
    elif cfg.sliding_window is not None:
        slots = [SlotSpec("attn", is_global=False)]
    else:
        slots = [SlotSpec("attn", is_global=True)]
    if cfg.n_layers % len(slots):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a whole number of "
                         f"{len(slots)}-slot periods")
    return slots, cfg.n_layers // len(slots)


# ----------------------------------------------------------------------- init
def _init_slot(generator, slot: SlotSpec, cfg, dtype, n: int, device) -> Dict[str, Any]:
    """One slot's params, every leaf with a leading (n,) periods axis."""
    lead = (n,)
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, lead, device)}
    if slot.kind == "mamba":
        p["mamba"] = m2.init_mamba2(generator, cfg, dtype, lead, device)
        return p
    p["attn"] = init_attention(generator, cfg, dtype, lead, device)
    p["norm2"] = init_rmsnorm(cfg.d_model, dtype, lead, device)
    if cfg.d_ff > 0:
        p["mlp"] = init_mlp(generator, cfg, dtype=dtype, lead=lead, device=device)
    return p


def init_params(generator: torch.Generator, cfg) -> Dict[str, Any]:
    """Random params from ``generator`` (drawn on its device), in
    ``cfg.param_dtype``, with the reference's tree layout."""
    dtype = getattr(torch, cfg.param_dtype)
    device = generator.device
    slots, n_periods = period_layout(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model), dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device=device),
        "periods": {f"slot{i}": _init_slot(generator, s, cfg, dtype, n_periods, device)
                    for i, s in enumerate(slots)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(generator, (cfg.d_model, cfg.padded_vocab), dtype, device)
    return params


# -------------------------------------------------------------------- forward
def _apply_slot(slot: SlotSpec, p, h, *, cfg, positions, cache_slot, cache_pos,
                emit_cache: bool):
    """One slot (attention + MLP, or mamba).  Returns (h, new_cache_slot)."""
    if slot.kind == "mamba":
        y, new_state = m2.mamba2_block(p["mamba"], rmsnorm(h, p["norm1"]), cfg=cfg,
                                       state=cache_slot, return_state=emit_cache)
        return h + y, new_state
    attn_out, new_kv = self_attention(
        p["attn"], rmsnorm(h, p["norm1"]), cfg=cfg, positions=positions,
        is_global=slot.is_global, cache=cache_slot, cache_pos=cache_pos,
        return_kv=emit_cache)
    h = h + attn_out
    if "mlp" in p:
        h = h + mlp(p["mlp"], rmsnorm(h, p["norm2"]), cfg=cfg)
    return h, new_kv


def forward(params: Dict[str, Any], tokens: torch.Tensor, *, cfg,
            cache: Optional[Dict[str, Any]] = None, cache_pos: Optional[int] = None,
            return_cache: bool = False):
    """Returns ``(logits (B, S, padded_vocab), new_cache, aux)``; ``aux`` is
    the reference's auxiliary loss, 0 for the dense and ssm families.

    With ``cache`` (decode, S = 1 at position ``cache_pos``) every layer
    writes its new K/V, SSM and conv states into the cache's stacked
    buffers in place and the same tree is returned.  With
    ``return_cache`` and no cache (prefill) the per-layer K/V (attention)
    or final SSM + conv states (mamba) come back stacked over periods."""
    slots, n_periods = period_layout(cfg)
    adtype = getattr(torch, cfg.dtype)
    dev = tokens.device
    # the scale is cast to the activation dtype first, as JAX's weakly typed
    # Python scalar is (a device fill: no host-to-device copy, no sync)
    h = params["embed"][tokens].to(adtype) * torch.full((), cfg.d_model ** 0.5, dtype=adtype,
                                                         device=dev)
    B, S = tokens.shape
    if cache is None:
        positions = torch.arange(S, device=dev)
    else:
        positions = torch.full((1,), int(cache_pos), device=dev)
    emit = return_cache and cache is None

    emitted = []
    for i in range(n_periods):
        pp = tree_map(lambda a: a[i], params["periods"])
        cache_i = None if cache is None else tree_map(lambda a: a[i], cache["periods"])
        out_i = {}
        for j, slot in enumerate(slots):
            key = f"slot{j}"
            cslot = None if cache_i is None else cache_i[key]
            h, new_c = _apply_slot(slot, pp[key], h, cfg=cfg, positions=positions,
                                   cache_slot=cslot, cache_pos=cache_pos, emit_cache=emit)
            if cslot is not None:
                for name, view in cslot.items():
                    if new_c[name] is not view:
                        view.copy_(new_c[name])
            elif new_c is not None:
                out_i[key] = new_c
        emitted.append(out_i)

    new_cache = cache
    if emit:
        new_cache = {"periods": tree_map(lambda *xs: torch.stack(xs), *emitted)}

    h = rmsnorm(h, params["final_norm"])
    unembed = (params["embed"].T if cfg.tie_embeddings else params["unembed"]).to(adtype)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.matmul(h, unembed), new_cache, aux


# ---------------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> Dict[str, Any]:
    """Zero cache in the period layout: attention slots {"k","v"}
    (n_periods, B, max_len, Hkv, hd); mamba slots {"ssm","conv"} stacked
    likewise."""
    dtype = dtype or getattr(torch, cfg.dtype)
    slots, n_periods = period_layout(cfg)

    def slot_cache(slot: SlotSpec):
        if slot.kind == "mamba":
            return m2.init_mamba2_state(cfg, batch, dtype, (n_periods,), device)
        shape = (n_periods, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"periods": {f"slot{i}": slot_cache(s) for i, s in enumerate(slots)}}
