"""Decoder-only LM assembly for the dense, moe, ssm, hybrid and vlm families
(counterpart of ``repro.models.transformer``).

The layer stack keeps the reference's period layout: each architecture has
a static period of slots (gemma3: 5 local-attention slots + 1 global;
llama4-maverick: a dense slot + an MoE slot; zamba2: 5 mamba slots + 1
shared-attention slot, then tail mamba layers), and parameters (and
caches) are stacked on a leading ``n_periods`` axis, so a params tree
converts leaf for leaf.  Zamba2's shared attention block is one unstacked
parameter set in ``params["shared"]``, applied at every shared slot, with a
KV cache per application.  The reference's ``lax.scan`` over periods is a
Python loop here that indexes the stacked leaves (views, no copies), and
``remat="full"`` wraps each period in ``torch.utils.checkpoint`` as the
reference wraps its scan body in ``jax.checkpoint``; ``remat="dots"`` is
the reference's ``checkpoint_dots_with_no_batch_dims`` policy as a
selective checkpoint (``dots_policy``): the weight products' outputs are
kept, everything else is recomputed in backward.  The encoder-decoder
family lives in ``repro_torch.models.encdec``.

``parallel`` (a ``layers.ParallelContext``) runs the model on a group of
ranks that each hold their share of the weights
(``repro_torch.sharding.shard``): the layers' branches (the mamba2 block's
too, on the rank's SSD heads; zamba2's shared block as any attention and
MLP), plus the vocabulary split over the group for the embedding (a masked
local lookup, then an ``all_reduce``) and the logits (local columns, then
an ``all_gather`` along V).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (
    Keep,
    ParallelContext,
    cache_extent,
    embed_init,
    fsdp_gather,
    init_attention,
    init_mlp,
    init_moe,
    init_rmsnorm,
    keep_under,
    keep_whole,
    kv_heads_of,
    mlp,
    moe_dropping,
    rmsnorm,
    self_attention,
    split,
)
from repro_torch.sharding.rules import check_model_parallel
from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class SlotSpec:
    kind: str  # "attn" | "mamba"
    is_global: bool = True  # attention: full vs sliding window
    is_moe: bool = False
    shared: bool = False  # params live in params["shared"], not the stack


def period_layout(cfg) -> Tuple[List[SlotSpec], int, List[SlotSpec]]:
    """Returns ``(period_slots, n_periods, tail_slots)``, as the reference."""
    if cfg.family == "ssm":
        return [SlotSpec("mamba")], cfg.n_layers, []
    if cfg.family == "hybrid":
        period = cfg.attn_every
        slots = [SlotSpec("mamba")] * (period - 1) + [SlotSpec("attn", shared=True)]
        n_periods = cfg.n_layers // period
        return slots, n_periods, [SlotSpec("mamba")] * (cfg.n_layers - n_periods * period)
    # dense / moe / vlm: attention + ffn slots
    if cfg.local_global_pattern is not None:
        n_local, n_global = cfg.local_global_pattern
        slots = [SlotSpec("attn", is_global=False)] * n_local + \
            [SlotSpec("attn", is_global=True)] * n_global
    elif cfg.sliding_window is not None:
        slots = [SlotSpec("attn", is_global=False)]
    else:
        slots = [SlotSpec("attn", is_global=True)]
    if cfg.n_experts > 0 and cfg.moe_every > 1:
        # the period expands to moe_every slots, so MoE-ness is static per slot
        slots = [SlotSpec("attn", slots[i % len(slots)].is_global,
                          is_moe=i == cfg.moe_every - 1) for i in range(cfg.moe_every)]
    elif cfg.n_experts > 0:
        slots = [SlotSpec("attn", s.is_global, is_moe=True) for s in slots]
    if cfg.n_layers % len(slots):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a whole number of "
                         f"{len(slots)}-slot periods")
    return slots, cfg.n_layers // len(slots), []


# ----------------------------------------------------------------------- init
def _init_slot(generator, slot: SlotSpec, cfg, dtype, lead, device,
               keep: Keep = keep_whole) -> Dict[str, Any]:
    """One slot's params, every leaf with a leading ``lead`` axis (``(n,)``
    periods, or ``()`` for the shared block)."""
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, lead, device)}
    if slot.kind == "mamba":
        p["mamba"] = m2.init_mamba2(generator, cfg, dtype, lead, device,
                                    keep_under(keep, "mamba"))
        return p
    p["attn"] = init_attention(generator, cfg, dtype, lead, device, keep_under(keep, "attn"))
    p["norm2"] = init_rmsnorm(cfg.d_model, dtype, lead, device)
    if slot.is_moe:
        p["moe"] = init_moe(generator, cfg, dtype, lead, device, keep_under(keep, "moe"))
    elif cfg.d_ff > 0:
        p["mlp"] = init_mlp(generator, cfg, dtype=dtype, lead=lead, device=device,
                            keep=keep_under(keep, "mlp"))
    return p


def _stack_init(generator, n: int, slots: List[SlotSpec], cfg, dtype, device, keep: Keep):
    """n periods of params stacked on a leading axis; shared slots have none."""
    return {f"slot{i}": _init_slot(generator, s, cfg, dtype, (n,), device,
                                   keep_under(keep, f"slot{i}"))
            for i, s in enumerate(slots) if not s.shared}


def init_params(generator: torch.Generator, cfg, *, device=None,
                keep: Keep = keep_whole) -> Dict[str, Any]:
    """Random params from ``generator`` (drawn on its device, or on
    ``device``: ``"meta"`` gives the tree's shapes and draws nothing), in
    ``cfg.param_dtype`` (MoE routers f32), with the reference's tree
    layout.  ``keep(path, leaf)`` maps each leaf as it is drawn to what is
    kept of it (``layers.Keep``)."""
    dtype = getattr(torch, cfg.param_dtype)
    device = device or generator.device
    slots, n_periods, tail = period_layout(cfg)
    params: Dict[str, Any] = {
        "embed": keep(("embed",), embed_init(generator, (cfg.padded_vocab, cfg.d_model), dtype,
                                             device)),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device=device),
        "periods": _stack_init(generator, n_periods, slots, cfg, dtype, device,
                               keep_under(keep, "periods")),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = keep(("unembed",), embed_init(
            generator, (cfg.d_model, cfg.padded_vocab), dtype, device))
    if tail:
        params["tail"] = _stack_init(generator, len(tail), tail[:1], cfg, dtype, device,
                                     keep_under(keep, "tail"))
    if any(s.shared for s in slots):
        params["shared"] = _init_slot(generator, SlotSpec("attn"), cfg, dtype, (), device,
                                      keep_under(keep, "shared"))
    return params


# -------------------------------------------------------------------- forward
REMATS = ("none", "full", "dots")
# the products with no batch dimension: the weight products, which
# ``torch.matmul`` folds to a 2-d ``mm`` however many leading dims the
# activation has.  ``bmm`` / ``baddbmm`` (attention's scores and values, the
# experts' banks, the SSD einsums) have a batch dimension and are recomputed.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat(remat: str) -> None:
    """``"none"``, ``"full"`` or ``"dots"``."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


def dots_policy(ctx, op, *args, **kwargs):
    """The selective checkpoint policy of ``remat="dots"`` (the reference's
    ``checkpoint_dots_with_no_batch_dims``): keep the outputs of
    ``DOTS_SAVED``, recompute every other operation in backward."""
    if op in DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)`` under ``remat``: as it is (``"none"``), recomputed
    whole in backward (``"full"``), or recomputed but for the weight
    products' outputs (``"dots"``, ``dots_policy``, read at call time)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(dots_policy))


def _apply_slot(slot: SlotSpec, p, h, *, cfg, positions, cache_slot, cache_pos,
                emit_cache: bool, use_kernels: bool, parallel: Optional[ParallelContext]):
    """One slot (attention + MLP / MoE, or mamba).  Returns ``(h,
    new_cache_slot, aux)``; aux is None but for an MoE slot."""
    if slot.kind == "mamba":
        y, new_state = m2.mamba2_block(p["mamba"], rmsnorm(h, p["norm1"]), cfg=cfg,
                                       state=cache_slot, return_state=emit_cache,
                                       use_kernels=use_kernels, parallel=parallel)
        return h + y, new_state, None
    attn_out, new_kv = self_attention(
        p["attn"], rmsnorm(h, p["norm1"]), cfg=cfg, positions=positions,
        is_global=slot.is_global, cache=cache_slot, cache_pos=cache_pos,
        return_kv=emit_cache, use_kernels=use_kernels, parallel=parallel)
    h = h + attn_out
    aux = None
    if slot.is_moe:
        y, aux = moe_dropping(p["moe"], rmsnorm(h, p["norm2"]), cfg=cfg, parallel=parallel)
        h = h + y
    elif "mlp" in p:
        h = h + mlp(p["mlp"], rmsnorm(h, p["norm2"]), cfg=cfg, parallel=parallel)
    return h, new_kv, aux


def _run_period(slots, pp, shared, h, aux, cache_i, emit: bool, kw):
    """One period of ``slots``: returns ``(h, aux, emitted caches)``."""
    out_i = {}
    for j, slot in enumerate(slots):
        key = f"slot{j}"
        cslot = None if cache_i is None else cache_i[key]
        h, new_c, a = _apply_slot(slot, shared if slot.shared else pp[key], h,
                                  cache_slot=cslot, emit_cache=emit, **kw)
        if a is not None:
            aux = aux + a
        if cslot is not None:
            for name, view in cslot.items():
                if new_c[name] is not view:
                    view.copy_(new_c[name])
        elif new_c is not None:
            out_i[key] = new_c
    return h, aux, out_i


def _remat_period(slots, pp, at, shared, h, aux, remat: str, kw):
    """A training period (no cache) under ``remat_call``: its activations
    (``"full"``), or all but its weight products' outputs (``"dots"``), are
    recomputed in backward instead of kept."""
    def body(h_, aux_):
        return _run_period(slots, fsdp_gather(pp, kw["parallel"], at), shared, h_, aux_, None,
                           False, kw)[:2]

    return remat_call(body, remat, h, aux)


def _run_stack(slots, stacked, at, n: int, shared, h, aux, cache, emit: bool,
               remat: str = "none", **kw):
    """The reference's scan over ``n`` periods of ``slots``: returns ``(h,
    aux, emitted)``.  Decode (``cache`` given) writes every new cache leaf
    into the cache's stacked buffers in place; prefill with ``emit``
    returns the new caches stacked over periods.  On a grid each period's
    FSDP slices are gathered as the period is selected (``fsdp_gather``;
    ``at``: the stack's keys in the params tree), inside the checkpointed
    region under ``remat``."""
    emitted = []
    for i in range(n):
        pp = tree_map(lambda a: a[i], stacked)
        if remat != "none" and cache is None and not emit:
            h, aux = _remat_period(slots, pp, at, shared, h, aux, remat, kw)
            continue
        pp = fsdp_gather(pp, kw["parallel"], at)
        cache_i = None if cache is None else tree_map(lambda a: a[i], cache)
        h, aux, out_i = _run_period(slots, pp, shared, h, aux, cache_i, emit, kw)
        emitted.append(out_i)
    stacked_out = tree_map(lambda *xs: torch.stack(xs), *emitted) if emit else None
    return h, aux, stacked_out


def forward(params: Dict[str, Any], tokens: torch.Tensor, *, cfg,
            cache: Optional[Dict[str, Any]] = None, cache_pos: Optional[int] = None,
            return_cache: bool = False, use_kernels: bool = True, remat: str = "none",
            parallel: Optional[ParallelContext] = None):
    """Returns ``(logits (B, S, padded_vocab), new_cache, aux)``; ``aux`` is
    the reference's auxiliary loss (f32): the MoE slots' load-balance and
    router z-losses summed over slots in order, 0 without experts.

    With ``cache`` (decode, S = 1 at position ``cache_pos``) every layer
    writes its new K/V, SSM and conv states into the cache's stacked
    buffers in place and the same tree is returned.  With
    ``return_cache`` and no cache (prefill) the per-layer K/V (attention)
    or final SSM + conv states (mamba) come back stacked over periods
    (and over the tail layers).

    ``use_kernels`` sends prefill attention and the SSD scan through the
    kernels (serving); training passes False, the reference's plain route,
    since the kernels have no backward.  ``remat`` is ``"none"``, ``"full"``
    or ``"dots"`` (each period under ``remat_call``).

    With ``parallel`` every rank passes the same tokens and its share of
    the params, and gets the whole logits and its share of the cache."""
    check_remat(remat)
    if parallel is not None:
        check_model_parallel(cfg, parallel.size)
    slots, n_periods, tail = period_layout(cfg)
    adtype = getattr(torch, cfg.dtype)
    dev = tokens.device
    embed = fsdp_gather({"embed": params["embed"]}, parallel)["embed"]
    h = embed_tokens(embed, tokens, cfg, adtype, parallel)
    B, S = tokens.shape
    if cache is None:
        positions = torch.arange(S, device=dev)
    else:
        positions = torch.full((1,), int(cache_pos), device=dev)
    emit = return_cache and cache is None
    kw = dict(cfg=cfg, positions=positions, cache_pos=cache_pos, use_kernels=use_kernels,
              parallel=parallel)
    shared = params.get("shared")
    if shared is not None:  # read by every shared slot: gathered once a forward
        shared = fsdp_gather(shared, parallel, ("shared",))

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    h, aux, out_periods = _run_stack(slots, params["periods"], ("periods",), n_periods, shared,
                                     h, aux,
                                     None if cache is None else cache["periods"], emit, remat,
                                     **kw)
    if tail:
        h, aux, out_tail = _run_stack(tail[:1], params["tail"], ("tail",), len(tail), shared, h,
                                      aux,
                                      None if cache is None else cache["tail"], emit, remat,
                                      **kw)
    new_cache = cache
    if emit:
        new_cache = {"periods": out_periods}
        if tail:
            new_cache["tail"] = out_tail

    h = rmsnorm(h, params["final_norm"])
    unembed = (embed.T if cfg.tie_embeddings
               else fsdp_gather({"unembed": params["unembed"]}, parallel)["unembed"])
    return unembed_logits(h, unembed, cfg, parallel), new_cache, aux


def unembed_logits(h: torch.Tensor, unembed: torch.Tensor, cfg,
                   parallel: Optional[ParallelContext]) -> torch.Tensor:
    """``h @ unembed`` in ``h``'s dtype; over a group the rank's vocabulary
    columns, joined along V by an ``all_gather`` when they split."""
    if not split(parallel, unembed.shape[-1], cfg.padded_vocab):
        return torch.matmul(h, unembed.to(h.dtype))
    logits = torch.matmul(parallel.copy_in(h), unembed.to(h.dtype))
    return parallel.join(logits, dim=-1)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, cfg, adtype,
                 parallel: Optional[ParallelContext]) -> torch.Tensor:
    """The scaled embedding of ``tokens``.  A rank that holds rows ``[lo,
    lo + V / N)`` of the table looks up the tokens that fall there, zeros
    elsewhere, and an ``all_reduce`` adds the one nonzero row each token
    has: the same values as the whole table's lookup."""
    # the scale is cast to the activation dtype first, as JAX's weakly typed
    # Python scalar is (a device fill: no host-to-device copy, no sync)
    scale = torch.full((), cfg.d_model ** 0.5, dtype=adtype, device=tokens.device)
    rows = table.shape[0]
    if not split(parallel, rows, cfg.padded_vocab):
        return table[tokens].to(adtype) * scale
    local = tokens - parallel.rank * rows
    mine = (local >= 0) & (local < rows)
    h = torch.where(mine[..., None], table[local.clamp(0, rows - 1)].to(adtype), 0)
    return parallel.sum(h) * scale


# ---------------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
               parallel: Optional[ParallelContext] = None) -> Dict[str, Any]:
    """Zero cache in the period layout: attention slots {"k","v"}
    (n_periods, B, max_len, Hkv, hd), Hkv this rank's kv heads over a
    group (``layers.kv_heads_of``); mamba slots {"ssm","conv"} stacked
    likewise, over a group on the rank's SSD heads
    (``mamba2.init_mamba2_state``); the tail's mamba layers under
    ``"tail"``.  ``batch`` and ``max_len`` are the served batch's and the
    whole sequence's: on a grid the rank holds its block of the rows, or
    every row and its slab of each attention cache's sequence, with its
    mamba states whole (``layers.cache_extent``)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    slots, n_periods, tail = period_layout(cfg)
    rows, positions = cache_extent(batch, max_len, parallel)

    def slot_cache(slot: SlotSpec, n: int):
        if slot.kind == "mamba":
            return m2.init_mamba2_state(cfg, rows, dtype, (n,), device, parallel)
        shape = (n, rows, positions, len(kv_heads_of(cfg, parallel)), cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"periods": {f"slot{i}": slot_cache(s, n_periods) for i, s in enumerate(slots)}}
    if tail:
        cache["tail"] = {"slot0": slot_cache(tail[0], len(tail))}
    return cache
