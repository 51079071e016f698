"""Layers (counterpart of ``repro.models.layers``): the initializers, norms,
rotary embeddings, self-attention and gated-SiLU MLP of the LM serving
slice, as plain functions over dict param trees with the reference's keys
and layouts.

Conventions as in the reference: activations ``(B, S, D)``, attention heads
``(B, S, H, hd)``; norms and softmax compute in f32 whatever the activation
dtype; every weight is cast to the activation dtype where it is used.
Prefill attention goes through the flash-attention kernel
(``repro_torch.kernels.flash_attention``); decode attends over the cache
with plain PyTorch ops (``attend_direct``), as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Scaled normal init: std = 1/sqrt(fan_in), drawn from ``generator``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (std * w).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return (0.02 * w).to(dtype)


# ---------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32; ``scale`` is stored as (scale − 1)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def init_rmsnorm(d: int, dtype=torch.float32, lead: Sequence[int] = (), device=None):
    return torch.zeros((*lead, d), dtype=dtype, device=device)  # stored as (scale - 1)


# --------------------------------------------------------------- rotary embeddings
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) int.  Split-halves convention."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.to(torch.float32)[:, None] * freqs  # (S, hd/2)
    angles = angles[None, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
def init_attention(generator, cfg, dtype=torch.float32, lead: Sequence[int] = (),
                   device=None) -> Dict[str, torch.Tensor]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, (*lead, D, H, hd), in_axis_size=D, dtype=dtype, device=device),
        "wk": dense_init(generator, (*lead, D, Hkv, hd), in_axis_size=D, dtype=dtype,
                         device=device),
        "wv": dense_init(generator, (*lead, D, Hkv, hd), in_axis_size=D, dtype=dtype,
                         device=device),
        "wo": dense_init(generator, (*lead, H, hd, D), in_axis_size=H * hd, dtype=dtype,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, lead, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, lead, device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: (B, S, D) × (D, H, hd) → (B, S, H, hd)."""
    B, S, D = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(D, -1)).reshape(B, S, *w.shape[1:])


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k: (B,Skv,Hkv,hd) -> (B,H,Sq,Skv) f32, GQA-grouped.  The
    product runs in the input dtype and is upcast after, as in the reference."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,H,Sq,Skv)  v: (B,Skv,Hkv,hd) -> (B,Sq,H,hd)."""
    B, H, Sq, Skv = probs.shape
    Hkv = v.shape[2]
    pg = probs.reshape(B, Hkv, H // Hkv, Sq, Skv)
    out = torch.einsum("bkgqs,bskh->bqkgh", pg, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attend_direct(q, k, v, mask, scale: float) -> torch.Tensor:
    """Attention with a materialized score matrix.  mask: broadcastable to
    (B,H,Sq,Skv), True = keep; a masked score is −1e30, as in the reference."""
    s = _gqa_scores(q, k) * scale
    s = torch.where(mask, s, torch.full((), -1e30, dtype=torch.float32, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_combine(p, v)


def self_attention(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,  # (S,) absolute positions of x's tokens
    is_global: bool,  # full attention vs sliding window
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"}: (B, S_max, Hkv, hd)
    cache_pos: Optional[int] = None,  # decode: write index
    return_kv: bool = False,  # prefill: emit this segment's K/V as a cache
):
    """Returns ``(out, new_cache)``; decode mode iff ``cache`` is given.

    Prefill runs causal attention over x itself through the flash-attention
    kernel.  Decode writes the token's k/v into ``cache`` at ``cache_pos``
    IN PLACE (the reference's serving loop donates the cache to the same
    end) and attends over the cache; ``new_cache`` holds the same tensors."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = None if is_global else cfg.sliding_window

    if cache is None:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                              window=window, scale=scale)
        new_cache = {"k": k, "v": v} if return_kv else None
    else:
        kc, vc = cache["k"], cache["v"]
        S_max = kc.shape[1]
        kc[:, cache_pos:cache_pos + S] = k.to(kc.dtype)
        vc[:, cache_pos:cache_pos + S] = v.to(vc.dtype)
        kv_positions = torch.arange(S_max, device=x.device)
        valid = kv_positions <= cache_pos
        if window is not None:
            valid &= kv_positions > cache_pos - window
        out = attend_direct(q, kc, vc, valid[None, None, None, :], scale)
        new_cache = {"k": kc, "v": vc}

    o = torch.matmul(out.reshape(B, S, -1), params["wo"].to(x.dtype).reshape(-1, D))
    return o, new_cache


# ------------------------------------------------------------------------ MLP
def init_mlp(generator, cfg, d_ff: Optional[int] = None, dtype=torch.float32,
             lead: Sequence[int] = (), device=None) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": dense_init(generator, (*lead, D, Fd), in_axis_size=D, dtype=dtype,
                             device=device),
        "w_up": dense_init(generator, (*lead, D, Fd), in_axis_size=D, dtype=dtype,
                           device=device),
        "w_down": dense_init(generator, (*lead, Fd, D), in_axis_size=Fd, dtype=dtype,
                             device=device),
    }


def mlp(params: Dict[str, Any], x: torch.Tensor, *, cfg) -> torch.Tensor:
    """Gated SiLU MLP (the port's only ``mlp_type``)."""
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    u = torch.matmul(x, params["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, params["w_down"].to(x.dtype))
