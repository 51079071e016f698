"""Plain PyTorch version of the flash-attention kernel (the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``).

Materializes the full (Sq, Skv) score matrix in f32 — O(S²) memory, the
function the kernel computes without it: GQA grouping (head h reads KV head
h // G), causal and sliding-window masks relative to ``q_offset``, softmax
in f32, and 0 for a row that keeps no key.  The output is in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,  # (B, Skv, Hkv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,  # absolute position of q[0]
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else hd ** -0.5

    qg = q.reshape(B, Sq, Hkv, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    s = s.reshape(B, H, Sq, Skv) * scale

    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros((), dtype=p.dtype, device=p.device), p)
    pg = p.reshape(B, Hkv, G, Sq, Skv)
    out = torch.einsum("bkgqs,bskh->bqkgh", pg, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)
