"""Public flash-attention wrapper: ``(B, S, H, hd)`` layout, GQA,
causal / sliding window, ``q_offset``.

Routing is by device: tensors on the CPU take the plain version
(``ref.py``); CUDA tensors take the kernel, which launches or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """q ``(B, Sq, H, hd)``; k, v ``(B, Skv, Hkv, hd)``.  Returns
    ``(B, Sq, H, hd)`` in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset)
    return kernel.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale,
                                       q_offset=q_offset)
