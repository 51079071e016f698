"""Zamba2-7B [arXiv:2411.15242] (copy of
``repro.configs.zamba2_7b``).

Hybrid: a Mamba2 backbone with a *shared* attention+MLP block inserted
periodically (weights reused at every insertion — Zamba's signature trick
for attention quality at near-SSM parameter cost).  81 layers total,
d_model=3584, ssm_state=64; the shared attention block is 32-head MHA
(kv=32) with d_ff=14336.

We realize the insertion as: layer i is the shared attention block iff
i % attn_every == attn_every-1 with attn_every=6 → 13 attention
applications + 68 mamba2 layers (all attention applications share one
parameter set).

Sub-quadratic overall (SSM layers O(1) state; the 13 shared-attn layers
hold a sharded KV cache) → runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    use_rope=True,
    rope_theta=10000.0,
    mlp_type="gated_silu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    attn_every=6,
    dtype="bfloat16",
    source="arXiv:2411.15242",
)
