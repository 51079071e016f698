"""Qwen3-14B [hf:Qwen/Qwen3-8B family] (copy of
``repro.configs.qwen3_14b``).

Dense decoder with QK-RMSNorm (qk_norm — Qwen3's signature stabilization),
GQA 40Q/8KV (head_dim 128), gated-SiLU MLP d_ff=17408, 151936 vocab, RoPE.

long_500k SKIPPED (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    use_rope=True,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_type="gated_silu",
    dtype="bfloat16",
    source="hf:Qwen/Qwen3-8B",
)
