"""Chameleon-34B [arXiv:2405.09818] (copy of
``repro.configs.chameleon_34b``).

Early-fusion mixed-modal decoder: images are VQ-quantized into discrete
tokens drawn from the same 65536-entry vocabulary as text, so the backbone
is a plain (large) dense decoder — 48 layers, d_model=8192, GQA 64Q/8KV,
gated-SiLU d_ff=22016, RoPE, QK-norm (Chameleon uses qk-norm for training
stability at scale).

The VQ-VAE image tokenizer is the assignment's allowed stub: inputs are
already token ids (text + image tokens interleaved).  long_500k SKIPPED
(pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    use_rope=True,
    rope_theta=10000.0,
    qk_norm=True,
    mlp_type="gated_silu",
    dtype="bfloat16",
    source="arXiv:2405.09818",
)
