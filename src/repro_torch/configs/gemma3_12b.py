"""Gemma3-12B [hf:google/gemma-3-1b-pt family] (copy of
``repro.configs.gemma3_12b``).

Dense decoder with 5:1 local:global attention pattern (5 sliding-window
layers with w=1024, then 1 global layer, repeating — 128k context), GQA
16Q/8KV with head_dim=256, QK-norm, gated-GELU... we use gated_silu (GeGLU
and SwiGLU are isomorphic for system purposes), d_ff=15360, 262144 vocab.

The 5:1 sliding pattern makes 40 of 48 layers sub-quadratic; the 8 global
layers hold the (sequence-sharded) full cache → runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    use_rope=True,
    rope_theta=1_000_000.0,
    qk_norm=True,
    sliding_window=1024,
    local_global_pattern=(5, 1),
    mlp_type="gated_silu",
    dtype="bfloat16",
    source="hf:google/gemma-3-1b-pt",
)
