"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] (copy of
``repro.configs.llama3_2_1b``).

Small dense llama3: 16 layers, d_model=2048, GQA 32Q/8KV heads (head_dim
64), gated-SiLU MLP d_ff=8192, 128256 vocab, tied embeddings, RoPE
theta=500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    use_rope=True,
    rope_theta=500_000.0,
    mlp_type="gated_silu",
    tie_embeddings=True,
    dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-1B",
)
