"""StarCoder2-7B [arXiv:2402.19173] (copy of
``repro.configs.starcoder2_7b``).

Dense decoder, GQA (36 query heads, 4 KV heads), RoPE, 4096-token sliding
window attention (per the StarCoder2 paper), standard (non-gated) GELU MLP
with 4x expansion, learned absolute-free (RoPE only).

Because every layer is sliding-window (w=4096), this arch is sub-quadratic
and runs the long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    use_rope=True,
    rope_theta=1_000_000.0,
    mlp_type="gelu",
    sliding_window=4096,
    dtype="bfloat16",
    source="arXiv:2402.19173",
)
