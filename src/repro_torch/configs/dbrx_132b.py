"""DBRX-132B [hf:databricks/dbrx-base] (copy of
``repro.configs.dbrx_132b``).

Fine-grained MoE decoder: 16 experts, top-4 routing, every layer is MoE.
GQA (48 query heads, 8 KV heads), RoPE, gated-GLU experts with d_ff=10752.

long_500k is SKIPPED (pure full attention; see DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    use_rope=True,
    rope_theta=500_000.0,
    mlp_type="gated_silu",
    n_experts=16,
    top_k=4,
    moe_every=1,
    capacity_factor=1.25,
    dtype="bfloat16",
    source="hf:databricks/dbrx-base",
)
