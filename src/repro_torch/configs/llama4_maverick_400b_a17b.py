"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] (copy of
``repro.configs.llama4_maverick_400b_a17b``).

MoE decoder: 128 routed experts, top-1 routing, plus one shared expert;
MoE layers interleaved every other layer (interleave step 2 — this is what
reconciles 128 experts x 48 layers with the ~400B total / ~17B active
parameter budget).  GQA with 8 KV heads, RoPE, early-fusion multimodal (the
vision frontend is stubbed per the assignment; text/image tokens share the
202048-entry vocabulary).

long_500k is SKIPPED for this arch (global attention layers are
full-attention here; see DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    use_rope=True,
    rope_theta=500_000.0,
    mlp_type="gated_silu",
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    capacity_factor=1.25,
    dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
