"""Mamba2-1.3B [arXiv:2405.21060] (copy of ``repro.configs.mamba2_1_3b``).

Attention-free SSM decoder using SSD (state-space duality): 48 layers,
d_model=2048, ssm_state=128, expand=2, head_dim=64 (→ 64 SSD heads),
short causal conv k=4, vocab 50280 (GPT-NeoX tokenizer).  d_ff=0: blocks
are pure mamba2 (no separate MLP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=None,
    d_ff=0,
    vocab_size=50280,
    use_rope=False,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2405.21060",
)
