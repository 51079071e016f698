"""SeamlessM4T-Large v2 [arXiv:2308.11596] (copy of
``repro.configs.seamless_m4t_large_v2``).

Encoder-decoder multimodal translation backbone: 24 encoder + 24 decoder
layers, d_model=1024, 16 heads MHA (kv=16), d_ff=8192, 256k vocabulary.

The speech frontend (mel-spectrogram + conformer feature extractor) is the
allowed stub, as in the reference: the encoder consumes precomputed frame
embeddings of shape (batch, src_len, d_model) (input_mode="embeddings").
Decoding runs the decoder one target token at a time against a
self-attention KV cache and the precomputed cross-attention K/V of the
encoder output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    use_rope=False,  # sinusoidal/relative in the original; attention without positions here
    mlp_type="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=24,
    input_mode="embeddings",
    dtype="bfloat16",
    source="arXiv:2308.11596",
)
