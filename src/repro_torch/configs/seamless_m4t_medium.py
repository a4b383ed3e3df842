"""seamless-m4t-medium — Meta SeamlessM4T medium (enc-dec backbone).

12+12L d_model=1024 16H (kv=16, head_dim=64) d_ff=4096, vocab=256206.  The
speech frontend is a STUB: the encoder consumes precomputed frame embeddings;
the decoder is a standard causal LM with cross-attention.
[arXiv:2308.11596; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=(LayerSpec("attn", "dense", cross_attn=True),),
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_pattern=(LayerSpec("attn_bidir", "dense"),),
    frontend="audio",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
