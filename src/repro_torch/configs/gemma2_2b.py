"""gemma2-2b — Google Gemma 2 2B.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216, vocab=256000,
local(4096-window)/global alternating, attn softcap 50, final-logit softcap
30.  [arXiv:2408.00118; hf]

The port runs it reduced (:func:`repro_torch.configs.reduce_config`) in
this slice: the card's flash kernel takes head_dim 64 and 128, not 256.
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=(LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense")),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
