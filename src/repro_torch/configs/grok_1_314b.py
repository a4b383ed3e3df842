"""grok-1-314b — xAI Grok-1.

64L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=32768, vocab=131072,
8 experts top-2, 30.0 attention-logit softcap.  [hf:xai-org/grok-1; unverified]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec("attn", "moe"),),
    num_experts=8,
    moe_group_rows=8,   # rows merged per dispatch group (up to 8 slots)
    num_experts_per_token=2,
    attn_softcap=30.0,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
