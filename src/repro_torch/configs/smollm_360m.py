"""smollm-360m — HuggingFace SmolLM 360M (llama-arch small).

32L d_model=960 15H (GQA kv=5, head_dim=64) d_ff=2560, vocab=49152.
[hf:HuggingFaceTB/SmolLM-360M; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10_000.0,
    tie_embeddings=True,
)
