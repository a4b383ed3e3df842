"""minitron-4b — NVIDIA Minitron 4B (pruned Nemotron).

32L d_model=3072 24H (GQA kv=8, head_dim=128) d_ff=9216, vocab=256000.
[arXiv:2407.14679; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10_000.0,
    tie_embeddings=False,
)
