"""mistral-nemo-12b — Mistral-NeMo 12B (128k context).

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336, vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=1_000_000.0,     # 128k-context rope base
    tie_embeddings=False,
)
