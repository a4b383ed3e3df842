"""mamba2-2.7b — Mamba-2 2.7B (SSD, attention-free).

64L d_model=2560, d_inner=5120 (expand 2, head_dim=64 → 80 heads),
state=128, vocab=50280.  [arXiv:2405.21060; unverified]

The port serves it at full width on the card; attention-free, it launches
no flash kernel, and its cache is a float32 ``MambaState`` a layer.
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,        # unused: attention-free
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec("mamba", "none"),),
    ssm_state=128,
    mamba_head_dim=64,
    mamba_expand=2,
    tie_embeddings=True,
)
