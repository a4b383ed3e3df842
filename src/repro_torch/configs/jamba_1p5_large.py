"""jamba-1.5-large-398b — AI21 Jamba 1.5 Large (hybrid Mamba+attention MoE).

72L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=24576, vocab=65536,
16 experts top-2.  Pattern block of 8: attention at index 4, Mamba elsewhere
(1:7 interleave); MoE on odd layers.  Mamba: d_inner=16384, head_dim=64
(256 heads), state=128.  [arXiv:2403.19887; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec("attn" if i == 4 else "mamba",
              "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    num_experts=16,
    moe_group_rows=8,   # rows merged per dispatch group (up to 8 slots)
    num_experts_per_token=2,
    ssm_state=128,
    mamba_head_dim=64,
    mamba_expand=2,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
