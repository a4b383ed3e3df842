"""granite-moe-3b-a800m — IBM Granite 3.0 3B-A800M MoE.

32L d_model=1536 24H (GQA kv=8, head_dim=64) expert d_ff=512, vocab=49155,
40 experts top-8.  [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]

The port serves it at full width on the card: a prompt longer than
``attn_block_q`` (512) and a multiple of it takes the flash kernel at
head width 64, and a wave's prompts (up to 8 rows) form one dispatch
group, so their capacity drops couple, as in the JAX package.
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(LayerSpec("attn", "moe"),),
    num_experts=40,
    moe_group_rows=8,   # rows merged per dispatch group (up to 8 slots)
    num_experts_per_token=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
