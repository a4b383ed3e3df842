"""gemma2-2b — Google Gemma 2 2B.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216, vocab=256000,
local(4096-window)/global alternating, attn softcap 50, final-logit softcap
30.  [arXiv:2408.00118; hf]

The port serves it at full width on the card: the flash kernel is built
for head_dim 64, 128 and 256 (narrower widths are zero-padded).  A prompt longer than ``attn_block_q`` (512) and
a multiple of it takes the kernel; at 8192 tokens the local layers' window
drops KV blocks while the global layers stay causal over all of them.
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
