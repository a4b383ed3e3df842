"""phi-3-vision-4.2b — Microsoft Phi-3-vision (phi3-mini backbone + CLIP stub).

32L d_model=3072 32H (kv=32, head_dim=96) d_ff=8192, vocab=32064.  The CLIP
frontend is a STUB: the batch's ``prefix_embeds`` hold precomputed patch
embeddings (576 tokens), projected and prepended to the text stream.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.models.api import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    pattern=(LayerSpec("attn", "dense"),),
    frontend="vision",
    num_prefix_tokens=576,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
