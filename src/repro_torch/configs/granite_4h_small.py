"""granite-4.0-h-small — IBM Granite 4.0-H Small (hybrid Mamba-2 /
attention MoE, 32B-A9B).

40L d_model=4096; layer types in periods of 10, attention at index 5 (36
Mamba-2, 4 attention layers).  Mamba-2: 128 heads of 64 (d_inner 8192),
state 128, n_groups 1, conv 4 with bias, the gated norm over all of
d_inner.  Attention: GQA 32 q / 8 KV heads of 128, no positional encoding
(NoPE).  Every layer ends in a MoE of 72 experts of width 768, top-10,
plus one shared SwiGLU expert of width 1536.  Vocabulary 100,352, tied.
Multipliers: embeddings 12, scores 1/128, residual branches 0.22, logits
÷16.  [hf:ibm-granite/granite-4.0-h-small config.json, model_type
granitemoehybrid]

The SSD runs at the port's chunk of 128 (the published 256 is the same
mathematics).  Not one of the JAX package's architectures:
:data:`repro_torch.configs.PORT_ONLY_ARCH_IDS`.
"""
from repro_torch.models.api import LayerSpec, ModelConfig

_PATTERN = tuple(LayerSpec("attn" if i == 5 else "mamba", "moe")
                 for i in range(10))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    pattern=_PATTERN,
    num_experts=72,
    num_experts_per_token=10,
    moe_group_rows=8,   # rows merged per dispatch group (up to 8 slots)
    moe_shared_ff=1536,
    ssm_state=128,
    mamba_head_dim=64,
    mamba_expand=2,
    mamba_conv=4,
    mamba_conv_bias=True,
    mamba_norm_groups=1,
    embedding_multiplier=12.0,
    attention_multiplier=1.0 / 128,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    use_rope=False,
    norm_eps=1.0e-5,
    tie_embeddings=True,
)
