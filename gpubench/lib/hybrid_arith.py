"""The frozen arithmetic of a hybrid Mamba-2 / attention MoE prefill: the
model's operations from a configuration file's shapes alone (Hugging
Face ``granitemoehybrid`` keys), whatever implements them."""
from __future__ import annotations

from typing import Dict

from gpubench.lib.arith import causal_live_pairs


def layer_kinds(cfg: Dict) -> Dict[str, int]:
    """How many of the kept layers are Mamba-2 and attention layers."""
    kinds = cfg["layer_types"][:int(cfg["num_hidden_layers"])]
    return {"mamba": kinds.count("mamba"),
            "attention": kinds.count("attention")}


def matmul_params_per_token(cfg: Dict) -> int:
    """Weights a token multiplies by in one pass through the kept layers:
    a Mamba-2 layer's input projection (z, x, B, C and dt) and output
    projection, an attention layer's q/k/v/o, and in every layer the
    whole router (all E logits are computed), the k experts a token is
    routed to and the shared expert; no norm, conv or embedding."""
    d = int(cfg["hidden_size"])
    inner = int(cfg["mamba_n_heads"]) * int(cfg["mamba_d_head"])
    groups, n = int(cfg["mamba_n_groups"]), int(cfg["mamba_d_state"])
    heads, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = d // heads
    mamba = d * (2 * inner + 2 * groups * n + int(cfg["mamba_n_heads"])) \
        + inner * d
    attn = d * heads * hd + 2 * d * kv * hd + heads * hd * d
    moe = d * int(cfg["num_local_experts"]) \
        + 3 * int(cfg["num_experts_per_tok"]) * d \
        * int(cfg["intermediate_size"]) \
        + 3 * d * int(cfg["shared_intermediate_size"])
    k = layer_kinds(cfg)
    return k["mamba"] * mamba + k["attention"] * attn \
        + (k["mamba"] + k["attention"]) * moe


def prefill_flops(cfg: Dict, batch: int, seq: int) -> float:
    """The model's operations for a prefill of ``batch`` prompts of
    ``seq`` tokens that returns the last position's logits: 2 a weight a
    token for the products (:func:`matmul_params_per_token`); causal
    attention over the live (q, k) pairs (2·head_dim each for QKᵀ and for
    PV, every head of every attention layer); the SSD's recurrence at
    4·N·P a token and Mamba head (the state's decay-and-add, 2·N·P, and
    its read by C, 2·N·P) in every Mamba-2 layer; and the unembedding of
    one position a row over the published vocabulary.  Capacity, chunk or
    block padding is not counted."""
    d = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    tokens = batch * seq
    k = layer_kinds(cfg)
    layers = 2.0 * matmul_params_per_token(cfg) * tokens
    attn = 4.0 * (d // heads) * causal_live_pairs(seq) * batch * heads \
        * k["attention"]
    ssd = 4.0 * int(cfg["mamba_d_state"]) * int(cfg["mamba_d_head"]) \
        * int(cfg["mamba_n_heads"]) * tokens * k["mamba"]
    unembed = 2.0 * d * int(cfg["vocab_size"]) * batch
    return layers + attn + ssd + unembed
