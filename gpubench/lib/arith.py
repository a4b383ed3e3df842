"""The frozen arithmetic: a model's operations, a kernel's operations and
bytes, from shapes alone.

Copied, not imported, from the port: the live (q, k) pairs of
``chip_smoke.live_pairs`` over a causal block schedule (in closed form),
the weights a token multiplies by from ``ModelConfig.active_param_count``,
and pass C's bytes.  Later changes to the port do not move this
yardstick.
"""
from __future__ import annotations

from typing import Dict, Tuple


def decoder_dims(cfg: Dict) -> Dict[str, int]:
    """The sizes of a decoder configuration file (Hugging Face keys)."""
    d = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    vocab = int(cfg["vocab_size"])
    pad = int(cfg["assumed"].get("vocab_pad_multiple", 1))
    return {
        "d": d,
        "layers": int(cfg["num_hidden_layers"]),
        "heads": heads,
        "kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": int(cfg["assumed"].get("head_dim", d // heads)),
        "ffn": int(cfg["intermediate_size"]),
        "experts": int(cfg.get("num_local_experts", 0)),
        "top_k": int(cfg.get("num_experts_per_tok", 0)),
        "vocab": vocab,
        "padded_vocab": -(-vocab // pad) * pad,
    }


def matmul_params_per_token(cfg: Dict) -> int:
    """Weights a token multiplies by in one pass through the layers: the
    q/k/v/o projections, the whole router (all E logits are computed) and
    the k experts it is routed to; no norm, no embedding."""
    x = decoder_dims(cfg)
    d, hd = x["d"], x["head_dim"]
    attn = d * x["heads"] * hd + 2 * d * x["kv_heads"] * hd \
        + x["heads"] * hd * d
    moe = d * x["experts"] + 3 * x["top_k"] * d * x["ffn"]
    return x["layers"] * (attn + moe)


def causal_live_pairs(seq: int) -> int:
    """(q, k) pairs a causal self-attention over ``seq`` tokens computes,
    per row and head."""
    return seq * (seq + 1) // 2


def prefill_model_flops(cfg: Dict, batch: int, seq: int) -> float:
    """The model's operations for a prefill of ``batch`` prompts of
    ``seq`` tokens that returns the last position's logits: 2 a weight a
    token for the layers' products, the causal attention over the live
    (q, k) pairs (2·head_dim each for QKᵀ and for PV, every head and
    layer), and the unembedding of one position a row over the published
    vocabulary.  Whatever implements it: capacity or block padding is not
    counted."""
    x = decoder_dims(cfg)
    tokens = batch * seq
    layers = 2.0 * matmul_params_per_token(cfg) * tokens
    attn = 4.0 * x["head_dim"] * causal_live_pairs(seq) * batch \
        * x["heads"] * x["layers"]
    unembed = 2.0 * x["d"] * x["vocab"] * batch
    return layers + attn + unembed


def flash_work(batch: int, heads: int, kv_heads: int, seq: int,
               head_dim: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one causal self-attention launch: 4·head_dim
    operations a live (q, k) pair and head; q, k, v read and o written
    once each."""
    ops = 4.0 * head_dim * causal_live_pairs(seq) * batch * heads
    nbytes = float(elem_bytes) * seq * head_dim * batch \
        * (2 * heads + 2 * kv_heads)
    return ops, nbytes


def roofline_seconds(ops: float, nbytes: float, flops_per_s: float,
                     bytes_per_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / flops_per_s, nbytes / bytes_per_s)


def pass_c_bytes(n: int, m: int, pairs: int) -> float:
    """Pass C's bytes: each of the 2(n+m) endpoint records read once (the
    owner, upper, side and valid words, 16 B) and 8 B a pair written (two
    int32 indices).  The per-segment entering sets depend on the segment
    size the implementation picks and are not counted."""
    return 16.0 * 2 * (n + m) + 8.0 * pairs
