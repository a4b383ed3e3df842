"""Analytic FLOP / HBM-byte models per (arch × shape) cell.

The port's copy of the JAX package's ``repro/perf/analytic.py``: the same
formulas over the port's :class:`~repro_torch.models.api.ModelConfig` and
:class:`~repro_torch.configs.ShapeDef`.  The models follow the
implementation einsum-for-einsum (block-rounded attention spans, MoE
capacity compute, SSD chunk algebra); ``tests/test_torch_analytic.py``
holds them equal to the JAX package's and the forward count within 20 %
of ``torch.utils.flop_counter.FlopCounterMode`` on reduced models with
dense attention.  The dry run (:mod:`repro_torch.launch.dryrun`) records
them beside the counted flops.

Counting convention: 1 multiply-add = 2 flops (XLA's).  Norms/softmax/rope
are ignored (<2% at these widths; the validation tolerance covers them).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import ShapeDef
from repro_torch.core.errors import ValidationError
from repro_torch.core.runtime import round_up_pow2
from repro_torch.models.api import ModelConfig
from repro_torch.models.mamba import CHUNK
from repro_torch.models.moe import _capacity


def _attended_per_token(seq: int, *, causal: bool, window, block: int,
                        dense: bool) -> float:
    """Average KV positions each query token touches (compute, not mask)."""
    if not causal and window is None:
        return float(seq)
    if dense:
        if window is None:
            return (seq + 1) / 2.0
        # mean over t of min(t+1, w)
        w = min(window, seq)
        return (w * (w + 1) / 2.0 + (seq - w) * w) / seq
    # blockwise path computes whole matched blocks
    nq = seq // block
    if window is None:
        return block * (nq + 1) / 2.0
    wblocks = min(-(-window // block) + 1, nq)
    total = 0
    for i in range(nq):
        total += min(i + 1, wblocks)
    return total * block / nq


def _attn_layer_flops(cfg: ModelConfig, tokens: float, kv_len: float,
                      *, causal: bool, window, decode: bool,
                      cross: bool = False, enc_tokens: float = 0.0) -> float:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f = 0.0
    f += 2 * tokens * d * h * hd            # wq
    kv_tokens = enc_tokens if cross else tokens
    f += 2 * 2 * kv_tokens * d * kvh * hd   # wk, wv
    f += 2 * tokens * d * h * hd            # wo
    if decode or cross:
        span = kv_len
    else:
        dense = kv_len <= cfg.attn_block_q
        span = _attended_per_token(int(kv_len), causal=causal, window=window,
                                   block=cfg.attn_block_k, dense=dense)
    f += 2 * 2 * tokens * span * h * hd     # scores + pv
    return f


def _mlp_flops(cfg: ModelConfig, tokens: float) -> float:
    return 3 * 2 * tokens * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, tokens: float, rows: int, seq: int,
               batch_shards: int = 1) -> float:
    d, f_, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    router = 2 * tokens * d * e
    g = max(1, min(cfg.moe_group_rows, rows))
    if rows % g:
        g = 1
    while g > 1 and (rows // g) % batch_shards:   # mirrors moe_layer guard
        g //= 2
    cap = _capacity(seq * g, cfg)
    expert = (rows // g) * e * cap * 3 * 2 * d * f_   # zero-padded bins
    return router + expert


def _mamba_layer_flops(cfg: ModelConfig, tokens: float, seq: int,
                       decode: bool) -> float:
    d, di, n, hm = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.mamba_heads
    k = cfg.mamba_conv
    f = 2 * tokens * d * di * 2             # wz, wx
    f += 2 * 2 * tokens * d * n             # wB, wC
    f += 2 * tokens * d * hm                # w_dt
    f += 2 * tokens * di * d                # w_out
    f += 2 * k * tokens * (di + 2 * n)      # causal convs
    if decode:
        f += 5 * tokens * n * di            # state update + readout
    else:
        L = min(CHUNK, seq)
        f += 2 * tokens * L * n             # intra-chunk C·B scores
        f += 2 * tokens * L * di            # intra-chunk apply (p-contraction)
        f += 4 * tokens * L * hm            # decay algebra (L² · Hm terms)
        f += 4 * tokens * n * di            # chunk state + inter-chunk
    return f


def _unembed_flops(cfg: ModelConfig, tokens: float) -> float:
    return 2 * tokens * cfg.d_model * cfg.padded_vocab


def flops_model(cfg: ModelConfig, shape: ShapeDef,
                batch_shards: int = 16) -> Dict[str, float]:
    """Global (all-device) flops for one step of this cell.

    ``batch_shards``: data-parallel shard count (affects the MoE dispatch
    grouping guard; 16 = the production single-pod data axis).
    """
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = float(b) if decode else float(b * s)
    kv_len = float(s)

    per_pattern = 0.0
    for spec in cfg.pattern:
        if spec.mixer.startswith("attn"):
            causal = spec.mixer != "attn_bidir"
            window = cfg.window if spec.mixer == "attn_local" else None
            per_pattern += _attn_layer_flops(cfg, tokens, kv_len,
                                             causal=causal, window=window,
                                             decode=decode)
        else:
            per_pattern += _mamba_layer_flops(cfg, tokens, s, decode)
        if spec.cross_attn:
            enc_tokens = 0.0 if decode else float(b * s)
            per_pattern += _attn_layer_flops(
                cfg, tokens, float(s), causal=False, window=None,
                decode=decode, cross=True, enc_tokens=enc_tokens)
        if spec.mlp == "dense":
            per_pattern += _mlp_flops(cfg, tokens)
        elif spec.mlp == "moe":
            seq_here = 1 if decode else s
            per_pattern += _moe_flops(cfg, tokens, b, seq_here,
                                      batch_shards=batch_shards)

    fwd = per_pattern * cfg.num_blocks + _unembed_flops(cfg, tokens)

    if cfg.is_encoder_decoder and not decode:
        enc_tokens = float(b * s)
        enc_layer = _attn_layer_flops(cfg, enc_tokens, float(s), causal=False,
                                      window=None, decode=False) \
            + _mlp_flops(cfg, enc_tokens)
        fwd += enc_layer * cfg.num_encoder_layers

    if shape.kind == "train":
        mult = 4.0 if cfg.remat else 3.0    # fwd + (remat fwd) + 2×bwd
        total = fwd * mult + 12.0 * cfg.param_count()   # optimizer
    else:
        total = fwd
    return {"fwd_flops": fwd, "total_flops": total, "tokens": tokens}


# ---------------------------------------------------------------------------
# HBM byte model (per step, global; divide by chips for per-device)
# ---------------------------------------------------------------------------

def bytes_model(cfg: ModelConfig, shape: ShapeDef) -> Dict[str, float]:
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = float(b) if decode else float(b * s)
    p = float(cfg.param_count())
    d = cfg.d_model

    if shape.kind == "train":
        # fp32 params read ×3 (fwd/remat/bwd) + write; grads r+w fp32;
        # bf16 moments r+w.
        param_traffic = p * (3 * 4 + 4 + 2 * 4 + 2 * 2 * 2)
        act_traffic = tokens * cfg.num_layers * d * 40.0
        # KV blocks are re-read from HBM once per *query block* (flash/
        # blockwise streaming), not per query token.
        kv_stream = 0.0
        q_blocks = tokens / min(cfg.attn_block_q, s)
        for spec in cfg.pattern:
            if spec.mixer.startswith("attn"):
                span = _attended_per_token(
                    s, causal=spec.mixer != "attn_bidir",
                    window=cfg.window if spec.mixer == "attn_local" else None,
                    block=cfg.attn_block_k, dense=s <= cfg.attn_block_q)
                kv_stream += q_blocks * span * cfg.num_kv_heads * cfg.head_dim \
                    * 2 * 2 * 3 / len(cfg.pattern) * cfg.num_layers
        total = param_traffic + act_traffic + kv_stream
    elif shape.kind == "prefill":
        param_traffic = p * 2.0
        act_traffic = tokens * cfg.num_layers * d * 12.0
        kv_write = sum(2 * tokens * cfg.num_kv_heads * cfg.head_dim * 2
                       for sp in cfg.pattern if sp.mixer.startswith("attn")) \
            / max(len(cfg.pattern), 1) * cfg.num_layers
        total = param_traffic + act_traffic + kv_write
    else:
        param_traffic = p * 2.0             # weights read once (bf16)
        cache = 0.0
        for spec in cfg.pattern:
            if spec.mixer.startswith("attn"):
                cache += 2 * b * cfg.num_kv_heads * s * cfg.head_dim * 2
            else:
                cache += 2 * b * cfg.mamba_heads * cfg.ssm_state \
                    * cfg.mamba_head_dim * 4
        cache = cache / len(cfg.pattern) * cfg.num_layers
        act = tokens * cfg.num_layers * d * 12.0
        total = param_traffic + cache + act
    return {"total_bytes": total}


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the 6·N·D / 2·N·D reference for the "useful compute" ratio)
# ---------------------------------------------------------------------------

def model_flops_reference(cfg: ModelConfig, shape: ShapeDef) -> float:
    n_active = float(cfg.active_param_count())
    if shape.kind == "decode":
        tokens = float(shape.global_batch)
        return 2.0 * n_active * tokens
    tokens = float(shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 6.0 * n_active * tokens


# ---------------------------------------------------------------------------
# DDM churn-flush cost model (the blocked endpoint index, DESIGN.md §13)
# ---------------------------------------------------------------------------
# Element-op counts for splicing a b-region move batch into one per-dim
# endpoint stream of n_endpoints records, mirroring the two backends in
# repro_torch.core.{flatstream,blockstream} term for term.  Same philosophy as
# the transformer models above: follow the implementation, pin the shape
# of the curve (the flat/blocked crossover), and let the benchmark gate
# validate it against measured churn_small_batch rows — absolute
# constants are calibration, the crossover is structure.

# whole-stream passes a flat splice pays: np.delete + np.insert over the
# 4 parallel columns, then the 8 rank-table cumsum/scatter passes
_FLAT_SPLICE_PASSES = 16.0


def _churn_block_size(n_endpoints: float, block=None) -> float:
    """The adaptive ~sqrt(n) block size the blocked backend picks."""
    if block:
        return float(block)
    root = int(max(n_endpoints, 1.0) ** 0.5)
    return float(min(max(round_up_pow2(max(root, 1)), 32), 4096))


def churn_splice_cost(n_endpoints: float, b: float, *,
                      impl: str = "blocked", block=None) -> float:
    """Predicted element-ops to splice a b-region batch (2b endpoints).

    ``flat``:    O(n) — every whole-stream pass touches all n endpoints,
                 plus the delta's own O(b log b) sort.
    ``blocked``: O(b·log n + touched·B) — directory routing per delta
                 endpoint plus per-owning-block merges; falls back to
                 the flat rebuild once the delta spans every block
                 (2b >= n/B), which is exactly what the implementation
                 does.
    """
    import math
    n = max(float(n_endpoints), 2.0)
    d = 2.0 * max(float(b), 0.0)            # delta endpoints
    delta_sort = d * max(math.log2(max(d, 2.0)), 1.0)
    if impl == "flat":
        return _FLAT_SPLICE_PASSES * n + delta_sort
    if impl != "blocked":
        raise ValidationError(
            f"impl must be 'flat' or 'blocked', got {impl!r}")
    bsz = _churn_block_size(n, block)
    nb = max(n / bsz, 1.0)
    if d >= nb:                             # bulk fallback: flat merge+rechunk
        return _FLAT_SPLICE_PASSES * n + delta_sort
    touched = min(2.0 * d, nb)              # <=2 owning blocks per endpoint
    return d * math.log2(n) + touched * bsz + delta_sort


def churn_flush_crossover(n_endpoints: float, block=None) -> float:
    """Largest batch size b for which the model says the blocked splice
    beats the flat one — the measured speedup rows must straddle it:
    single-region moves land far below (blocked wins), whole-stream
    rewrites far above (the bulk fallback makes the two equal)."""
    lo, hi = 1.0, max(float(n_endpoints), 2.0)
    if churn_splice_cost(n_endpoints, lo, block=block) >= \
            churn_splice_cost(n_endpoints, lo, impl="flat"):
        return 0.0
    while hi - lo > 1.0:
        mid = (lo + hi) / 2.0
        if churn_splice_cost(n_endpoints, mid, block=block) < \
                churn_splice_cost(n_endpoints, mid, impl="flat"):
            lo = mid
        else:
            hi = mid
    return lo
