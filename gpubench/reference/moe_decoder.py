"""A plain float32 forward of a MoE decoder (granite-moe-3b-a800m's
equations, with the multipliers that the configuration file's
``assumed.multipliers_run`` holds): the last position's logits of a
prefill.

    x   = embedding[tokens] * embedding_multiplier
    per layer:
      h = rmsnorm(x) * (1 + attn_norm)
      q, k, v = h Wq, h Wk, h Wv; rope (split halves) on q, k
      x = x + residual_multiplier
              * softmax(q kᵀ * attention_multiplier, causal) v Wo
            (query head i attends with key/value head i // (H / H_kv))
      h = rmsnorm(x) * (1 + mlp_norm)
      p = softmax(h Wr); the top-k experts by p (ties: lower expert
          first), gates p / sum of the k
      x = x + residual_multiplier
              * sum over kept choices of gate * (silu(h Wg) * (h Wu)) Wd
    logits = (rmsnorm(x_last) * (1 + final_norm)) embeddingᵀ
             / logits_scaling

Capacity: the rows of a batch form dispatch groups of
``min(group_rows, B)`` consecutive rows where that divides the B rows,
else of one row; in a group the (token, choice) records are taken in token
order, choice order within a token, and each expert keeps its first
``capacity = max(8, 8·ceil(floor(T·k·factor / E) / 8))`` records (T the
group's tokens); a dropped choice adds nothing.

Plain torch on whatever device the weights are on, float32 with TF32 off,
one layer at a time over every row.  With
``quant`` every product's operands go through ``quant`` first (the
control: ``fp8_e4m3``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def fp8_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along every
    axis but ``dim`` (the product's reduction axis), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, quant) -> torch.Tensor:
    """a (..., K) @ b (K, N), the operands through ``quant``."""
    if quant is not None:
        a, b = quant(a, -1), quant(b, 0)
    return a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, theta: float):
    """x (..., S, heads, D), positions 0..S-1; channel i pairs with
    i + D/2."""
    s, d = x.shape[-3], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(h, w, li, spec, quant, on_kv=None):
    """Causal GQA self-attention of the rows h (B, S, d) at layer li;
    ``on_kv(li, row, k, v)`` sees each row's keys (after rope) and values,
    each (S, H_kv, D)."""
    b, s, d = h.shape
    H, Hkv, D = spec["heads"], spec["kv_heads"], spec["head_dim"]
    q = _mm(h, w["wq"][li].reshape(d, H * D), quant).view(b, s, H, D)
    k = _mm(h, w["wk"][li].reshape(d, Hkv * D), quant).view(b, s, Hkv, D)
    v = _mm(h, w["wv"][li].reshape(d, Hkv * D), quant).view(b, s, Hkv, D)
    q, k = _rope(q, spec["rope_theta"]), _rope(k, spec["rope_theta"])
    if on_kv is not None:
        for r in range(b):
            on_kv(li, r, k[r], v[r])
    group = H // Hkv
    kh = k.permute(0, 2, 3, 1).repeat_interleave(group, dim=1)  # B,H,D,S
    vh = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)  # B,H,S,D
    qh = q.permute(0, 2, 1, 3)                                   # B,H,S,D
    if quant is not None:
        qh, kh = quant(qh, -1), quant(kh, -2)
    scores = (qh @ kh).mul_(spec["attention_multiplier"])
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill_(~mask, float("-inf")), dim=-1)
    del scores
    if quant is not None:
        p, vh = quant(p, -1), quant(vh, -2)
    o = (p @ vh).permute(0, 2, 1, 3).reshape(b, s, H * D)
    return _mm(o, w["wo"][li].reshape(H * D, d), quant)


def capacity(tokens: int, spec: Dict) -> int:
    cap = math.floor(tokens * spec["top_k"] * spec["capacity_factor"]
                     / spec["experts"])
    return max(8, -(-cap // 8) * 8)


def _moe(h, w, li, spec, quant, groups: int):
    """The expert layer over the tokens h (T, d), ``groups`` dispatch
    groups of consecutive tokens, each with its own capacity."""
    t, d = h.shape
    e, k = spec["experts"], spec["top_k"]
    probs = torch.softmax(_mm(h, w["router"][li], quant), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(dim=-1, keepdim=True)
    choice = idx[:, :k].reshape(-1)                  # records, token order
    token = torch.arange(t * k, device=h.device) // k
    # records by (group, expert), token order within: each expert keeps
    # the first ``cap`` of a group's; one host sync for the bin sizes
    bins = token // (t // groups) * e + choice
    order = torch.argsort(bins, stable=True)
    sizes = torch.bincount(bins, minlength=groups * e).tolist()
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + n)
    cap = capacity(t // groups, spec)
    out = torch.zeros_like(h)
    gate = gates.reshape(-1)
    for ex in range(e):
        spans = [(starts[g * e + ex], min(sizes[g * e + ex], cap))
                 for g in range(groups)]
        parts = [order[a:a + n] for a, n in spans if n]
        if not parts:
            continue
        sel = torch.cat(parts)
        x = h[token[sel]]
        y = _mm(torch.nn.functional.silu(_mm(x, w["w_gate"][li, ex], quant))
                * _mm(x, w["w_up"][li, ex], quant), w["w_down"][li, ex],
                quant)
        out.index_add_(0, token[sel], y * gate[sel, None])
    return out


@torch.no_grad()
def last_logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                spec: Dict, *, quant: Optional[Callable] = None,
                on_kv: Optional[Callable] = None) -> torch.Tensor:
    """(B, vocab) float32 logits at the last position of each row of
    ``tokens`` (B, S); ``on_kv(layer, row, k, v)`` is handed every layer's
    keys and values of each row (what a prefill leaves in its cache)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = tokens.shape
    eps = spec["rms_norm_eps"]
    x = w["embedding"][tokens].float() * spec["embedding_multiplier"]
    g = min(spec["group_rows"], b)
    g = g if b % g == 0 else 1
    for li in range(spec["layers"]):
        h = _rmsnorm(x, w["attn_norm"][li], eps)
        x += _attention(h, w, li, spec, quant, on_kv) \
            * spec["residual_multiplier"]
        del h
        h = _rmsnorm(x, w["mlp_norm"][li], eps)
        x += _moe(h.view(b * s, -1), w, li, spec, quant, b // g) \
            .view(b, s, -1) * spec["residual_multiplier"]
    last = _rmsnorm(x[:, -1], w["final_norm"], eps)
    return _mm(last, w["embedding"][:spec["vocab"]].T, quant) \
        / spec["logits_scaling"]


def spec_of(cfg: Dict) -> Dict:
    """The reference's sizes and constants from a configuration file."""
    a = cfg["assumed"]
    run = a["multipliers_run"]
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {
        "layers": int(cfg["num_hidden_layers"]),
        "d": d,
        "heads": heads,
        "kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": int(a.get("head_dim", d // heads)),
        "experts": int(cfg["num_local_experts"]),
        "top_k": int(cfg["num_experts_per_tok"]),
        "vocab": int(cfg["vocab_size"]),
        "rope_theta": float(cfg["rope_theta"]),
        "rms_norm_eps": float(cfg["rms_norm_eps"]),
        "embedding_multiplier": float(run["embedding_multiplier"]),
        "attention_multiplier": float(run["attention_multiplier"]),
        "residual_multiplier": float(run["residual_multiplier"]),
        "logits_scaling": float(run["logits_scaling"]),
        "capacity_factor": float(a["moe_capacity_factor"]),
        "group_rows": int(a["moe_group_rows"]),
    }
