"""A plain float32 forward of a hybrid Mamba-2 / attention MoE decoder
(Hugging Face ``GraniteMoeHybridForCausalLM``, model_type
``granitemoehybrid``, as granite-4.0-h-small publishes it): the logits of
a prefill, and what a prefill leaves in its caches.

    x = embedding[tokens] * embedding_multiplier
    per layer (layer_types: "mamba" or "attention"):
      h = rmsnorm(x) * (1 + norm_mixer)
      x = x + residual_multiplier * (mamba2(h) or attention(h))
      h = rmsnorm(x) * (1 + norm_mlp)
      x = x + residual_multiplier * (moe(h) + shared(h))
    logits = (rmsnorm(x) * (1 + final_norm)) embeddingᵀ / logits_scaling

    attention: q, k, v = h Wq, h Wk, h Wv, no positional encoding (NoPE);
      softmax(q kᵀ * attention_multiplier, causal) v Wo (query head i
      attends with key/value head i // (H / H_kv))
    moe: p = softmax(h Wr); the top-k experts by p (ties: lower expert
      first), gates p / sum of the k (= a softmax over the top-k logits);
      sum over kept choices of gate * (silu(h Wg) * (h Wu)) Wd
    shared: (silu(h Sg) * (h Su)) Sd, on every token
    mamba2 (n_groups 1: B and C shared by the heads):
      [z | x | B | C | dt] = h W_in
      x, B, C = silu(causal depthwise conv_K([x | B | C]) + conv bias)
      dt = softplus(dt + dt_bias); A = -exp(A_log), a scalar a head
      s_t = exp(dt_t A) s_{t-1} + dt_t B_t ⊗ x_t;  y_t = C_t s_t + D x_t
      y = rmsnorm over all d_inner channels of (y * silu(z)) * (1 + norm)
      out = y W_out

The state-space part is computed in its quadratic (attention-like) dual
form over the whole sequence, queries taken in blocks of ``SSD_BLOCK``:
y_t = sum over s <= t of (C_t · B_s) exp(cs_t - cs_s) dt_s x_s, with cs
the running sum of dt A taken in float64 (cs reaches -1e5 over 4,096
tokens, where float32 differences of it lose the decay), and the final
state s_S = sum over s of exp(cs_S - cs_s) dt_s B_s ⊗ x_s.  Never a
chunked scan.  :func:`ssd_recurrent` is the recurrence step by step.

Departures from the published model, each the port's and the same here:
RMSNorm scales are applied as ``(1 + scale)`` (published: ``scale``);
the expert layer keeps each expert's first ``capacity = max(8,
8·ceil(floor(T·k·factor / E) / 8))`` (token, choice) records of a dispatch
group (T the group's tokens; records in token order, choice order within
a token) and a dropped choice adds nothing (published: no capacity); the
rows of a batch form dispatch groups of ``min(group_rows, B)``
consecutive rows where that divides the B rows, else of one row.
``W_in`` is held as ``w_zx`` (d, H, 2P): head h's z columns then its x
columns, and ``w_bcdt`` (d, 2N + H): [B | C | dt]; the conv as
``conv_x`` (K, H, P), ``conv_B``, ``conv_C`` (K, N) with their biases:
the published columns permuted, the same function under drawn weights.

Plain torch on whatever device the weights are on, float32 with TF32 off,
one layer at a time over every row.  With ``quant`` every product's
operands (the state-space dual form's included) go through ``quant``
first (the control: ``fp8_e4m3``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

SSD_BLOCK = 256


def fp8_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along every
    axis but ``dim`` (the product's reduction axis), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, quant) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N), the operands through ``quant``."""
    if quant is not None:
        a, b = quant(a, -1), quant(b, -2)
    return a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Causal depthwise conv along axis 1 of u (B, S, ...) with taps w
    (K, ...) over zeros before the sequence, plus ``bias``; and the last
    K-1 inputs (the history a decode step resumes from)."""
    k, s = w.shape[0], u.shape[1]
    up = torch.cat([u.new_zeros((u.shape[0], k - 1) + u.shape[2:]), u],
                   dim=1)
    out = bias.expand_as(u).clone()
    for i in range(k):
        out += up[:, i:i + s] * w[i]
    return out, up[:, s:]


def ssd_recurrent(x, dt, a, bm, cm):
    """The recurrence step by step for one row: x (S, H, P), dt (S, H)
    (after softplus), a (H,) = -exp(A_log), bm, cm (S, N).  Returns (y
    (S, H, P) without the D skip, the final state (H, N, P))."""
    s, hh, p = x.shape
    state = x.new_zeros(hh, bm.shape[1], p)
    y = x.new_empty(s, hh, p)
    for t in range(s):
        state = torch.exp(dt[t] * a)[:, None, None] * state \
            + dt[t][:, None, None] * bm[t][None, :, None] * x[t][:, None, :]
        y[t] = torch.einsum("n,hnp->hp", cm[t], state)
    return y, state


def ssd(x, dt, a, bm, cm, *, quant=None, block: int = SSD_BLOCK):
    """The same as :func:`ssd_recurrent` in the quadratic dual form over
    the whole row, queries in blocks of ``block``."""
    s, hh, p = x.shape
    cs = torch.cumsum((dt * a).double(), dim=0)                # (S, H)
    dx = (dt[..., None] * x).permute(1, 0, 2)                  # (H, S, P)
    pos = torch.arange(s, device=x.device)
    y = x.new_empty(s, hh, p)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        seg = cs[q0:q1, None, :] - cs[None, :q1, :]            # (Q, K, H)
        live = pos[None, :q1] <= pos[q0:q1, None]
        decay = torch.exp(seg.masked_fill(~live[..., None],
                                          float("-inf"))).float()
        g = _mm(cm[q0:q1], bm[:q1].T, quant)                   # (Q, K)
        wgt = (g[..., None] * decay).permute(2, 0, 1)          # (H, Q, K)
        del seg, decay
        y[q0:q1] = _mm(wgt, dx[:, :q1], quant).permute(1, 0, 2)
    last = torch.exp(cs[-1] - cs).float().T                    # (H, S)
    state = _mm(bm.T, last[..., None] * dx, quant)             # (H, N, P)
    return y, state


def _mamba(h, lw, li, spec, quant, on_state):
    """A Mamba-2 mixer over the rows h (B, S, d); ``on_state(li, row, s,
    (x, B, C))`` sees each row's final state (H, N, P) and its conv
    history, the last K-1 inputs of x (K-1, H, P), B and C (K-1, N)."""
    b, s, d = h.shape
    hh, p, n = spec["mamba_heads"], spec["mamba_head_dim"], spec["d_state"]
    zx = _mm(h, lw["w_zx"].reshape(d, hh * 2 * p), quant) \
        .view(b, s, hh, 2 * p)
    z, xr = zx[..., :p], zx[..., p:]
    bcdt = _mm(h, lw["w_bcdt"], quant)
    xc, hx = _conv(xr, lw["conv_x"], lw["conv_x_bias"])
    bc, hb = _conv(bcdt[..., :n], lw["conv_B"], lw["conv_B_bias"])
    cc, hc = _conv(bcdt[..., n:2 * n], lw["conv_C"], lw["conv_C_bias"])
    xc, bc, cc = F.silu(xc), F.silu(bc), F.silu(cc)
    dt = F.softplus(bcdt[..., 2 * n:] + lw["dt_bias"])
    a = -torch.exp(lw["A_log"])
    y = torch.empty_like(xc)
    for r in range(b):
        y[r], state = ssd(xc[r], dt[r], a, bc[r], cc[r], quant=quant)
        if on_state is not None:
            on_state(li, r, state, (hx[r], hb[r], hc[r]))
    y = (y + lw["D_skip"][:, None] * xc) * F.silu(z)
    y = _rmsnorm(y.reshape(b, s, hh * p), lw["norm_scale"].reshape(-1),
                 spec["rms_norm_eps"])
    return _mm(y, lw["w_out"].reshape(hh * p, d), quant)


def _attention(h, lw, li, spec, quant, on_kv, on_attn):
    """Causal GQA self-attention without positional encoding over the
    rows h (B, S, d); ``on_kv(li, row, k, v)`` sees each row's keys and
    values, each (S, H_kv, D), and ``on_attn(li, row, o)`` its output
    before ``Wo``, (S, H, D)."""
    b, s, d = h.shape
    hq, hkv, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    q = _mm(h, lw["wq"].reshape(d, hq * hd), quant).view(b, s, hq, hd)
    k = _mm(h, lw["wk"].reshape(d, hkv * hd), quant).view(b, s, hkv, hd)
    v = _mm(h, lw["wv"].reshape(d, hkv * hd), quant).view(b, s, hkv, hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    o = torch.empty_like(q)
    for r in range(b):
        if on_kv is not None:
            on_kv(li, r, k[r], v[r])
        kh = k[r].permute(1, 2, 0).repeat_interleave(hq // hkv, dim=0)
        vh = v[r].permute(1, 0, 2).repeat_interleave(hq // hkv, dim=0)
        scores = _mm(q[r].permute(1, 0, 2), kh, quant) \
            .mul_(spec["attention_multiplier"])
        pr = torch.softmax(scores.masked_fill_(~mask, float("-inf")), dim=-1)
        del scores
        o[r] = _mm(pr, vh, quant).permute(1, 0, 2)
        if on_attn is not None:
            on_attn(li, r, o[r])
    return _mm(o.reshape(b, s, hq * hd), lw["wo"].reshape(hq * hd, d), quant)


def capacity(tokens: int, spec: Dict) -> int:
    cap = math.floor(tokens * spec["top_k"] * spec["capacity_factor"]
                     / spec["experts"])
    return max(8, -(-cap // 8) * 8)


def _swiglu(x, wg, wu, wd, quant):
    return _mm(F.silu(_mm(x, wg, quant)) * _mm(x, wu, quant), wd, quant)


def _moe(h, lw, spec, quant, groups: int):
    """The routed experts over the tokens h (T, d), ``groups`` dispatch
    groups of consecutive tokens, each with its own capacity, plus the
    shared expert on every token."""
    t, d = h.shape
    e, k = spec["experts"], spec["top_k"]
    probs = torch.softmax(_mm(h, lw["router"], quant), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(dim=-1, keepdim=True)
    choice = idx[:, :k].reshape(-1)                  # records, token order
    token = torch.arange(t * k, device=h.device) // k
    bins = token // (t // groups) * e + choice
    order = torch.argsort(bins, stable=True)
    sizes = torch.bincount(bins, minlength=groups * e).tolist()
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + n)
    cap = capacity(t // groups, spec)
    out = _swiglu(h, lw["shared_gate"], lw["shared_up"], lw["shared_down"],
                  quant)
    gate = gates.reshape(-1)
    for ex in range(e):
        spans = [(starts[g * e + ex], min(sizes[g * e + ex], cap))
                 for g in range(groups)]
        parts = [order[a:a + n] for a, n in spans if n]
        if not parts:
            continue
        sel = torch.cat(parts)
        y = _swiglu(h[token[sel]], lw["w_gate"][ex], lw["w_up"][ex],
                    lw["w_down"][ex], quant)
        out.index_add_(0, token[sel], y * gate[sel, None])
    return out


@torch.no_grad()
def forward(w: Dict, tokens: torch.Tensor, spec: Dict, *,
            quant: Optional[Callable] = None,
            on_kv: Optional[Callable] = None,
            on_state: Optional[Callable] = None,
            on_attn: Optional[Callable] = None,
            last_only: bool = True) -> torch.Tensor:
    """Float32 logits over the published vocabulary of ``tokens`` (B, S):
    (B, vocab) at the last position, or (B, S, vocab) at every position
    (``last_only=False``).  ``w``: ``embedding``, ``final_norm`` and
    ``layers``, a dict of weights a layer (:data:`MAMBA`, :data:`ATTENTION`,
    :data:`COMMON`).  ``on_kv`` and ``on_state`` see what a prefill leaves
    in the attention layers' and the Mamba layers' caches, ``on_attn``
    the attention layers' outputs before ``Wo``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s = tokens.shape
    eps, res = spec["rms_norm_eps"], spec["residual_multiplier"]
    x = w["embedding"][tokens].float() * spec["embedding_multiplier"]
    g = min(spec["group_rows"], b)
    g = g if b % g == 0 else 1
    for li, kind in enumerate(spec["layer_types"]):
        lw = w["layers"][li]
        h = _rmsnorm(x, lw["norm_mixer"], eps)
        if kind == "mamba":
            x += _mamba(h, lw, li, spec, quant, on_state) * res
        else:
            x += _attention(h, lw, li, spec, quant, on_kv, on_attn) * res
        del h
        h = _rmsnorm(x, lw["norm_mlp"], eps)
        x += _moe(h.view(b * s, -1), lw, spec, quant, b // g) \
            .view(b, s, -1) * res
        del h
    out = _rmsnorm(x[:, -1] if last_only else x, w["final_norm"], eps)
    return _mm(out, w["embedding"][:spec["vocab"]].T, quant) \
        / spec["logits_scaling"]


# a layer's weights: name -> shape in terms of the sizes
COMMON = {
    "norm_mixer": ("d",), "norm_mlp": ("d",),
    "router": ("d", "experts"),
    "w_gate": ("experts", "d", "ffn"), "w_up": ("experts", "d", "ffn"),
    "w_down": ("experts", "ffn", "d"),
    "shared_gate": ("d", "shared_ffn"), "shared_up": ("d", "shared_ffn"),
    "shared_down": ("shared_ffn", "d"),
}
MAMBA = {
    "w_zx": ("d", "mamba_heads", "2*mamba_head_dim"),
    "w_bcdt": ("d", "2*d_state+mamba_heads"),
    "dt_bias": ("mamba_heads",), "A_log": ("mamba_heads",),
    "D_skip": ("mamba_heads",),
    "conv_x": ("conv", "mamba_heads", "mamba_head_dim"),
    "conv_B": ("conv", "d_state"), "conv_C": ("conv", "d_state"),
    "conv_x_bias": ("mamba_heads", "mamba_head_dim"),
    "conv_B_bias": ("d_state",), "conv_C_bias": ("d_state",),
    "norm_scale": ("mamba_heads", "mamba_head_dim"),
    "w_out": ("mamba_heads", "mamba_head_dim", "d"),
}
ATTENTION = {
    "wq": ("d", "heads", "head_dim"), "wk": ("d", "kv_heads", "head_dim"),
    "wv": ("d", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "d"),
}


def size(spec: Dict, expr: str) -> int:
    """A size of :data:`COMMON` / :data:`MAMBA` / :data:`ATTENTION`: a
    spec key, ``2*key`` or ``2*a+b``."""
    total = 0
    for term in expr.split("+"):
        mult, _, key = term.rpartition("*")
        total += int(mult or 1) * int(spec[key])
    return total


def spec_of(cfg: Dict) -> Dict:
    """The reference's sizes and constants from a configuration file
    (Hugging Face ``granitemoehybrid`` keys; ``assumed`` holds the
    capacity factor and the dispatch group's rows)."""
    if cfg.get("position_embedding_type") != "nope" \
            or int(cfg["mamba_n_groups"]) != 1:
        raise ValueError("the reference is the NoPE, n_groups 1 model")
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    a = cfg["assumed"]
    spec = {
        "layer_types": list(cfg["layer_types"][:int(cfg["num_hidden_layers"])]),
        "d": d,
        "heads": heads,
        "kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": int(a.get("head_dim", d // heads)),
        "experts": int(cfg["num_local_experts"]),
        "top_k": int(cfg["num_experts_per_tok"]),
        "ffn": int(cfg["intermediate_size"]),
        "shared_ffn": int(cfg["shared_intermediate_size"]),
        "mamba_heads": int(cfg["mamba_n_heads"]),
        "mamba_head_dim": int(cfg["mamba_d_head"]),
        "d_state": int(cfg["mamba_d_state"]),
        "conv": int(cfg["mamba_d_conv"]),
        "vocab": int(cfg["vocab_size"]),
        "rms_norm_eps": float(cfg["rms_norm_eps"]),
        "embedding_multiplier": float(cfg["embedding_multiplier"]),
        "attention_multiplier": float(cfg["attention_multiplier"]),
        "residual_multiplier": float(cfg["residual_multiplier"]),
        "logits_scaling": float(cfg["logits_scaling"]),
        "capacity_factor": float(a["moe_capacity_factor"]),
        "group_rows": int(a["moe_group_rows"]),
    }
    if spec["mamba_heads"] * spec["mamba_head_dim"] \
            != int(cfg["mamba_expand"]) * d:
        raise ValueError("mamba_n_heads * mamba_d_head != mamba_expand * "
                         "hidden_size")
    return spec
