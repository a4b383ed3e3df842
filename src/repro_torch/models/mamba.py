"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block.

Chunked SSD: within a chunk the recurrence is computed as a masked
attention-like quadratic form (matrix products); across chunks the
scalar-decay state is passed on by an exclusive scan with the monoid
⊕ = (decay, accumulate), here a loop over the chunks (the JAX package's
``lax.scan``), the same two-level substrate the paper's sweep uses.

Recurrence (per head, state N × head_dim P):
    h_t = a_t · h_{t-1} + Δt_t · B_t ⊗ x_t        a_t = exp(Δt_t · A)
    y_t = C_t · h_t + D · x_t
Simplifications vs the released model, as in the JAX package: n_groups = 1
(B/C shared across heads), no bias terms.  Decode keeps (h, conv window)
as explicit state.  The counterpart of ``repro/models/mamba.py``.

The intra-chunk product ``bclm,bclmh,bcmhp->bclhp`` is taken in two steps:
the (B, nc, Hm, L, L) weights ``g · decay`` first, then one batched
product over (b, c, h), so no (B, nc, L, L, Hm, P) intermediate is built.

Under a mesh whose layout splits ``mamba_heads`` (over the model axis, as
GSPMD lays out the JAX ``mamba_layer``), each rank computes its heads:
``w_zx`` column-parallel, the SSD and the gated per-head norm on local
heads, ``w_out`` row-parallel.  B, C and Δt come from the replicated
``w_bcdt`` and feed every rank's heads, so they pass
:func:`~repro_torch.parallel.collectives.copy_to` (identity forward,
all-reduce backward): every replicated leaf's gradient is then whole and
the same bits on every model rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.models.common import rmsnorm
from repro_torch.parallel.collectives import copy_to, reduce_from
from repro_torch.parallel.sharding import Sharder

CHUNK = 128


def mamba_defs(cfg: ModelConfig):
    d, hm, p, n = cfg.d_model, cfg.mamba_heads, cfg.mamba_head_dim, cfg.ssm_state
    k = cfg.mamba_conv
    return {
        # fused input projections: z and x side by side per head; B ‖ C ‖ Δt
        "w_zx": ParamDef((d, hm, 2 * p), ("embed", "mamba_heads", None),
                         "normal"),
        "w_bcdt": ParamDef((d, 2 * n + hm), ("embed", None), "normal"),
        "dt_bias": ParamDef((hm,), ("mamba_heads",), "zeros"),
        "A_log": ParamDef((hm,), ("mamba_heads",), "zeros"),
        "D_skip": ParamDef((hm,), ("mamba_heads",), "ones"),
        "conv_x": ParamDef((k, hm, p), ("conv", "mamba_heads", None), "normal",
                           scale_dim=k),
        "conv_B": ParamDef((k, n), ("conv", "mamba_state"), "normal",
                           scale_dim=k),
        "conv_C": ParamDef((k, n), ("conv", "mamba_state"), "normal",
                           scale_dim=k),
        "norm_scale": ParamDef((hm, p), ("mamba_heads", None), "scale"),
        "w_out": ParamDef((hm, p, d), ("mamba_heads", None, "embed"), "normal",
                          scale_dim=hm * p),
    }


class MambaState(NamedTuple):
    h: torch.Tensor          # (B, Hm, N, P) ssm state
    conv_x: torch.Tensor     # (B, K-1, Hm, P) pre-conv history
    conv_B: torch.Tensor     # (B, K-1, N)
    conv_C: torch.Tensor     # (B, K-1, N)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 history: Optional[torch.Tensor]):
    """Depthwise causal conv along axis 1.  x: (B, S, ...), w: (K, ...).
    Returns (out, the last K-1 inputs, in x's dtype)."""
    k, s = w.shape[0], x.shape[1]
    if history is None:
        pad = x.new_zeros((x.shape[0], k - 1) + x.shape[2:])
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, s:]


def _ssd_chunked(xh, dt, a_log, bmat, cmat, h0):
    """Chunked SSD scan.

    xh: (B,S,Hm,P) inputs not yet Δ-scaled; dt: (B,S,Hm); a_log: (Hm,);
    bmat/cmat: (B,S,N); h0: (B,Hm,N,P).  S must be a multiple of the
    chunk min(CHUNK, S).  Returns (y (B,S,Hm,P), h_final (B,Hm,N,P)),
    float32.
    """
    b, s, hm, p = xh.shape
    n = bmat.shape[-1]
    L = min(CHUNK, s)
    nc = s // L
    assert s % L == 0, f"{s=} not a multiple of chunk {L}"

    A = -torch.exp(a_log.float())                            # (Hm,) negative
    dt = dt.float()
    loga = dt * A                                            # (B,S,Hm) ≤ 0
    dtx = (dt[..., None] * xh.float()).reshape(b, nc, L, hm, p)
    bm = bmat.float().reshape(b, nc, L, n)
    cm = cmat.float().reshape(b, nc, L, n)
    cs = torch.cumsum(loga.reshape(b, nc, L, hm), dim=2)     # (B,nc,L,Hm)

    # intra-chunk (quadratic, causal-masked), heads leading the (L, L) pair:
    # decay[b,c,h,l,m] = exp(cs[l] - cs[m]) for m <= l, else 0.  The mask
    # goes in before the exp (exp(-inf) = 0): above the diagonal
    # cs[l] - cs[m] > 0 may overflow to inf, and a mask after the exp
    # would turn its zero gradient into 0 * inf = NaN in the backward pass
    # (the JAX package masks after the exp; the forward values are equal)
    cs_h = cs.transpose(2, 3)                                # (B,nc,Hm,L)
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(torch.where(
        causal, cs_h[..., :, None] - cs_h[..., None, :], float("-inf")))
    g = cm @ bm.transpose(-1, -2)                            # (B,nc,L,L)
    w = g[:, :, None] * decay                                # (B,nc,Hm,L,L)
    y_intra = w @ dtx.permute(0, 1, 3, 2, 4)                 # (B,nc,Hm,L,P)

    # per-chunk state contribution and decay
    last = cs[:, :, -1:, :]                                  # (B,nc,1,Hm)
    state_w = torch.exp(last - cs)                           # (B,nc,L,Hm)
    sx = (state_w[..., None] * dtx).reshape(b, nc, L, hm * p)
    chunk_state = (bm.transpose(-1, -2) @ sx).reshape(b, nc, n, hm, p) \
        .permute(0, 1, 3, 2, 4)                              # (B,nc,Hm,N,P)
    chunk_decay = torch.exp(last[:, :, 0])                   # (B,nc,Hm)

    # across chunks: the exclusive scan of the (decay, accumulate) monoid
    h = h0.float()
    y_inter = []
    for c in range(nc):
        yc = cm[:, c, None] @ h                              # (B,Hm,L,P)
        y_inter.append(yc * torch.exp(cs[:, c]).transpose(1, 2)[..., None])
        h = chunk_decay[:, c, :, None, None] * h + chunk_state[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)                # (B,nc,Hm,L,P)
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, hm, p), h


def mamba_layer(params, x: torch.Tensor, cfg: ModelConfig, sharder=None, *,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x: (B, S, D).  With ``state``: stateful (prefill s > 1 or decode
    s == 1), returning the new state (h float32 in ``state.h``'s dtype,
    the conv histories in the compute dtype); else (out, None).

    ``sharder``: under a mesh whose layout splits ``mamba_heads``, the
    leaves with that axis (and the state's ``h`` and ``conv_x``) hold this
    rank's heads, x is replicated over the heads' group and the output is
    all-reduced over it (tensor parallelism); where the divisibility
    fallback replicates the heads, every rank computes the whole layer
    with no collective."""
    dt_ = cfg.dtype
    b, s, d = x.shape
    hm, p, n = cfg.mamba_heads, cfg.mamba_head_dim, cfg.ssm_state
    sharder = sharder or Sharder()
    split = sharder.split("mamba_heads", hm)
    groups = sharder.groups(split.axes)
    hl = hm // split.size                    # this rank's heads
    h_lo = split.index * hl

    zx = (copy_to(x, groups) @ params["w_zx"].to(dt_).reshape(d, hl * 2 * p)) \
        .view(b, s, hl, 2 * p)
    z, xin = zx[..., :p], zx[..., p:]
    bcdt = x @ params["w_bcdt"].to(dt_)
    bproj = bcdt[..., :n]
    cproj = bcdt[..., n:2 * n]
    # Δt of every head, used for this rank's: the gradient of the other
    # columns comes from the other ranks
    dt_raw = copy_to(bcdt[..., 2 * n:], groups)[..., h_lo:h_lo + hl]

    xin, nhx = _causal_conv(xin, params["conv_x"].to(dt_),
                            None if state is None else state.conv_x)
    bproj, nhb = _causal_conv(bproj, params["conv_B"].to(dt_),
                              None if state is None else state.conv_B)
    cproj, nhc = _causal_conv(cproj, params["conv_C"].to(dt_),
                              None if state is None else state.conv_C)
    xin = F.silu(xin)
    # B and C feed every rank's heads
    bproj = copy_to(F.silu(bproj), groups)
    cproj = copy_to(F.silu(cproj), groups)
    dt_soft = F.softplus(dt_raw.float() + params["dt_bias"].float())

    h0 = state.h if state is not None else torch.zeros(
        (b, hl, n, p), dtype=dt_soft.dtype, device=x.device)

    if s == 1:
        # decode: the exact single-step recurrence
        A = -torch.exp(params["A_log"].float())
        dt0 = dt_soft[:, 0]                                     # (B,Hm)
        a = torch.exp(dt0 * A)
        dbx = dt0[:, :, None, None] * bproj[:, 0].float()[:, None, :, None] \
            * xin[:, 0].float()[:, :, None, :]                  # (B,Hm,N,P)
        h_final = a[:, :, None, None] * h0.float() + dbx
        y = (cproj[:, 0].float()[:, None, None, :] @ h_final)   # (B,Hm,1,P)
        y = y.transpose(1, 2)                                   # (B,1,Hm,P)
    else:
        pad = (-s) % min(CHUNK, s)   # only pad up to a chunk multiple
        if pad:
            def padit(t):
                return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            y, h_final = _ssd_chunked(padit(xin), padit(dt_soft),
                                      params["A_log"], padit(bproj),
                                      padit(cproj), h0)
            y = y[:, :s]
        else:
            y, h_final = _ssd_chunked(xin, dt_soft, params["A_log"],
                                      bproj, cproj, h0)

    y = y + params["D_skip"].float()[None, None, :, None] * xin.float()
    y = (y * F.silu(z.float())).to(dt_)                         # gate
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = reduce_from(
        y.reshape(b, s, hl * p) @ params["w_out"].to(dt_).reshape(hl * p, d),
        groups)

    new_state = None
    if state is not None:
        new_state = MambaState(h_final.to(state.h.dtype), nhx, nhb, nhc)
    return out, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device="cuda", layers: Optional[int] = None,
                     heads: Optional[int] = None) -> MambaState:
    """Zero state for ``batch`` rows; with ``layers``, stacked on a leading
    axis of that many blocks (the model's cache layout); ``heads``: the
    heads this rank holds (default all)."""
    hm = cfg.mamba_heads if heads is None else heads
    p, n, k = cfg.mamba_head_dim, cfg.ssm_state, cfg.mamba_conv
    lead = (batch,) if layers is None else (layers, batch)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return MambaState(h=zeros(hm, n, p), conv_x=zeros(k - 1, hm, p),
                      conv_B=zeros(k - 1, n), conv_C=zeros(k - 1, n))
