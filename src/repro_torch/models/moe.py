"""Mixture-of-Experts with *sort-based dispatch*: the paper's skeleton
(sort, prefix offsets, matched gather and scatter) applied to routing
tokens to experts.

Dispatch is matching the paper's way:
  1. every (token, choice) pair is a record keyed by expert id;
  2. records are *sorted* by expert (a stable ``argsort``, phase 1);
  3. per-expert segment starts come from ``searchsorted`` on the sorted
     keys, and a record's rank in its expert is its position less its
     segment's start (the prefix phase);
  4. records of rank below the capacity are scattered into (E, capacity)
     expert bins (the emission); the rest are dropped.

The counterpart of the JAX package's ``repro/models/moe.py`` on its
einsum path.  The port has no mesh, so ``moe_impl`` ``auto`` and ``gspmd``
both take that path; the shard_map modes ``ep``, ``cap`` and ``ffn``
raise.  Aux outputs follow Switch / GShard: load-balancing loss and the
router z-loss.

Top-k takes a stable descending sort of the router probabilities, so
among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them (``torch.topk`` leaves ties unordered).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.errors import ValidationError
from repro_torch.models.api import ModelConfig, ParamDef

MESH_MODES = ("ep", "cap", "ffn")


def moe_defs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), ("embed", "experts"), "normal"),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"),
                           "normal", scale_dim=d),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"),
                         "normal", scale_dim=d),
        "w_down": ParamDef((e, f, d), ("experts", "expert_ffn", "embed"),
                           "normal", scale_dim=f),
    }


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Per-expert capacity for a dispatch group of ``tokens_per_group``
    tokens (records = tokens × top-k), a multiple of 8 and at least 8."""
    cap = int(tokens_per_group * cfg.num_experts_per_token
              * cfg.moe_capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)


def select_moe_mode(cfg: ModelConfig) -> str:
    """The expert-apply strategy: the einsum path ("gspmd") for ``auto``
    and ``gspmd``.  The shard_map modes need a mesh, which the port does
    not have yet: they raise :class:`ValidationError`, as does an unknown
    mode."""
    if cfg.moe_impl in ("auto", "gspmd"):
        return "gspmd"
    if cfg.moe_impl in MESH_MODES:
        raise ValidationError(
            f"{cfg.name}: moe_impl {cfg.moe_impl!r} needs a device mesh; "
            "the port runs the einsum path only ('auto' or 'gspmd')")
    raise ValidationError(f"{cfg.name}: unknown moe_impl {cfg.moe_impl!r}")


def sort_based_dispatch(expert_ids: torch.Tensor, capacity: int,
                        num_experts: int):
    """Dispatch schedule of each row via sort + rank (the SBM skeleton).

    expert_ids: (B, R) integer, the expert choice of each (token × top-k)
    record of a row, in [0, num_experts).  Returns (bins (B, E, C) int32:
    the record index in each bin or -1, kept (B, R) bool, slot (B, R)
    int32: the capacity slot each record landed in, or -1), equal to the
    JAX ``sort_based_dispatch`` vmapped over the rows.
    """
    b, r = expert_ids.shape
    dev = expert_ids.device
    ids = expert_ids.to(torch.int64)
    order = torch.argsort(ids, dim=1, stable=True)            # phase 1: sort
    sorted_e = ids.gather(1, order)
    pos = torch.arange(r, device=dev).expand(b, r)
    seg_start = torch.searchsorted(                           # left side
        sorted_e, torch.arange(num_experts, device=dev).expand(b, num_experts)
        .contiguous())
    rank = pos - seg_start.gather(1, sorted_e)                # phase 2
    keep = rank < capacity
    # phase 3: records of rank < capacity into the (E, C) bins.  A dropped
    # record goes to expert row E, a spare row sliced off afterwards (the
    # reference's index_update at row E with mode="drop"), so no index is
    # out of range and no host sync picks the kept records
    rows = torch.arange(b, device=dev)[:, None]
    flat = ((rows * (num_experts + 1)
             + torch.where(keep, sorted_e, num_experts)) * capacity
            + rank.clamp(max=capacity - 1))
    bins = torch.full((b, num_experts + 1, capacity), -1, dtype=torch.int32,
                      device=dev)
    bins.view(-1).scatter_(0, flat.reshape(-1),
                           torch.where(keep, order, -1).to(torch.int32)
                           .reshape(-1))
    bins = bins[:, :num_experts]
    slot = torch.empty((b, r), dtype=torch.int32, device=dev).scatter_(
        1, order, torch.where(keep, rank, -1).to(torch.int32))
    kept = torch.empty((b, r), dtype=torch.bool, device=dev).scatter_(
        1, order, keep)
    return bins, kept, slot


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, in
    descending order; equal values in ascending index order (the order of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) → (out (B, S, D) in the compute dtype, aux: float32
    0-d tensors ``moe_aux_loss``, ``moe_z_loss``, ``moe_drop_fraction``)."""
    select_moe_mode(cfg)
    dt = cfg.dtype
    b0, s0, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    # dispatch groups: rows are merged into groups of `moe_group_rows`, so
    # that decode dispatch amortizes the capacity floor across the batch
    # (prefill merges a wave's prompts into one group: their drops couple)
    g_rows = max(1, min(cfg.moe_group_rows, b0))
    if b0 % g_rows:
        g_rows = 1
    b, s = b0 // g_rows, g_rows * s0
    x = x.reshape(b, s, d)
    cap = _capacity(s, cfg)

    logits = (x @ params["router"].to(dt)).float()            # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = top_k(probs, k)                       # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux losses (Switch §4: load balance; ST-MoE: router z-loss)
    density = F.one_hot(choice[..., 0], e).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    aux_loss = e * (density * density_proxy).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    bins, kept, _ = sort_based_dispatch(choice.reshape(b, s * k), cap, e)
    # bins: (B, E, C) record indices into the s*k records of the row
    safe_bins = bins.clamp(min=0).to(torch.int64)
    bin_valid = bins >= 0
    bin_token = safe_bins // k                                # record → token
    rows = torch.arange(b, device=x.device)[:, None]

    # gather tokens into expert bins: (B, E, C, D), empty bins zeroed
    xe = x[rows, bin_token.reshape(b, e * cap)].reshape(b, e, cap, d)
    xe = torch.where(bin_valid[..., None], xe, 0.0)

    # expert FFNs: grouped products over the E axis, (E, B·C, ·)
    xg = xe.transpose(0, 1).reshape(e, b * cap, d)
    g = torch.bmm(xg, params["w_gate"].to(dt))
    u = torch.bmm(xg, params["w_up"].to(dt))
    ye = torch.bmm(F.silu(g) * u, params["w_down"].to(dt))
    ye = ye.reshape(e, b, cap, d).transpose(0, 1)             # (B, E, C, D)

    # combine: scatter-add the expert outputs back to their tokens,
    # weighted by the gates (empty bins add 0 to token 0, in range)
    bin_gate = gate_vals.reshape(b, s * k).gather(
        1, safe_bins.reshape(b, e * cap)).reshape(b, e, cap)
    bin_gate = torch.where(bin_valid, bin_gate, 0.0)
    contrib = ye * bin_gate[..., None].to(ye.dtype)
    out = torch.zeros((b * s, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, (rows * s + bin_token.reshape(b, e * cap)).reshape(-1),
                   contrib.reshape(b * e * cap, d))
    out = out.to(dt).reshape(b0, s0, d)

    dropped = 1.0 - kept.float().mean()
    return out, {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
                 "moe_drop_fraction": dropped}
