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

The counterpart of the JAX package's ``repro/models/moe.py``.  Without a
mesh (or where :func:`select_moe_mode` says "gspmd") the experts run on
the einsum path: grouped products over every expert, the weights whole
(gathered from their blocks under a mesh, every rank computing the
same).  Under a mesh the manual modes of the JAX package's ``shard_map``
bodies run on this rank's blocks, with the reductions written out:

* ``ep``:  experts split over the model axis: the local experts' bins,
           their GEMMs and a local scatter, then one all-reduce of the
           (b, s, d) partial output;
* ``cap``: the capacity slots split over the model axis, the (small)
           expert weights gathered whole; the same all-reduce;
* ``ffn``: the expert-FFN dim split; the all-reduce is over the
           (b, E, cap, d) expert outputs, before the combine.

All reductions run in the compute dtype, as the JAX ``psum`` does.  Aux
outputs follow Switch / GShard: load-balancing loss and the router
z-loss, over the whole batch (their sums all-reduced over the batch axes
when the batch is split).

Top-k takes a stable descending sort of the router probabilities, so
among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them (``torch.topk`` leaves ties unordered).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.errors import ValidationError
from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.parallel.collectives import (all_reduce_sum, copy_to,
                                              gather_from, reduce_from)
from repro_torch.parallel.sharding import (BATCH_AXES, Sharder,
                                           mesh_axis_names, mesh_sizes)

MESH_MODES = ("ep", "cap", "ffn")
MODES = ("auto", "gspmd") + MESH_MODES


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


def select_moe_mode(cfg: ModelConfig, mesh=None, cap: int = 0) -> str:
    """Pick the expert-apply strategy for this arch × mesh (the JAX rule):

    * "ep"  — true expert parallelism (experts divide the model axis);
    * "cap" — capacity slots sharded, small expert weights replicated;
    * "ffn" — expert-FFN dim sharded (weights too big to replicate);
    * "gspmd" — the einsum path (no model axis / no fit).

    An explicit ``moe_impl`` is returned as it is; an unknown one raises
    :class:`ValidationError`."""
    if cfg.moe_impl not in MODES:
        raise ValidationError(f"{cfg.name}: unknown moe_impl "
                              f"{cfg.moe_impl!r} (one of {MODES})")
    if cfg.moe_impl != "auto":
        return cfg.moe_impl
    if mesh is None or "model" not in mesh_axis_names(mesh):
        return "gspmd"
    msize = mesh_sizes(mesh)["model"]
    if cfg.num_experts % msize == 0:
        return "ep"
    w_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2   # bf16
    if w_bytes <= 1.0e9 and cap % msize == 0:
        return "cap"
    if cfg.d_ff % msize == 0:
        return "ffn"
    return "gspmd"


def check_moe_mode(cfg: ModelConfig, mesh) -> None:
    """:class:`ValidationError` for an unknown ``moe_impl`` or a mode of
    the manual bodies with no mesh to run on."""
    if select_moe_mode(cfg, mesh) in MESH_MODES and mesh is None:
        raise ValidationError(f"{cfg.name}: moe_impl {cfg.moe_impl!r} "
                              "needs a device mesh (Model(cfg, sharder=...))")


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


def _batch_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in BATCH_AXES if a in sizes)


def _whole(w: torch.Tensor, d: ParamDef, sharder: Sharder) -> torch.Tensor:
    """``w``, this rank's block of the leaf ``d``, gathered whole (this
    rank's slice of the gradient flows back: the whole weight feeds
    replicated work)."""
    for dim, s in enumerate(sharder.layout(d.axes, d.shape)):
        w = gather_from(w, dim, sharder.groups(s.axes))
    return w


def _apply(x, bin_token, w, records, ye_groups=()) -> torch.Tensor:
    """The expert products and the combine, on whatever bins and weights
    this rank holds: x (b, s, d) in the compute dtype; bin_token (b, El,
    Cl) the token of each bin (never -1: an empty bin holds token 0);
    ``w`` the (El, d, f) / (El, f, d) weights; ``records`` (expert, slot,
    gate), each (b, s·k), every (token, choice) record's bin among these
    and its gate (0 for a record dropped or held by another rank).
    ``ye_groups``: the groups that sum the expert outputs before the
    combine (``ffn``'s partial products over its block of f).

    The combine gathers each record's expert output and sums a token's k
    records in their order: no atomic adds, so an output that every rank
    of a group computes whole is the same on each of them (the routing of
    the next layer depends on it).  Returns (b, s, d)."""
    b, s, d = x.shape
    el, cl = bin_token.shape[1], bin_token.shape[2]
    rows = torch.arange(b, device=x.device)[:, None]
    xg = x[rows, bin_token.reshape(b, el * cl)].reshape(b, el, cl, d) \
        .transpose(0, 1).reshape(el, b * cl, d)
    g = torch.bmm(xg, w["w_gate"])
    u = torch.bmm(xg, w["w_up"])
    ye = torch.bmm(F.silu(g) * u, w["w_down"])
    ye = ye.reshape(el, b, cl, d).transpose(0, 1)         # (b, El, Cl, d)
    ye = reduce_from(ye, ye_groups).reshape(b, el * cl, d)
    expert, slot, gate = records
    got = ye[rows, (expert * cl + slot).clamp(0, el * cl - 1)]
    contrib = got * gate[..., None].to(ye.dtype)           # (b, s·k, d)
    return contrib.reshape(b, s, -1, d).sum(dim=2)


def _mesh_blocks(w, bin_token, records, cfg, sharder: Sharder, mode: str):
    """The manual bodies' (``ep`` / ``cap`` / ``ffn``) cut of the work:
    this rank's bins, records and weights from its blocks ``w`` and the
    whole dispatch (bins (b, E, cap)).  Returns (bin_token, records, w,
    the model groups)."""
    e, cap = bin_token.shape[1], bin_token.shape[2]
    msize = mesh_sizes(sharder.mesh)["model"]
    mgroups = sharder.groups(("model",)) if msize > 1 else ()
    midx = sharder.coordinate("model") if msize > 1 else 0
    defs = moe_defs(cfg)
    expert, slot, gate = records
    if mode != "ffn":       # the replicated gates, cut to this rank's bins
        gate = copy_to(gate, mgroups)
    if mode == "ep":
        es = sharder.split("experts", e)
        if es.size != msize or es.axes not in ((), ("model",)):
            raise ValidationError(f"{cfg.name}: moe_impl 'ep' needs the "
                                  f"experts ({e}) split over the model axis "
                                  f"({msize}); the layout splits {es.axes}")
        el = e // msize
        e0 = es.index * el
        bin_token = bin_token[:, e0:e0 + el]
        gate = torch.where((expert >= e0) & (expert < e0 + el), gate, 0.0)
        expert = expert - e0
    elif mode == "cap":
        if cap % msize:
            raise ValidationError(f"{cfg.name}: moe_impl 'cap' needs the "
                                  f"capacity {cap} divisible by the model "
                                  f"axis ({msize})")
        for name in w:      # one replicating gather in the compute dtype
            w[name] = copy_to(_whole(w[name], defs[name], sharder), mgroups)
        cl = cap // msize
        c0 = midx * cl
        bin_token = bin_token[..., c0:c0 + cl]
        gate = torch.where((slot >= c0) & (slot < c0 + cl), gate, 0.0)
        slot = slot - c0
    else:                   # ffn: each rank its block of the expert FFN
        fs = sharder.split("expert_ffn", cfg.d_ff)
        if fs.size != msize:
            if cfg.d_ff % msize:
                raise ValidationError(f"{cfg.name}: moe_impl 'ffn' needs "
                                      f"d_ff {cfg.d_ff} divisible by the "
                                      f"model axis ({msize})")
            fl = cfg.d_ff // msize
            for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
                whole = copy_to(_whole(w[name], defs[name], sharder),
                                mgroups)
                w[name] = whole.narrow(dim, midx * fl, fl)
    return bin_token, (expert, slot, gate), w, mgroups


def moe_layer(params, x: torch.Tensor, cfg: ModelConfig,
              sharder: Optional[Sharder] = None, *,
              batch: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) → (out (B, S, D) in the compute dtype, aux: float32
    0-d tensors ``moe_aux_loss``, ``moe_z_loss``, ``moe_drop_fraction``).

    Under a mesh x holds this rank's rows of a global batch of ``batch``
    rows (default: x's own), cut by the ``batch`` axis's layout."""
    sharder = sharder or Sharder()
    mesh = sharder.mesh
    dt = cfg.dtype
    b0, s0, d = x.shape
    bglob = b0 if batch is None else batch
    e, k = cfg.num_experts, cfg.num_experts_per_token
    # dispatch groups: rows are merged into groups of `moe_group_rows`, so
    # that decode dispatch amortizes the capacity floor across the batch
    # (prefill merges a wave's prompts into one group: their drops couple)
    g_rows = max(1, min(cfg.moe_group_rows, bglob))
    if bglob % g_rows:
        g_rows = 1
    if mesh is not None:
        # keep the grouped row count divisible by the batch shards, or the
        # divisibility fallback would drop data parallelism
        bs = _batch_size(mesh)
        while g_rows > 1 and (bglob // g_rows) % bs:
            g_rows //= 2
    b, s = b0 // g_rows, g_rows * s0
    x = x.reshape(b, s, d)
    cap = _capacity(s, cfg)
    bgroups = sharder.groups(sharder.split("batch", bglob).axes)

    defs = moe_defs(cfg)
    router = _whole(params["router"].to(dt), defs["router"], sharder)
    logits = (x @ router).float()                             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = top_k(probs, k)                       # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux losses (Switch §4: load balance; ST-MoE: router z-loss), means
    # over the whole batch: their sums all-reduced before the product
    if not bgroups:
        density = F.one_hot(choice[..., 0], e).float().mean(dim=(0, 1))
        density_proxy = probs.mean(dim=(0, 1))
        z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    else:
        tokens = float(bglob * s0)
        density = all_reduce_sum(F.one_hot(choice[..., 0], e).float()
                                 .sum(dim=(0, 1)), bgroups) / tokens
        density_proxy = reduce_from(probs.sum(dim=(0, 1)), bgroups) / tokens
        z_loss = reduce_from(torch.logsumexp(logits, dim=-1).square().sum(),
                             bgroups) / tokens
    aux_loss = e * (density * density_proxy).sum()

    bins, kept, slot = sort_based_dispatch(choice.reshape(b, s * k), cap, e)
    # bins: (B, E, C) record indices into the s*k records of the row; each
    # record's (expert, slot, gate), the gate 0 where it was dropped
    bin_token = bins.clamp(min=0).to(torch.int64) // k        # record → token
    records = (choice.reshape(b, s * k), slot.to(torch.int64),
               torch.where(kept, gate_vals.reshape(b, s * k), 0.0))
    if bgroups:
        dropped = 1.0 - all_reduce_sum(kept.float().sum(), bgroups) \
            / float(bglob * s0 * k)
    else:
        dropped = 1.0 - kept.float().mean()
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_drop_fraction": dropped}

    mode = select_moe_mode(cfg, mesh, cap)
    if mode in MESH_MODES:
        check_moe_mode(cfg, mesh)
        # the manual bodies need the batch to split exactly over the
        # batch axes, else the einsum path (e.g. batch-1 decode)
        if (bglob // g_rows) % _batch_size(mesh):
            mode = "gspmd"
    w = {name: params[name].to(dt) for name in ("w_gate", "w_up", "w_down")}
    if mode in MESH_MODES:
        bin_token, records, w, mgroups = _mesh_blocks(
            w, bin_token, records, cfg, sharder, mode)
        x = copy_to(x.to(dt), mgroups)
        out = _apply(x, bin_token, w, records,
                     mgroups if mode == "ffn" else ())
        if mode != "ffn":   # partial over this rank's experts or slots
            out = reduce_from(out, mgroups)
    else:                   # the einsum path: the weights whole everywhere
        w = {name: _whole(t, defs[name], sharder) for name, t in w.items()}
        out = _apply(x, bin_token, w, records)
    return out.to(dt).reshape(b0, s0, d), aux
