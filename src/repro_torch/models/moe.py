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

The counterpart of the JAX package's ``repro/models/moe.py``.  Under a
mesh each rank computes its block of the expert work (the bins (b, E,
cap, d), their products, the expert outputs), cut by one rule,
:func:`work_splits`: on the einsum path (``moe_impl="gspmd"``, or no
manual mode fits, or the batch does not split over the batch axes) as
the JAX constraints ``("batch", "experts", "moe_cap", "expert_ffn")``
resolve through the rules (``sharding_overrides`` included), in the
manual modes as the JAX ``shard_map`` bodies fix them.  The reductions
GSPMD or the bodies insert are written out:

* an ``experts`` split (``ep``; the einsum path where E divides the model
  axis): the local experts' bins and weights, one all-reduce of the
  (b, s, d) partial output;
* a ``moe_cap`` split (``cap``; an override of ``moe_cap``): the local
  capacity slots, the weights whole (``copy_to``: their gradient sums
  over the split); the same all-reduce;
* an ``expert_ffn`` split (``ffn``; the einsum path where E does not
  divide the model axis): the local f-block of the weights, the
  all-reduce over the (b, E, cap, d) expert outputs before the combine.

All reductions run in the compute dtype, as the JAX ``psum`` does.  Aux
outputs follow Switch / GShard: load-balancing loss and the router
z-loss, over the whole batch (their sums all-reduced over the batch axes
when the batch is split).

With ``cfg.moe_shared_ff`` a shared SwiGLU expert of that width runs on
every token (never dropped, no capacity) and its output is added to the
routed sum (granite-4.0-h's ``shared_mlp``); its leaves exist only then,
and it runs on one device only (a mesh is refused).

The layer's phases are spans of :mod:`repro_torch.perf.spans`
(``moe.route``, ``moe.dispatch``, and in :func:`_apply` ``moe.gather``,
``moe.experts``, ``moe.combine``, the gather and the combine timed on the
device too, and ``moe.shared``, device-timed), with the counters
``moe.records`` and ``moe.dropped``; all recorded only under a profiler.

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
from repro_torch.models import mlp as mlp_lib
from repro_torch.parallel.collectives import (all_reduce_sum, copy_to,
                                              gather_from, reduce_from)
from repro_torch.parallel.sharding import (BATCH_AXES, REPLICATED, Sharder,
                                           Split, mesh_axis_names,
                                           mesh_sizes)
from repro_torch.perf import spans

MESH_MODES = ("ep", "cap", "ffn")
MODES = ("auto", "gspmd") + MESH_MODES
# the logical axes of the expert work (b, E, cap, f), to which the JAX
# einsum path constrains its bins, products and expert outputs
WORK_AXES = ("batch", "experts", "moe_cap", "expert_ffn")
# the one of them that each manual body splits over the model axis
_MANUAL_AXIS = {"ep": "experts", "cap": "moe_cap", "ffn": "expert_ffn"}


def moe_defs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, e), ("embed", "experts"), "normal"),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"),
                           "normal", scale_dim=d),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"),
                         "normal", scale_dim=d),
        "w_down": ParamDef((e, f, d), ("experts", "expert_ffn", "embed"),
                           "normal", scale_dim=f),
    }
    if cfg.moe_shared_ff:
        defs["shared"] = mlp_lib.mlp_defs(cfg, cfg.moe_shared_ff)
    return defs


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
    if cfg.moe_shared_ff and mesh is not None:
        raise ValidationError(f"{cfg.name}: the shared expert is not split "
                              "over a mesh yet; run it on one device")


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


def _block(t: torch.Tensor, d: ParamDef, sharder: Sharder, want=None,
           work: Tuple[str, ...] = ()) -> torch.Tensor:
    """The block of the leaf ``d`` that this rank's work uses, from ``t``,
    its :meth:`Sharder.compute_layout` block.  ``want``: the work's
    :class:`Split` of each logical axis it cuts (by default none: the
    leaf whole).  A dimension cut as ``want`` cuts it is used as it is,
    any other gathered whole (its gradient: this rank's slice) and cut
    again.  Over the mesh axes of ``work`` (the work's split) that the
    block does not follow, the leaf feeds only this rank's share of the
    work: ``copy_to``, so that its gradient sums over them."""
    follows, recut = (), []
    for dim, (axis, have) in enumerate(zip(
            d.axes, sharder.compute_layout(d.axes, d.shape))):
        split = (want or {}).get(axis, REPLICATED)
        if have == split:
            follows += have.axes
        else:
            t = gather_from(t, dim, sharder.groups(have.axes))
            recut.append((dim, split))
    t = copy_to(t, sharder.groups(tuple(a for a in work
                                        if a not in follows)))
    for dim, split in recut:
        if split.size > 1:
            n = t.shape[dim] // split.size
            t = t.narrow(dim, split.index * n, n)
    return t


def _apply(x, bin_token, w, records, ye_groups=()) -> torch.Tensor:
    """The expert products and the combine, on whatever bins and weights
    this rank holds: x (b, s, d) in the compute dtype; bin_token (b, El,
    Cl) the token of each bin (never -1: an empty bin holds token 0);
    ``w`` the (El, d, f) / (El, f, d) weights; ``records`` (expert, slot,
    gate), each (b, s·k), every (token, choice) record's bin among these
    and its gate (0 for a record dropped or held by another rank).
    ``ye_groups``: the groups that sum the expert outputs before the
    combine (an expert_ffn split's partial products over its f-block).

    The combine gathers each record's expert output and sums a token's k
    records in their order: no atomic adds, so an output that every rank
    of a group computes whole is the same on each of them (the routing of
    the next layer depends on it).  Returns (b, s, d)."""
    b, s, d = x.shape
    el, cl = bin_token.shape[1], bin_token.shape[2]
    rows = torch.arange(b, device=x.device)[:, None]
    with spans.span("moe.gather", device=x.is_cuda):
        xg = x[rows, bin_token.reshape(b, el * cl)].reshape(b, el, cl, d) \
            .transpose(0, 1).reshape(el, b * cl, d)
    with spans.span("moe.experts"):
        g = torch.bmm(xg, w["w_gate"])
        u = torch.bmm(xg, w["w_up"])
        ye = torch.bmm(F.silu(g) * u, w["w_down"])
        ye = ye.reshape(el, b, cl, d).transpose(0, 1)     # (b, El, Cl, d)
        ye = reduce_from(ye, ye_groups).reshape(b, el * cl, d)
    with spans.span("moe.combine", device=x.is_cuda):
        expert, slot, gate = records
        got = ye[rows, (expert * cl + slot).clamp(0, el * cl - 1)]
        contrib = got * gate[..., None].to(ye.dtype)       # (b, s·k, d)
        return contrib.reshape(b, s, -1, d).sum(dim=2)


def work_splits(cfg: ModelConfig, sharder: Sharder, mode: str, b: int,
                cap: int) -> Tuple[Split, Split, Split]:
    """The :class:`Split` of the experts, the capacity slots and the
    expert FFN dimension of this rank's block of the expert work (b, E,
    cap, f), b the global batch's dispatch groups: on the einsum path as
    the JAX constraints ``WORK_AXES`` resolve (:class:`ValidationError`
    where one mesh axis is mapped twice, as JAX refuses it); in a manual
    mode as its ``shard_map`` spec fixes them (its axis over model)."""
    shape = (b, cfg.num_experts, cap, cfg.d_ff)
    if mode in MESH_MODES:
        axis = _MANUAL_AXIS[mode]
        dim = shape[WORK_AXES.index(axis)]
        msize = mesh_sizes(sharder.mesh).get("model", 1)
        if dim % msize:
            raise ValidationError(f"{cfg.name}: moe_impl {mode!r} needs the "
                                  f"{axis} dimension ({dim}) divisible by "
                                  f"the model axis ({msize})")
        rules = dict(sharder.rules, experts=None, moe_cap=None,
                     expert_ffn=None)
        rules[axis] = "model"
        sharder = Sharder(sharder.mesh, rules)
    return sharder.cut(WORK_AXES, shape)[1:]


def _cut(w, bin_token, records, cfg, sharder: Sharder, splits):
    """This rank's bins, records and weights, cut from the whole dispatch
    (bins (b, E, cap)) and its weight blocks ``w`` as ``splits``
    (experts, moe_cap, expert_ffn) say: the local experts (the expert
    index shifted, a gate of 0 for other ranks'), the local slots, the
    local f-block of the weights.  Returns (bin_token, records, w)."""
    es, cs, fs = splits
    *index, gate = records                  # each record's expert, slot
    # the replicated gates, cut to this rank's bins
    gate = copy_to(gate, sharder.groups(es.axes + cs.axes))
    for dim, split in ((1, es), (2, cs)):
        if split.size > 1:
            n = bin_token.shape[dim] // split.size
            lo = split.index * n
            bin_token = bin_token.narrow(dim, lo, n)
            i = index[dim - 1]
            gate = torch.where((i >= lo) & (i < lo + n), gate, 0.0)
            index[dim - 1] = i - lo
    defs = moe_defs(cfg)
    work = es.axes + cs.axes + fs.axes
    w = {name: _block(t, defs[name], sharder,
                      {"experts": es, "expert_ffn": fs}, work)
         for name, t in w.items()}
    return bin_token, (*index, gate), w


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
    with spans.span("moe.route"):
        router = _block(params["router"].to(dt), defs["router"], sharder)
        logits = (x @ router).float()                         # (B, S, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, choice = top_k(probs, k)                   # (B, S, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        # aux losses (Switch §4: load balance; ST-MoE: router z-loss),
        # means over the whole batch: their sums all-reduced before the
        # product
        if not bgroups:
            density = F.one_hot(choice[..., 0], e).float().mean(dim=(0, 1))
            density_proxy = probs.mean(dim=(0, 1))
            z_loss = torch.logsumexp(logits, dim=-1).square().mean()
        else:
            tokens = float(bglob * s0)
            density = all_reduce_sum(F.one_hot(choice[..., 0], e).float()
                                     .sum(dim=(0, 1)), bgroups) / tokens
            density_proxy = reduce_from(probs.sum(dim=(0, 1)),
                                        bgroups) / tokens
            z_loss = reduce_from(torch.logsumexp(logits, dim=-1).square()
                                 .sum(), bgroups) / tokens
        aux_loss = e * (density * density_proxy).sum()

    with spans.span("moe.dispatch"):
        bins, kept, slot = sort_based_dispatch(choice.reshape(b, s * k), cap,
                                               e)
        # bins: (B, E, C) record indices into the s*k records of the row;
        # each record's (expert, slot, gate), the gate 0 where it was
        # dropped
        bin_token = bins.clamp(min=0).to(torch.int64) // k    # record → token
        records = (choice.reshape(b, s * k), slot.to(torch.int64),
                   torch.where(kept, gate_vals.reshape(b, s * k), 0.0))
        if bgroups:
            dropped = 1.0 - all_reduce_sum(kept.float().sum(), bgroups) \
                / float(bglob * s0 * k)
        else:
            dropped = 1.0 - kept.float().mean()
        if spans.active():
            # this rank's records and the dropped ones, summed on the device
            spans.count("moe.records", kept.numel())
            spans.count("moe.dropped",
                        kept.numel() - kept.sum(dtype=torch.int64))
        aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_drop_fraction": dropped}

        mode = select_moe_mode(cfg, mesh, cap)
        if mode in MESH_MODES:
            check_moe_mode(cfg, mesh)
            # the manual bodies need the batch to split exactly over the
            # batch axes, else the einsum path (e.g. batch-1 decode)
            if (bglob // g_rows) % _batch_size(mesh):
                mode = "gspmd"
        # this rank's block of the expert work; the reductions that GSPMD
        # inserts written out: the expert outputs summed over an
        # expert_ffn split before the combine, the (b, s, d) partial output
        # over an experts or moe_cap split
        es, cs, fs = splits = work_splits(cfg, sharder, mode,
                                          bglob // g_rows, cap)
        w = {name: params[name].to(dt)
             for name in ("w_gate", "w_up", "w_down")}
        bin_token, records, w = _cut(w, bin_token, records, cfg, sharder,
                                     splits)
        x = copy_to(x.to(dt), sharder.groups(es.axes + cs.axes + fs.axes))
    out = _apply(x, bin_token, w, records, sharder.groups(fs.axes))
    out = reduce_from(out, sharder.groups(es.axes + cs.axes))
    if cfg.moe_shared_ff:
        with spans.span("moe.shared", device=x.is_cuda):
            out = out + mlp_lib.mlp(params["shared"], x, cfg)
    return out.to(dt).reshape(b0, s0, d), aux
