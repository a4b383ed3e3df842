"""Logical-axis sharding: one rule table maps model-semantic axes to mesh
axes; every parameter and activation names its axes once and the Sharder
turns them into partition specs and, at run time, into each rank's block
and the collectives that the layout needs.

The counterpart of the JAX package's ``repro/parallel/sharding.py``.

Mesh convention (``launch/mesh.py``):
  single-pod:  (16, 16)        axes ("data", "model")
  multi-pod:   (2, 16, 16)     axes ("pod", "data", "model")

``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (the ranks that run the
model) or a :class:`MeshShape`, names and sizes only, which stands in for
JAX's ``AbstractMesh``: the spec tables of a 16 × 16 or 2 × 16 × 16 mesh
resolve without 256 ranks.

Where the JAX package hands a spec to GSPMD, the port keeps local blocks
and writes the collectives out (:mod:`repro_torch.parallel.collectives`).
The run-time layout (:meth:`Sharder.layout`) is the resolved spec with two
axes not sharded yet: the parameters' ``"embed": "data"`` (their FSDP form;
parameters are replicated over the batch axes) and ``mamba_heads`` (Mamba
layers compute replicated on every rank).  Which collective runs is read
from the resolved layout, never from the architecture's name; a dimension
that the divisibility fallback replicates is computed whole on every rank,
with no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.errors import ValidationError

MeshAxes = Union[None, str, Tuple[str, ...]]


DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",      # opt-in sequence parallelism
    # "embed" is the d_model dim of weight matrices: sharding it over the
    # data axis gives 2-D (data × model) fully-sharded parameters and
    # optimizer state (ZeRO-3/FSDP); the port's run-time layout keeps
    # parameters replicated over the batch axes for now
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,        # used instead of "experts" when E ∤ axis
    "moe_cap": None,           # opt-in: shard expert-capacity slots
    "mamba_heads": "model",
    "mamba_state": None,
    "layers": None,            # stacked leading axis
    "conv": None,
}

BATCH_AXES = ("pod", "data")
# logical axes the run-time layout keeps replicated (see the module doc)
RUNTIME_REPLICATED = ("mamba_heads",)


class MeshShape:
    """Names and sizes of a mesh with no ranks behind it (the JAX
    ``AbstractMesh``): enough to resolve specs, not to run collectives."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValidationError(f"{len(axis_sizes)} sizes for axes "
                                  f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    def __repr__(self):
        return f"MeshShape({self.shape})"


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return {name: mesh.size(i) for i, name in enumerate(mesh_axis_names(mesh))}


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of names; a one-name tuple is stored as the name, as JAX's
    ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Layout(NamedTuple):
    """The counterpart of a ``NamedSharding``: a mesh and a spec."""
    mesh: object
    spec: PartitionSpec


class Split(NamedTuple):
    """How one dimension is cut at run time: the mesh axes it is split over
    (empty: replicated), the shard count and this rank's block index."""
    axes: Tuple[str, ...]
    size: int
    index: int


REPLICATED = Split((), 1, 0)


def _entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass
class Sharder:
    """Turns logical axis names into specs; inert when mesh is None."""

    mesh: Optional[object] = None
    rules: Dict[str, MeshAxes] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def _resolve(self, axis: Optional[str],
                 dim: Optional[int] = None) -> MeshAxes:
        if axis is None:
            return None
        if axis not in self.rules:
            raise KeyError(f"unknown logical axis {axis!r}")
        target = self.rules[axis]
        if target is None:
            return None
        if isinstance(target, str):
            target = (target,)
        sizes = mesh_sizes(self.mesh)
        present = tuple(t for t in target if t in sizes)
        if dim is not None:
            # divisibility fallback: drop trailing mesh axes until the dim
            # shards evenly (the replication is the reference's rule)
            while present:
                if dim % math.prod(sizes[t] for t in present) == 0:
                    break
                present = present[:-1]
        return present or None

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        if self.mesh is None:
            return PartitionSpec()
        if shape is None:
            return PartitionSpec(*(self._resolve(a) for a in axes))
        return PartitionSpec(*(self._resolve(a, d)
                               for a, d in zip(axes, shape)))

    def named(self, axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None) -> Optional[Layout]:
        if self.mesh is None:
            return None
        return Layout(self.mesh, self.spec(axes, shape))

    def constrain(self, x: torch.Tensor,
                  axes: Sequence[Optional[str]]) -> torch.Tensor:
        """The identity on a tensor laid out per ``axes`` (the port's
        layers keep their blocks local); raises on a rank mismatch, as the
        JAX ``with_sharding_constraint`` wrapper does."""
        if self.mesh is None:
            return x
        if len(axes) != x.dim():
            raise ValidationError(f"{len(axes)} axes for rank-{x.dim()} "
                                  "array")
        return x

    def replicated(self) -> Optional[Layout]:
        if self.mesh is None:
            return None
        return Layout(self.mesh, PartitionSpec())

    # -- the run-time layout (port only) -----------------------------------
    def layout(self, axes: Sequence[Optional[str]],
               shape: Sequence[int]) -> Tuple[Split, ...]:
        """Each dimension's :class:`Split` at run time: the resolved spec
        with ``RUNTIME_REPLICATED`` axes replicated and, except on the
        ``batch`` axis, the batch mesh axes dropped."""
        if self.mesh is None:
            return (REPLICATED,) * len(shape)
        if len(axes) != len(shape):
            raise ValidationError(f"{len(axes)} axes for rank-{len(shape)} "
                                  "shape")
        return tuple(self.split(a, d) for a, d in zip(axes, shape))

    def split(self, axis: Optional[str], dim: int) -> Split:
        """One dimension of :meth:`layout`: logical ``axis`` of global size
        ``dim``."""
        if self.mesh is None or axis in RUNTIME_REPLICATED:
            return REPLICATED
        present = _entry_axes(self._resolve(axis, dim))
        if axis != "batch":
            present = tuple(t for t in present if t not in BATCH_AXES)
        sizes = mesh_sizes(self.mesh)
        if math.prod(sizes[t] for t in present) == 1:
            return REPLICATED              # no axis, or axes of size 1
        coord = self._coordinate()
        index = 0
        for t in present:                  # row-major over the entry's axes
            index = index * sizes[t] + coord[t]
        return Split(present, math.prod(sizes[t] for t in present), index)

    def _coordinate(self) -> Dict[str, int]:
        if isinstance(self.mesh, MeshShape):
            raise ValidationError("a MeshShape has no ranks: build the "
                                  "Sharder over a DeviceMesh to run")
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValidationError("this rank is not in the mesh")
        return dict(zip(mesh_axis_names(self.mesh), coord))

    def coordinate(self, mesh_axis: str) -> int:
        """This rank's index along ``mesh_axis``."""
        return self._coordinate()[mesh_axis]

    def groups(self, mesh_axes: Sequence[str]) -> Tuple[object, ...]:
        """The process groups of ``mesh_axes`` (one a mesh dimension)."""
        return tuple(self.mesh.get_group(a) for a in mesh_axes)

    def local(self, x: torch.Tensor,
              axes: Sequence[Optional[str]]) -> torch.Tensor:
        """This rank's block of ``x`` (global shape) under its run-time
        layout: the counterpart of ``device_put`` with a ``NamedSharding``
        (a contiguous copy when cut, ``x`` itself when replicated)."""
        out = x
        for dim, s in enumerate(self.layout(axes, x.shape)):
            if s.size > 1:
                block = x.shape[dim] // s.size
                out = out.narrow(dim, s.index * block, block)
        return out if out is x else out.contiguous()

    def gather(self, x: torch.Tensor,
               axes: Sequence[Optional[str]],
               shape: Sequence[int]) -> torch.Tensor:
        """The global tensor of shape ``shape`` from every rank's block
        ``x`` (collective: every rank of each split axis calls it)."""
        from repro_torch.parallel.collectives import all_gather_dim
        for dim, s in enumerate(self.layout(axes, shape)):
            for name in reversed(s.axes):
                x = all_gather_dim(x, dim, self.mesh.get_group(name))
        return x


def rules_for_config(cfg, mesh) -> Dict[str, MeshAxes]:
    """Per-architecture rule table (EP-vs-TP choice, overrides)."""
    rules = dict(DEFAULT_RULES)
    if mesh is None:
        return rules
    model_size = mesh_sizes(mesh).get("model", 1)
    # expert parallelism only when the expert count divides the model
    # axis; otherwise shard the expert FFN dim and replicate experts
    if getattr(cfg, "num_experts", 0):
        if cfg.num_experts % model_size == 0:
            rules["experts"] = "model"
            rules["expert_ffn"] = None
        else:
            rules["experts"] = None
            rules["expert_ffn"] = "model"
    for axis, target in getattr(cfg, "sharding_overrides", ()):
        rules[axis] = tuple(target) if isinstance(target, list) else target
    return rules


def make_sharder(cfg, mesh) -> Sharder:
    return Sharder(mesh=mesh, rules=rules_for_config(cfg, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _map_tree(fn, tree, *rest, is_leaf):
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v, *(r[i] for r in rest),
                                      is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_named_shardings(sharder: Sharder, spec_tree):
    """Map a tree of logical-axis tuples to :class:`Layout`s (or None)."""
    return _map_tree(lambda axes: sharder.named(axes), spec_tree,
                     is_leaf=_is_axes)


def shard_params(params, sharder: Sharder, specs):
    """Each leaf of ``params`` (global tensors) cut to this rank's block
    under its logical axes in ``specs`` (:func:`repro_torch.models.api.
    param_specs`); the leaves of a replicated layout are returned as they
    are.  With no mesh, ``params`` itself."""
    if sharder.mesh is None:
        return params
    return _map_tree(lambda t, axes: sharder.local(t, axes), params, specs,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))


def gather_params(params, sharder: Sharder, specs, shapes):
    """The reverse of :func:`shard_params`: every leaf's global tensor
    (collective over each split mesh axis).  ``shapes``: a tree of the
    global shapes (e.g. :func:`repro_torch.models.api.param_shapes`)."""
    if sharder.mesh is None:
        return params
    return _map_tree(lambda t, axes, ref: sharder.gather(t, axes, ref.shape),
                     params, specs, shapes,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))
