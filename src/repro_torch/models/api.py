"""Model configuration and the ParamDef system of the port.

The counterpart of the JAX package's ``repro/models/api.py`` for serving
and training (attention, Mamba-2 and MoE layers, cross-attention, the
encoder stack and the vision / audio frontends): every layer declares its
parameters once as ``ParamDef``s (shape, logical axes, initializer), and
the same declaration drives initialization,
:meth:`ModelConfig.param_count`, :meth:`ModelConfig.active_param_count`
and the check of parameters carried over from the JAX package
(:mod:`repro_torch.convert`).

``dtype`` (compute) and ``param_dtype`` are ``torch`` dtypes.  ``remat``
recomputes each pattern block in the backward pass
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).
``sharding_overrides`` edit the rule table of
:func:`repro_torch.parallel.sharding.rules_for_config`; :func:`param_specs`
and :func:`param_shapes` give the logical axes and the global shapes
(``meta`` tensors) of a ParamDef tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern block."""
    mixer: str          # "attn" | "attn_local" | "attn_bidir" | "mamba"
    mlp: str            # "dense" | "moe" | "none"
    cross_attn: bool = False   # decoder cross-attention (enc-dec models)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...]          # repeats to num_layers
    # attention details
    window: Optional[int] = None            # for attn_local
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_rows: int = 1          # rows merged per dispatch group
    moe_impl: str = "auto"           # auto | gspmd | ep | cap | ffn
    moe_shared_ff: int = 0           # a shared SwiGLU expert's width; 0: none
    # per-arch sharding rule overrides: (("logical_axis", "mesh_axis"|None),…)
    sharding_overrides: Tuple[Tuple[str, Any], ...] = ()
    # Mamba-2 (SSD)
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_conv_bias: bool = False    # a bias on the conv of x, B and C
    # the gated RMSNorm over d_inner / g channels; 0: each head on its own
    mamba_norm_groups: int = 0
    # the scalar multipliers (granite's): the embeddings (None: √d_model),
    # the attention scores (None: head_dim**-0.5), each residual branch,
    # and the divisor of the logits
    embedding_multiplier: Optional[float] = None
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    use_rope: bool = True            # False: no positional encoding (NoPE)
    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_pattern: Tuple[LayerSpec, ...] = ()
    # multimodal frontend stub
    frontend: Optional[str] = None          # "vision" | "audio"
    num_prefix_tokens: int = 0
    # numerics
    norm_eps: float = 1.0e-6
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16     # compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True                      # recompute blocks in backward
    attn_impl: str = "blockwise"            # dense | blockwise
    attn_block_q: int = 512
    attn_block_k: int = 512
    vocab_pad_multiple: int = 256

    @property
    def d_inner(self) -> int:               # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // self.mamba_head_dim

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5 if self.attention_multiplier is None \
            else self.attention_multiplier

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def num_blocks(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, \
            f"{self.num_layers} layers not a multiple of pattern {len(self.pattern)}"
        return self.num_layers // len(self.pattern)

    def param_count(self) -> int:
        """Total parameters (exact, from the ParamDef tree)."""
        from repro_torch.models import transformer
        return int(sum(np.prod(d.shape)
                       for _, d in iter_leaves(transformer.model_defs(self))))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of the experts; every
        leaf with an ``experts`` axis, the router's too, counts k of E)."""
        if not self.num_experts:
            return self.param_count()
        from repro_torch.models import transformer
        total = 0
        for _, d in iter_leaves(transformer.model_defs(self)):
            size = int(np.prod(d.shape))
            if "experts" in d.axes:
                size = size // d.shape[d.axes.index("experts")] \
                    * self.num_experts_per_token
            total += size
        return total


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis names
    init: str = "normal"                   # normal | zeros | ones | embed | scale
    scale_dim: Optional[int] = None        # fan-in override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def iter_leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict (of ParamDefs, arrays or tensors), in
    insertion order; paths join the keys with "/"."""
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from iter_leaves(val, path)
        else:
            yield path, val


def _init_leaf(d: ParamDef, dtype, device, generator) -> torch.Tensor:
    if d.init in ("zeros", "scale"):    # scale: RMSNorm, applied as (1 + s)
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.scale_dim if d.scale_dim is not None else d.shape[0]
    if d.init == "embed":
        fan_in = d.shape[-1]   # (vocab, d_model): unit-scale after ·√d input mult
    std = 1.0 / float(np.sqrt(max(fan_in, 1)))
    draw = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(device=device, dtype=dtype)


def init_params(defs, dtype, generator: torch.Generator, *,
                device="cuda", local=None) -> Dict:
    """Materialize a ParamDef tree on ``device``.

    The same distributions as the JAX package (normal with std
    1/sqrt(fan-in), zeros for norm scales), not the same numbers: the
    leaves are drawn one after another, in the tree's order, from
    ``generator`` (on its own device), then moved to ``device``.  With
    ``local`` (``Sharder.local``), each leaf is cut to this rank's block
    as soon as it is drawn, so at most one whole leaf is held: every rank
    draws the same numbers as a single device does.
    """
    def build(node):
        if isinstance(node, ParamDef):
            leaf = _init_leaf(node, dtype, device, generator)
            return leaf if local is None else local(leaf, node.axes)
        return {key: build(val) for key, val in node.items()}

    return build(defs)


def _map_defs(fn, node):
    if isinstance(node, ParamDef):
        return fn(node)
    return {key: _map_defs(fn, val) for key, val in node.items()}


def param_specs(defs) -> Dict:
    """Logical-axes tree with the same structure as the params."""
    return _map_defs(lambda d: d.axes, defs)


def param_shapes(defs, dtype) -> Dict:
    """Tree of ``meta``-device tensors of each leaf's global shape and
    ``dtype`` (the JAX ``ShapeDtypeStruct`` tree): no memory is taken."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                           device="meta"), defs)


def stack_defs(defs, n: int, axis_name: Optional[str] = "layers") -> Dict:
    """Prepend a stacking dimension (one entry per pattern block)."""
    def stack(node):
        if isinstance(node, ParamDef):
            return ParamDef((n,) + node.shape, (axis_name,) + node.axes,
                            node.init,
                            node.scale_dim if node.scale_dim is not None
                            else (node.shape[0] if node.init == "normal"
                                  else None))
        return {key: stack(val) for key, val in node.items()}

    return stack(defs)
