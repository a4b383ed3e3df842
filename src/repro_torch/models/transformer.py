"""The decoder-only pattern-block transformer: forward, prefill and decode.

A model is ``num_blocks`` repetitions of a *pattern block* (a tuple of
LayerSpecs); parameters are stacked on a leading ``layers`` axis, as in the
JAX package, and a Python loop over that axis replaces its ``lax.scan``.
Per-layer state (KV caches, Mamba states) is stacked the same way and
updated in place.

Mixers: ``attn``, ``attn_local``, ``attn_bidir`` and ``mamba``; MLPs:
``dense``, ``moe`` and ``none``.  Cross-attention, encoder-decoder models,
frontends and the ``moe_impl`` modes that need a mesh raise
:class:`ValidationError`: they are later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import (LayerSpec, ModelConfig, init_params,
                                    stack_defs)
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (embed_defs, embed_tokens, rmsnorm,
                                       rmsnorm_defs, unembed)
from repro_torch.models.mamba import MambaState

MIXERS = ("attn", "attn_local", "attn_bidir", "mamba")
MLPS = ("dense", "moe", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise :class:`ValidationError` for what the port does not run."""
    for spec in cfg.pattern:
        if spec.mixer not in MIXERS or spec.mlp not in MLPS \
                or spec.cross_attn:
            raise ValidationError(
                f"{cfg.name}: layer {spec} is not ported (mixers {MIXERS}, "
                f"MLPs {MLPS}; cross-attention is a later slice)")
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise ValidationError(
            f"{cfg.name}: encoder-decoder models and frontends are not "
            "ported")
    if any(spec.mlp == "moe" for spec in cfg.pattern):
        moe_lib.select_moe_mode(cfg)


def _sublayer_defs(cfg: ModelConfig, spec: LayerSpec):
    d: Dict[str, Any] = {"norm_mixer": rmsnorm_defs(cfg.d_model)}
    if spec.mixer == "mamba":
        d["mixer"] = mamba_lib.mamba_defs(cfg)
    else:
        d["mixer"] = attn_lib.attn_defs(cfg)
    if spec.mlp == "dense":
        d["norm_mlp"] = rmsnorm_defs(cfg.d_model)
        d["mlp"] = mlp_lib.mlp_defs(cfg)
    elif spec.mlp == "moe":
        d["norm_mlp"] = rmsnorm_defs(cfg.d_model)
        d["mlp"] = moe_lib.moe_defs(cfg)
    return d


def block_defs(cfg: ModelConfig, pattern: Tuple[LayerSpec, ...]):
    return {f"layer{i}": _sublayer_defs(cfg, s) for i, s in enumerate(pattern)}


def model_defs(cfg: ModelConfig):
    check_supported(cfg)
    return {
        "embed": embed_defs(cfg),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "blocks": stack_defs(block_defs(cfg, cfg.pattern), cfg.num_blocks),
    }


def _apply_block(cfg: ModelConfig, params_block, x, positions, segments,
                 caches=None):
    """One pattern block; returns (x, new caches of the block, aux (2,)
    float32: the block's summed MoE [aux loss, z-loss])."""
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        sub = params_block[f"layer{i}"]
        h = rmsnorm(sub["norm_mixer"], x, cfg.norm_eps)
        cache_i = None if caches is None else caches[f"layer{i}"]
        if spec.mixer == "mamba":
            o, nc = mamba_lib.mamba_layer(sub["mixer"], h, cfg,
                                          state=cache_i)
        else:
            o, nc = attn_lib.attention_layer(
                sub["mixer"], h, cfg, causal=spec.mixer != "attn_bidir",
                window=cfg.window if spec.mixer == "attn_local" else None,
                positions=positions, segments=segments, cache=cache_i)
        if nc is not None:
            new_caches[f"layer{i}"] = nc
        x = x + o
        if spec.mlp == "dense":
            h = rmsnorm(sub["norm_mlp"], x, cfg.norm_eps)
            x = x + mlp_lib.mlp(sub["mlp"], h, cfg)
        elif spec.mlp == "moe":
            h = rmsnorm(sub["norm_mlp"], x, cfg.norm_eps)
            o, moe_aux = moe_lib.moe_layer(sub["mlp"], h, cfg)
            aux = aux + torch.stack([moe_aux["moe_aux_loss"],
                                     moe_aux["moe_z_loss"]])
            x = x + o
    return x, new_caches, aux


def _index(tree, bi: int):
    if isinstance(tree, dict):
        return {key: _index(val, bi) for key, val in tree.items()}
    if isinstance(tree, (KVCache, MambaState)):
        return type(tree)(*(t[bi] for t in tree))
    return tree[bi]


def _run_stack(cfg: ModelConfig, stacked_params, x, positions, segments,
               stacked_caches=None):
    """Run every block in order; returns (x, the stacked caches, aux (2,)
    summed over the blocks).  Attention writes K/V into its block's cache
    views itself, and its new length is stored back here; a Mamba layer's
    new state (h and the three conv histories) is copied into its block's
    rows of the stacked float32 state."""
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for bi in range(cfg.num_blocks):
        caches = None if stacked_caches is None \
            else _index(stacked_caches, bi)
        x, new, a = _apply_block(cfg, _index(stacked_params, bi), x,
                                 positions, segments, caches)
        aux = aux + a
        for name, nc in new.items():
            if isinstance(nc, KVCache):
                stacked_caches[name].length[bi] = nc.length
            else:
                for dst, src in zip(stacked_caches[name], nc):
                    dst[bi].copy_(src)
    return x, stacked_caches, aux


class Model:
    """A thin class over a parameter dict: static config and device only.

    ``params`` is the nested dict of :meth:`init` (or of
    :func:`repro_torch.convert.model_params_from_arrays`), with the JAX
    package's structure and names.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    def defs(self):
        return model_defs(self.cfg)

    def init(self, generator: torch.Generator):
        return init_params(self.defs(), self.cfg.param_dtype, generator,
                           device=self.device)

    def _embed_inputs(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                                device=x.device)

    @staticmethod
    def _positions(tokens: torch.Tensor) -> torch.Tensor:
        return torch.arange(tokens.shape[1], device=tokens.device) \
            .expand(tokens.shape)

    @torch.no_grad()
    def forward_with_aux(self, params, batch):
        """(logits (B, S, padded_vocab) float32, aux (2,) float32: the MoE
        [aux loss, z-loss] summed over the layers, zeros without MoE) of a
        token batch (``batch["tokens"]`` (B, S); optional ``positions``,
        ``segments``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_inputs(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(tokens)
        x, _, aux = _run_stack(cfg, params["blocks"], x, positions,
                               batch.get("segments"))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, cfg), aux

    def forward(self, params, batch) -> torch.Tensor:
        """The logits of :meth:`forward_with_aux`."""
        return self.forward_with_aux(params, batch)[0]

    def init_cache(self, batch: int, max_len: int):
        """Stacked per-block caches on the model's device: KV caches in the
        compute dtype for attention layers, a float32 ``MambaState`` for
        Mamba layers."""
        cfg = self.cfg
        nb = cfg.num_blocks
        shape = (nb, batch, cfg.num_kv_heads, max_len, cfg.head_dim)

        def one(spec: LayerSpec):
            if spec.mixer == "mamba":
                return mamba_lib.init_mamba_state(
                    cfg, batch, torch.float32, device=self.device, layers=nb)
            return KVCache(
                torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(nb, dtype=torch.int32))

        return {f"layer{i}": one(s) for i, s in enumerate(cfg.pattern)}

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """Fill the caches from a token prefix (in place); returns (cache,
        last-position logits (B, 1, padded_vocab))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_inputs(params, tokens)
        x, cache, _ = _run_stack(cfg, params["blocks"], x,
                                 self._positions(tokens), None, cache)
        x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return cache, unembed(params["embed"], x, cfg)

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, pos: int):
        """One decode step (cache updated in place).  token: (B, 1) int;
        pos: its position.  Returns (cache, logits (B, 1, padded_vocab))."""
        cfg = self.cfg
        x = self._embed_inputs(params, token)
        positions = torch.full(token.shape, int(pos), dtype=torch.int64,
                               device=token.device)
        x, cache, _ = _run_stack(cfg, params["blocks"], x, positions, None,
                                 cache)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return cache, unembed(params["embed"], x, cfg)
