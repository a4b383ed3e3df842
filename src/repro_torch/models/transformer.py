"""The dense pattern-block transformer: forward, prefill and decode.

A model is ``num_blocks`` repetitions of a *pattern block* (a tuple of
LayerSpecs); parameters are stacked on a leading ``layers`` axis, as in the
JAX package, and a Python loop over that axis replaces its ``lax.scan``.
Per-layer KV caches are stacked the same way.

This slice covers the attention mixers ``attn``, ``attn_local`` and
``attn_bidir`` with the ``dense`` MLP.  Mamba, MoE, cross-attention,
encoder-decoder models and frontends raise :class:`ValidationError`: they
are later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.api import (LayerSpec, ModelConfig, init_params,
                                    stack_defs)
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (embed_defs, embed_tokens, rmsnorm,
                                       rmsnorm_defs, unembed)

MIXERS = ("attn", "attn_local", "attn_bidir")


def check_supported(cfg: ModelConfig) -> None:
    """Raise :class:`ValidationError` for what this slice does not run."""
    for spec in cfg.pattern:
        if spec.mixer not in MIXERS or spec.mlp != "dense" or spec.cross_attn:
            raise ValidationError(
                f"{cfg.name}: layer {spec} is not ported (mixers {MIXERS} "
                "with the dense MLP only; Mamba, MoE and cross-attention are "
                "later slices)")
    if cfg.num_experts or cfg.is_encoder_decoder or cfg.frontend is not None:
        raise ValidationError(
            f"{cfg.name}: MoE, encoder-decoder models and frontends are not "
            "ported")


def _sublayer_defs(cfg: ModelConfig):
    return {"norm_mixer": rmsnorm_defs(cfg.d_model),
            "mixer": attn_lib.attn_defs(cfg),
            "norm_mlp": rmsnorm_defs(cfg.d_model),
            "mlp": mlp_lib.mlp_defs(cfg)}


def block_defs(cfg: ModelConfig, pattern: Tuple[LayerSpec, ...]):
    return {f"layer{i}": _sublayer_defs(cfg) for i in range(len(pattern))}


def model_defs(cfg: ModelConfig):
    check_supported(cfg)
    return {
        "embed": embed_defs(cfg),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "blocks": stack_defs(block_defs(cfg, cfg.pattern), cfg.num_blocks),
    }


def _apply_block(cfg: ModelConfig, params_block, x, positions, segments,
                 caches=None):
    """One pattern block; returns (x, new caches of the block)."""
    new_caches: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.pattern):
        sub = params_block[f"layer{i}"]
        h = rmsnorm(sub["norm_mixer"], x, cfg.norm_eps)
        o, nc = attn_lib.attention_layer(
            sub["mixer"], h, cfg, causal=spec.mixer != "attn_bidir",
            window=cfg.window if spec.mixer == "attn_local" else None,
            positions=positions, segments=segments,
            cache=None if caches is None else caches[f"layer{i}"])
        if nc is not None:
            new_caches[f"layer{i}"] = nc
        x = x + o
        h = rmsnorm(sub["norm_mlp"], x, cfg.norm_eps)
        x = x + mlp_lib.mlp(sub["mlp"], h, cfg)
    return x, new_caches


def _index(tree, bi: int):
    if isinstance(tree, dict):
        return {key: _index(val, bi) for key, val in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(*(t[bi] for t in tree))
    return tree[bi]


def _run_stack(cfg: ModelConfig, stacked_params, x, positions, segments,
               stacked_caches=None):
    """Run every block in order; per-block cache views are written in
    place, and their new lengths are stored back into the stacked caches."""
    for bi in range(cfg.num_blocks):
        caches = None if stacked_caches is None \
            else _index(stacked_caches, bi)
        x, new = _apply_block(cfg, _index(stacked_params, bi), x, positions,
                              segments, caches)
        for name, nc in new.items():
            stacked_caches[name].length[bi] = nc.length
    return x, stacked_caches


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
    def forward(self, params, batch) -> torch.Tensor:
        """Logits (B, S, padded_vocab) float32 of a token batch
        (``batch["tokens"]`` (B, S); optional ``positions``, ``segments``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_inputs(params, tokens)
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(tokens)
        x, _ = _run_stack(cfg, params["blocks"], x, positions,
                          batch.get("segments"))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, cfg)

    def init_cache(self, batch: int, max_len: int):
        """Stacked per-block KV caches (compute dtype) on the model's device."""
        cfg = self.cfg
        shape = (cfg.num_blocks, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        return {f"layer{i}": KVCache(
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(cfg.num_blocks, dtype=torch.int32))
            for i in range(len(cfg.pattern))}

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """Fill the caches from a token prefix (in place); returns (cache,
        last-position logits (B, 1, padded_vocab))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_inputs(params, tokens)
        x, cache = _run_stack(cfg, params["blocks"], x,
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
        x, cache = _run_stack(cfg, params["blocks"], x, positions, None, cache)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return cache, unembed(params["embed"], x, cfg)
