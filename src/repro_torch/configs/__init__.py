"""Architecture registry of the port: the decoder-only configs.

The port's own copies of the JAX package's config data
(``repro/configs``), with ``torch`` dtypes, and of ``reduce_config`` (the
CPU-test variant: same family and pattern, tiny dims).  The two archs
that need the encoder-decoder or frontend paths (phi-3-vision-4.2b,
seamless-m4t-medium) are a later slice: ``get_config`` raises for them.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.models.api import ModelConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b",
    "grok-1-314b": "grok_1_314b",
    "gemma2-2b": "gemma2_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "smollm-360m": "smollm_360m",
    "minitron-4b": "minitron_4b",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "mamba2-2.7b": "mamba2_2p7b",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValidationError(f"unknown or not yet ported arch {arch!r}; "
                              f"choices: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, tiny dims — used by the CPU tests."""
    g = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
    kv = 1 if cfg.num_kv_heads == 1 else 2
    reps = 2 if len(cfg.pattern) <= 2 else 1
    return dataclasses.replace(
        cfg,
        num_layers=len(cfg.pattern) * reps,
        d_model=64,
        num_heads=g * kv,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=515,           # odd on purpose: exercises vocab padding
        window=32 if cfg.window else None,
        num_experts=4 if cfg.num_experts else 0,
        num_experts_per_token=min(cfg.num_experts_per_token, 2),
        # drop-free at test scale: decode equals forward exactly only when
        # the capacity drop sets match
        moe_capacity_factor=8.0,
        ssm_state=16 if cfg.ssm_state else 0,
        mamba_head_dim=8,
        dtype=torch.float32,
        param_dtype=torch.float32,
        attn_block_q=32,
        attn_block_k=32,
        vocab_pad_multiple=64,
    )
