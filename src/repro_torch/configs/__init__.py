"""Architecture and shape registry of the port.

``ARCH_IDS``: the port's own copies of the JAX package's ten configs
(``repro/configs``), with ``torch`` dtypes; the tests that hold the port
against the JAX package run over these.  ``PORT_ONLY_ARCH_IDS``: configs
the port alone has (granite-4.0-h-small), which no JAX-parity test
looks up.  :func:`get_config` finds both.  Also the port's copies of
``reduce_config`` (the CPU-test variant: same family and pattern, tiny
dims), of ``batch_shapes`` (the inputs of one batch, shapes and dtypes
only), of ``shape_applicable``, ``make_batch`` (a concrete synthetic
batch) and ``input_specs`` (allocation-free stand-ins on the ``meta``
device).

``make_batch`` seeds each input from a stable digest of its name
(``zlib.crc32``): the JAX package folds Python's per-process salted
``hash(name)`` into its key, so its batches change from process to
process; the port's do not.
"""
from __future__ import annotations

import dataclasses
import importlib
import zlib
from typing import Dict, Tuple

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
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "mamba2-2.7b": "mamba2_2p7b",
}
ARCH_IDS = tuple(_MODULES)
_PORT_ONLY = {
    "granite-4.0-h-small": "granite_4h_small",
}
PORT_ONLY_ARCH_IDS = tuple(_PORT_ONLY)


def get_config(arch: str) -> ModelConfig:
    module = _MODULES.get(arch) or _PORT_ONLY.get(arch)
    if module is None:
        raise ValidationError(f"unknown arch {arch!r}; choices: "
                              f"{ARCH_IDS + PORT_ONLY_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, tiny dims — used by the CPU tests."""
    g = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
    kv = 1 if cfg.num_kv_heads == 1 else 2
    reps = 2 if len(cfg.pattern) <= 2 else 1
    enc_layers = 0
    if cfg.is_encoder_decoder:
        enc_layers = len(cfg.encoder_pattern) * 2
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
        moe_shared_ff=32 if cfg.moe_shared_ff else 0,
        # drop-free at test scale: decode equals forward exactly only when
        # the capacity drop sets match
        moe_capacity_factor=8.0,
        ssm_state=16 if cfg.ssm_state else 0,
        mamba_head_dim=8,
        num_encoder_layers=enc_layers,
        num_prefix_tokens=4 if cfg.frontend else 0,
        dtype=torch.float32,
        param_dtype=torch.float32,
        remat=False,
        attn_block_q=32,
        attn_block_k=32,
        vocab_pad_multiple=64,
    )


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeDef] = {
    "train_4k": ShapeDef("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeDef("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeDef("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeDef("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing: only the SSM and the hybrid
# arch qualify; the 8 pure full-attention archs skip it (DESIGN.md §5)
_LONG_OK = {"mamba2-2.7b", "jamba-1.5-large-398b"}


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, "quadratic full attention at 512k ctx (DESIGN.md §5)"
    return True, ""


def batch_shapes(cfg: ModelConfig, shape: ShapeDef) -> Dict[str, tuple]:
    """(shape, dtype) of each input of one training or prefill batch: a
    vision frontend's ``prefix_embeds`` take ``num_prefix_tokens`` of the
    sequence from the tokens; an audio frontend's ``frame_embeds`` are as
    long as the sequence; ``labels`` for training."""
    b, s = shape.global_batch, shape.seq_len
    embeds = torch.bfloat16 if cfg.dtype == torch.bfloat16 else torch.float32
    out: Dict[str, tuple] = {}
    s_text = s
    if cfg.frontend == "vision":
        s_text = s - cfg.num_prefix_tokens
        out["prefix_embeds"] = ((b, cfg.num_prefix_tokens, cfg.d_model),
                                embeds)
    if cfg.frontend == "audio":
        out["frame_embeds"] = ((b, s, cfg.d_model), embeds)
    out["tokens"] = ((b, s_text), torch.int32)
    if shape.kind == "train":
        out["labels"] = ((b, s), torch.int32)
    return out


def make_batch(generator: torch.Generator, cfg: ModelConfig, shape: ShapeDef):
    """A concrete synthetic batch on ``generator``'s device: token inputs
    uniform in [0, vocab), embeddings standard normal in their dtype; a
    vision frontend's ``labels`` are -1 over the image prefix (no loss
    there).  One 31-bit seed is drawn from ``generator``; each input's
    own generator takes it XOR the ``zlib.crc32`` of its name."""
    base = int(torch.randint(0, 2 ** 31, (), generator=generator,
                             device=generator.device))
    batch = {}
    for name, (shp, dt) in batch_shapes(cfg, shape).items():
        gen = torch.Generator(generator.device).manual_seed(
            base ^ zlib.crc32(name.encode()))
        if dt == torch.int32:
            batch[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                        dtype=torch.int32,
                                        device=generator.device)
        else:
            batch[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                      device=generator.device).to(dt)
    if "labels" in batch and cfg.frontend == "vision":
        batch["labels"][:, :cfg.num_prefix_tokens] = -1
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeDef) -> Dict[str, torch.Tensor]:
    """Allocation-free stand-ins of one batch's inputs: tensors of the
    right shape and dtype on the ``meta`` device."""
    return {name: torch.empty(shp, dtype=dt, device="meta")
            for name, (shp, dt) in batch_shapes(cfg, shape).items()}
