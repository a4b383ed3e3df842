"""Dense gated MLPs (SwiGLU / GeGLU).

Under a mesh that splits ``ffn``, ``w_gate`` / ``w_up`` run
column-parallel and ``w_down`` row-parallel: each rank computes its block
of the hidden width and the partial outputs are all-reduced.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.parallel.collectives import copy_to, reduce_from
from repro_torch.parallel.sharding import Sharder


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "ffn"), "normal"),
        "w_up": ParamDef((d, f), ("embed", "ffn"), "normal"),
        "w_down": ParamDef((f, d), ("ffn", "embed"), "normal"),
    }


def mlp(params, x: torch.Tensor, cfg: ModelConfig,
        sharder: Optional[Sharder] = None,
        activation: str = "silu") -> torch.Tensor:
    dt = cfg.dtype
    sharder = sharder or Sharder()
    groups = sharder.groups(sharder.split("ffn", cfg.d_ff).axes)
    x = copy_to(x, groups)
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    return reduce_from((act * u) @ params["w_down"].to(dt), groups)
