"""Dense gated MLPs (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.api import ModelConfig, ParamDef


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "ffn"), "normal"),
        "w_up": ParamDef((d, f), ("embed", "ffn"), "normal"),
        "w_down": ParamDef((f, d), ("ffn", "embed"), "normal"),
    }


def mlp(params, x: torch.Tensor, cfg: ModelConfig,
        activation: str = "silu") -> torch.Tensor:
    dt = cfg.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    return (act * u) @ params["w_down"].to(dt)
