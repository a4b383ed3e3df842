"""The model stack of the port: the decoder-only serving path (attention,
Mamba-2 and MoE layers)."""
from repro_torch.models.api import (LayerSpec, ModelConfig, ParamDef,
                                    init_params)
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.transformer import Model, model_defs

__all__ = ["LayerSpec", "ModelConfig", "ParamDef", "init_params", "KVCache",
           "MambaState", "Model", "model_defs"]
