"""The model stack of the port: the dense transformer's serving path."""
from repro_torch.models.api import LayerSpec, ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["LayerSpec", "ModelConfig", "Model"]
