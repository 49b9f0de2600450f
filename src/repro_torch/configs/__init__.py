from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "ModelConfig", "RunConfig", "get_config"]
