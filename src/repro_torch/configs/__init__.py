from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      FrontendConfig, INPUT_SHAPES,
                                      InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, RunConfig, SSMConfig,
                                      XLSTMConfig, TRAIN_4K, PREFILL_32K,
                                      DECODE_32K, LONG_500K)
from repro_torch.configs.registry import (ASSIGNED, all_configs,
                                          applicable_shapes, get_config)

__all__ = [
    "ArchConfig", "AttentionConfig", "FrontendConfig", "INPUT_SHAPES",
    "InputShape", "MLAConfig", "ModelConfig", "MoEConfig", "RunConfig",
    "SSMConfig", "XLSTMConfig", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "ASSIGNED", "all_configs", "applicable_shapes", "get_config",
]
