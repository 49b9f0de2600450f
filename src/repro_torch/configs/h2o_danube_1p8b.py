"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA W=4096.
[arXiv:2401.16818]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="arXiv:2401.16818",
        num_layers=24,
        d_model=2560,
        d_ff=6912,
        vocab_size=32_000,
        attention=AttentionConfig(
            kind="swa",
            num_heads=32,
            num_kv_heads=8,
            head_dim=80,
            window=4096,
            rope_theta=10_000.0,
        ),
    ),
    run=RunConfig(microbatches=1, remat="layer", max_cache_len=524_288),
)
