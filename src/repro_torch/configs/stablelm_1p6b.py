"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352, partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=24,
        d_model=2048,
        d_ff=5632,
        vocab_size=100_352,
        norm="layernorm",
        attention=AttentionConfig(
            kind="full",
            num_heads=32,
            num_kv_heads=32,
            head_dim=64,
            rope_theta=10_000.0,
            rope_fraction=0.25,
        ),
    ),
    run=RunConfig(microbatches=1, remat="layer"),
)
