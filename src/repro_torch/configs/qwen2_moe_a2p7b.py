"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                      MoEConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        d_model=2048,
        d_ff=1408,
        vocab_size=151_936,
        attention=AttentionConfig(
            kind="full",
            num_heads=16,
            num_kv_heads=16,
            head_dim=128,
            rope_theta=1_000_000.0,
        ),
        moe=MoEConfig(num_experts=60, num_shared=4, top_k=4, d_expert=1408,
                      d_shared=5632, aux_loss_coef=0.001),
    ),
    run=RunConfig(microbatches=2, remat="layer"),
)
