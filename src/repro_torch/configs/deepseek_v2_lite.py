"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400.
[arXiv:2405.04434]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, MLAConfig,
                                      ModelConfig, MoEConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="arXiv:2405.04434",
        num_layers=27,
        d_model=2048,
        d_ff=1408,                  # routed-expert FFN size
        vocab_size=102_400,
        attention=AttentionConfig(
            kind="mla",
            num_heads=16,
            num_kv_heads=16,
            head_dim=128,
            rope_theta=10_000.0,
            mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128),
        ),
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_expert=1408,
                      d_shared=2816, first_dense_layers=1, dense_d_ff=10_944,
                      aux_loss_coef=0.001),
    ),
    run=RunConfig(microbatches=2, remat="layer"),
)
