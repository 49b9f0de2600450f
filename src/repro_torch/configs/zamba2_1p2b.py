"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      ModelConfig, RunConfig, SSMConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=38,
        d_model=2048,
        d_ff=8192,
        vocab_size=32_000,
        attention=AttentionConfig(
            kind="full",           # the shared block is full attention...
            num_heads=32,
            num_kv_heads=32,
            head_dim=64,
            window=4096,           # ...but long_500k mode uses this window
            rope_theta=10_000.0,
        ),
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      chunk=128, ngroups=1),
        shared_attn_every=6,       # shared transformer block applied every 6 mamba layers
        tie_embeddings=True,
    ),
    run=RunConfig(microbatches=1, remat="layer", max_cache_len=524_288),
)
