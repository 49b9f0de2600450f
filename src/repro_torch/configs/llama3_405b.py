"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, rope theta 500k.
[arXiv:2407.21783]

Memory note: optimizer states run in bf16 (opt_state_dtype) so that
params+grads+Adam states fit 16 GB/chip on the 256-chip pod; see
DESIGN.md §5.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                      RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="llama3-405b",
        family="dense",
        source="arXiv:2407.21783",
        num_layers=126,
        d_model=16_384,
        d_ff=53_248,
        vocab_size=128_256,
        attention=AttentionConfig(
            kind="full",
            num_heads=128,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500_000.0,
        ),
    ),
    run=RunConfig(microbatches=16, remat="layer", opt_state_dtype="bfloat16"),
)
