"""internvl2-76b [vlm] — InternViT + llama3-70b-class language model.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
vision encoder + MLP projector is a STUB: input_specs() provides
precomputed patch embeddings already projected to d_model.
[arXiv:2404.16821]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      FrontendConfig, ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="internvl2-76b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=80,
        d_model=8192,
        d_ff=28_672,
        vocab_size=128_256,
        attention=AttentionConfig(
            kind="full",
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500_000.0,
        ),
        frontend=FrontendConfig(kind="vision_patches", num_positions=256,
                                embed_dim=8192),
    ),
    run=RunConfig(microbatches=8, remat="layer", opt_state_dtype="float32"),
)
