"""gemma3-1b [dense] — 5:1 local:global attention, 128k-capable.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
local window 512, QK-norm, separate rope bases for local/global layers.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="gemma3-1b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=26,              # 26 = 4 groups of (5 local + 1 global) + 2 local
        d_model=1152,
        d_ff=6912,
        vocab_size=262_144,
        act="gelu",
        attention=AttentionConfig(
            kind="local_global",
            num_heads=4,
            num_kv_heads=1,
            head_dim=256,
            window=512,
            local_global_ratio=5,   # 5 local : 1 global
            rope_theta=1_000_000.0, # global layers
            rope_theta_local=10_000.0,
            qk_norm=True,
        ),
        tie_embeddings=True,
        embed_scale=True,
    ),
    run=RunConfig(microbatches=1, remat="layer", max_cache_len=524_288),
)
