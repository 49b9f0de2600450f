"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, no separate FFN (d_ff=0).

12L d_model=768 4H vocab=50304.
[arXiv:2405.04517]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                      RunConfig, XLSTMConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="xlstm-125m",
        family="ssm",
        source="arXiv:2405.04517",
        num_layers=12,
        d_model=768,
        d_ff=0,                     # blocks carry their own up-projection
        vocab_size=50_304,
        norm="layernorm",
        attention=AttentionConfig(kind="none", num_heads=4, num_kv_heads=4,
                                  head_dim=192),
        xlstm=XLSTMConfig(num_heads=4, slstm_layers=(3, 9),
                          proj_factor_mlstm=2.0, proj_factor_slstm=1.333,
                          conv_width=4),
        tie_embeddings=True,
    ),
    run=RunConfig(microbatches=1, remat="layer", max_cache_len=524_288),
)
