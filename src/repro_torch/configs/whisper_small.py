"""whisper-small [audio] — encoder-decoder transformer backbone.

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.  The mel-spectrogram
+ conv feature extractor frontend is a STUB: input_specs() provides
precomputed frame embeddings (1500, 768).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      FrontendConfig, ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="whisper-small",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=12,              # decoder layers
        encoder_layers=12,
        is_encoder_decoder=True,
        d_model=768,
        d_ff=3072,
        vocab_size=51_865,
        norm="layernorm",
        act="gelu",
        attention=AttentionConfig(
            kind="full",
            num_heads=12,
            num_kv_heads=12,
            head_dim=64,
            rope_theta=0.0,        # whisper uses learned/sinusoidal positions
        ),
        frontend=FrontendConfig(kind="audio_frames", num_positions=1500,
                                embed_dim=768),
        tie_embeddings=True,
    ),
    run=RunConfig(microbatches=1, remat="layer"),
)
