"""gru-traffic — the paper's own model (§V-B1): 2-layer GRU, hidden 128,
univariate traffic-speed regression on METR-LA-style windows.

Serialized size ~594 KB (the paper's communication-cost payload).
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      ModelConfig, RunConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="gru-traffic",
        family="rnn",
        source="paper §V-B (Lackinger et al. 2024)",
        num_layers=0,
        d_model=128,
        d_ff=0,
        vocab_size=0,
        rnn_hidden=128,
        rnn_layers=2,
        attention=AttentionConfig(kind="none"),
        dtype="float32",
        param_dtype="float32",
    ),
    run=RunConfig(microbatches=1, remat="none", scan_layers=False,
                  learning_rate=1e-4, local_rounds_per_global=2,
                  local_epochs=5),
)
