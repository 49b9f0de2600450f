"""Registry of the configurations the port can run so far.

The paper's own GRU, the dense transformers (stablelm, which the LM
tiers serve by default; h2o-danube with sliding-window attention;
gemma3 with 5 local : 1 global layers, QK-norm and head dim 256), the
MoE transformers (deepseek-v2-lite with MLA, qwen2-moe with GQA) and the
Mamba2 + shared-attention hybrid (zamba2) are ported;
every other architecture of ``repro/configs/registry.py`` waits for its
slice (ROADMAP.md)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gru-traffic": "repro_torch.configs.gru_traffic",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1p6b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to PyTorch yet (known: "
            f"{sorted(_MODULES)}); see ROADMAP.md for the order of slices")
    return importlib.import_module(_MODULES[name]).CONFIG
