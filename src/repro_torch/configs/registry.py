"""Registry of the assigned architectures (+ the paper's own model): a
copy of ``repro/configs/registry.py`` that names the port's config
modules.  The port has a model for every one of them."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape

_MODULES = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1p6b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "gru-traffic": "repro_torch.configs.gru_traffic",
}

ASSIGNED = tuple(k for k in _MODULES if k != "gru-traffic")


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs(include_paper_model: bool = False) -> Dict[str, ArchConfig]:
    names = list(ASSIGNED) + (["gru-traffic"] if include_paper_model else [])
    return {n: get_config(n) for n in names}


def applicable_shapes(cfg: ArchConfig) -> List[InputShape]:
    """The assigned input shapes this arch runs (DESIGN.md §4 table)."""
    shapes = [INPUT_SHAPES["train_4k"], INPUT_SHAPES["prefill_32k"],
              INPUT_SHAPES["decode_32k"]]
    if cfg.model.sub_quadratic:
        shapes.append(INPUT_SHAPES["long_500k"])
    return shapes
