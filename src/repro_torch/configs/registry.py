"""Registry of the configurations the port can run so far.

The paper's own GRU and the dense transformer the LM tiers serve by
default are ported; every other architecture of
``repro/configs/registry.py`` waits for its slice (ROADMAP.md)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gru-traffic": "repro_torch.configs.gru_traffic",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1p6b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to PyTorch yet (known: "
            f"{sorted(_MODULES)}); see ROADMAP.md for the order of slices")
    return importlib.import_module(_MODULES[name]).CONFIG
