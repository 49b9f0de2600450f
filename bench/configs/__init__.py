"""Each configuration's architecture, found by its ``model_type``.

``configs/<model_type>.py`` holds all that the harness knows of one
architecture, and nothing else does:

- ``RUNS_AS``: published keys and the value the module runs them at.  A
  configuration file whose value differs has to name the key under
  ``departures`` (why the run departs from the published model); else
  :func:`arch` refuses it.
- ``leaves(cfg)``: every weight leaf as ``benchkit/weights.py`` draws it.
- ``hidden(params, cfg, tokens, pr, remat)``: the plain reference's
  forward pass, from the blocks of ``reference/transformer.py``.
- ``matmul_params(cfg)`` and ``attention(cfg)``: what the model FLOPs
  and the attention kernels' rooflines count (``roofline/``).
- ``port_model(cfg, port, common)``: the port's ``ModelConfig``, built
  from the port's configuration classes, which ``benchkit/program.py``
  hands in (the module imports nothing of the port).

A configuration of a new architecture adds its module; no other file
changes.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def arch(cfg: Dict[str, Any]) -> ModuleType:
    """The module of ``cfg``'s ``model_type``, once ``cfg`` is checked
    against its ``RUNS_AS``."""
    kind = cfg["model_type"]
    try:
        module = importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{kind}":
            raise
        raise ValueError(f"{cfg.get('name')}: no module configs/{kind}.py "
                         f"for model_type {kind!r}") from None
    departures = cfg.get("departures", {})
    for key, value in module.RUNS_AS.items():
        if cfg.get(key, value) != value and key not in departures:
            raise ValueError(
                f"{cfg.get('name')}: {key} is {cfg[key]!r}; configs/{kind}.py "
                f"runs {value!r}: name the key under departures")
    return module
