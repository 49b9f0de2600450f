"""Shared helpers of the port's transformer: dtype names and a parameter
initialiser with the kinds of ``repro/models/common.py``'s
``ParamBuilder`` (``fan_in``, ``normal`` with a scale, ``ones``,
``zeros``).

Parameters are nested dicts with the JAX tree's keys and shapes.  The
initialiser draws each leaf (or each layer's slice of a stacked leaf)
with a ``torch.Generator``, where the generator lives, and moves it to
the device before drawing the next, so memory peaks at one leaf: for
stablelm-1.6b the fp32 draw of the embedding table (822 MB), not the
6.6 GB of the whole tree.  A CPU generator draws on the host; a CUDA
generator draws on the card, which is how a tree of 15.7 B parameters
(deepseek-v2-lite) is drawn in seconds.
The draws differ from JAX's for the same seed; parity goes through
weights carried over with :func:`repro_torch.params.from_numpy_tree`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def to_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def fan_in(shape: Tuple[int, ...]) -> int:
    """``ParamBuilder``'s fan-in: the leading dim of a vector or matrix,
    the next-to-last dim of a higher-rank weight (``wq (d, H, hd)`` ->
    H; ``wo (H, hd, d)`` -> hd)."""
    if len(shape) > 2:
        return shape[-2]
    return shape[0] if shape else 1


class ParamInit:
    """Builds a nested param dict on ``device``, one leaf at a time."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.params: Dict[str, Any] = {}

    def _draw(self, shape, init: str, scale: float,
              dtype: torch.dtype) -> torch.Tensor:
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype)
        if init == "ones":
            return torch.ones(shape, dtype=dtype)
        std = scale if init == "normal" else \
            scale / np.sqrt(max(fan_in(shape), 1))
        x = torch.randn(shape, generator=self.generator,
                        device=self.generator.device) * std
        return x.to(dtype)

    def param(self, path: str, shape: Tuple[int, ...], init: str = "fan_in",
              scale: float = 1.0, dtype: Optional[torch.dtype] = None,
              stack: int = 0) -> torch.Tensor:
        """Leaf ``path`` ("a/b/c") of ``shape``; with ``stack`` > 0 it
        gains a leading layer axis and each layer is drawn with the
        statistics of ``shape`` alone, as JAX stacks per-layer trees."""
        dtype = dtype or self.dtype
        if stack:
            val = torch.empty((stack,) + tuple(shape), dtype=dtype,
                              device=self.device)
            for i in range(stack):
                val[i] = self._draw(shape, init, scale, dtype).to(self.device)
        else:
            val = self._draw(shape, init, scale, dtype).to(self.device)
        node = self.params
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if leaf in node:
            raise ValueError(f"duplicate param {path}")
        node[leaf] = val
        return val


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a parameter tree whose leaves carry a leading layer
    axis, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]
