"""Checkpointing in the JAX package's flat-key npz format.

A key is the path to a leaf with each step written as JAX's ``keystr``
writes it (``['gru']`` for a dict key, ``[0]`` for a list index), joined
by ``::``: ``['gru']::['0']::['w_x']``.  Files written here load with
``repro.checkpoint.io.load_pytree`` and the other way round."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.params import (array_to_tensor, flatten_with_path,
                                tree_map_with_path)

Tree = Any
_SEP = "::"


def _key(path) -> str:
    return _SEP.join(f"[{k!r}]" for k in path)


def save_pytree(path: str, tree: Tree) -> None:
    """bfloat16 leaves are written as float32 (npz has no bfloat16);
    :func:`load_pytree` casts them back to the dtype of ``like``."""
    flat = {}
    for p, leaf in flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[_key(p)] = t.numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each tensor keeps the
    shape, dtype and device of its counterpart in ``like``.  A bfloat16
    leaf written by the JAX package (raw ``|V2`` in the npz) loads bit
    for bit."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    want = {_key(p) for p, _ in flatten_with_path(like)}
    if set(stored) != want:
        raise ValueError(f"checkpoint mismatch: missing={want - set(stored)} "
                         f"extra={set(stored) - want}")

    def restore(p, leaf):
        arr = stored[_key(p)]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape {arr.shape} != "
                             f"{tuple(leaf.shape)} at {_key(p)}")
        return array_to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_path(restore, like)
