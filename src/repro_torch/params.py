"""Parameter trees: nested dicts of tensors with the JAX tree's keys and
shapes (``gru/{i}/w_x``, ``head/w``, ...), and the weight carry-over
between the two packages.

The JAX and PyTorch random streams differ, so every parity check draws
its weights once (with numpy, or with the JAX package) and carries them
over with :func:`from_numpy_tree`; :func:`to_numpy_tree` goes back."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Any
Path = Tuple[Any, ...]


def flatten_with_path(tree: Tree) -> List[Tuple[Path, Any]]:
    """Leaves in JAX's order: dict keys sorted, lists and tuples by
    index.  Each leaf comes with the tuple of keys that reaches it."""
    if isinstance(tree, dict):
        return [((k,) + p, leaf) for k in sorted(tree)
                for p, leaf in flatten_with_path(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [((i,) + p, leaf) for i, sub in enumerate(tree)
                for p, leaf in flatten_with_path(sub)]
    return [((), tree)]


def tree_map_with_path(fn: Callable[[Path, Any], Any], tree: Tree,
                       prefix: Path = ()) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    return tree_map_with_path(lambda _, x: fn(x), tree)


def unflatten(paths: List[Path], leaves: List[Any]) -> Dict[Any, Any]:
    """Inverse of :func:`flatten_with_path` for trees of nested dicts."""
    out: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def from_numpy_tree(tree: Tree, device: DeviceLike = None) -> Tree:
    """Arrays (numpy, or anything ``np.asarray`` takes) -> tensors on
    ``device``, same keys, shapes and dtypes.  Leaves that already are
    tensors are moved to ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev) if torch.is_tensor(x)
                    else torch.from_numpy(np.array(x)).to(dev), tree)


def to_numpy_tree(tree: Tree) -> Tree:
    """Tensors -> numpy arrays on the host, same keys and shapes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
