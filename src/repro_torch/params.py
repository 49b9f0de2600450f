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
        leaves = [tree_map_with_path(fn, v, prefix + (i,))
                  for i, v in enumerate(tree)]
        # a NamedTuple (the caches) takes its fields positionally
        return type(tree)(*leaves) if hasattr(tree, "_fields") \
            else type(tree)(leaves)
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    return tree_map_with_path(lambda _, x: fn(x), tree)


def tree_map_multi(fn: Callable[..., Tuple[Any, ...]], *trees: Tree
                   ) -> Tuple[Tree, ...]:
    """``fn`` leaf by leaf over nested-dict trees of one structure; ``fn``
    returns a tuple, and the result is one tree per element of it."""
    flat = [flatten_with_path(t) for t in trees]
    paths = [p for p, _ in flat[0]]
    outs = [fn(*(f[i][1] for f in flat)) for i in range(len(paths))]
    return tuple(unflatten(paths, list(col)) for col in zip(*outs))


def unflatten(paths: List[Path], leaves: List[Any]) -> Dict[Any, Any]:
    """Inverse of :func:`flatten_with_path` for trees of nested dicts."""
    out: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _is_bfloat16(arr: np.ndarray) -> bool:
    """numpy has no bfloat16: JAX hands one over as ``ml_dtypes.bfloat16``
    and ``np.savez`` stores it as raw 2-byte ``|V2``."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def array_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor of the same dtype; a bfloat16 array (either
    form of :func:`_is_bfloat16`) is carried over bit for bit through its
    bytes viewed as uint16."""
    if _is_bfloat16(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_numpy_tree(tree: Tree, device: DeviceLike = None) -> Tree:
    """Arrays (numpy, or anything ``np.asarray`` takes) -> tensors on
    ``device``, same keys, shapes and dtypes, bfloat16 included.  Leaves
    that already are tensors are moved to ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev) if torch.is_tensor(x)
                    else array_to_tensor(np.array(x)).to(dev), tree)


def to_numpy_tree(tree: Tree) -> Tree:
    """Tensors -> numpy arrays on the host, same keys and shapes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
