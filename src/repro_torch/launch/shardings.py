"""Logical-axis -> mesh-axis sharding rules (MaxText-style), the
counterpart of ``repro/launch/shardings.py``, with its divisibility
fallback: a dim whose size no prefix of its mesh axes divides stays
replicated (gemma3's 4 heads and one kv head, qwen's 60 experts).

The rules are the reference's, copied verbatim.  Where the reference
returns ``NamedSharding`` trees, these functions return DTensor
placement tuples, one placement per mesh dim
(``models/common.py``'s :func:`placements_for`), and
:func:`distribute_tree` lays a tree out on a ``DeviceMesh``.  A mesh
here is a ``DeviceMesh`` or a plain mapping of axis name to size (the
shardings are worked out without building it).  Where a rule puts
several mesh axes on one tensor dim, DTensor splits the dim in mesh-dim
order; :func:`placements_for` raises for a tuple in any other order.

Caches are the port's (``models/attention.py`` and the recurrent
families): the same fields as the reference's, except that a ring's
``index`` is one slot a batch row, (B,), where the reference keeps a
scalar; it stays replicated, as the reference's scalar does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate,
                                      distribute_tensor)

from repro_torch.models.common import mesh_shape, placements_for

PyTree = Any
Placements = Tuple[Placement, ...]

# weight + activation rules (logical axis -> preferred mesh axes)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # weights
    "embed": ("data",),             # FSDP
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "expert": (),                   # experts replicated; d_ff sharded
    "kv_lora": ("model",),
    "layers": (),
    # activations
    "batch": ("pod", "cluster", "data"),
    "seq": (),
    "embed_act": ("model",),
    "mlp_act": ("model",),
    "heads_act": ("model",),
    "kv_heads_act": ("model",),
    "vocab_act": ("model",),
    # caches
    "kv_seq": ("data", "model"),
    "cluster": ("pod", "cluster"),
}

EXPERT_PARALLEL_RULES = dict(DEFAULT_RULES, expert=("model",), mlp=(),
                             mlp_act=())


def rules_for(cfg, mesh, overrides=()) -> Dict[str, Tuple[str, ...]]:
    rules = dict(DEFAULT_RULES)
    for k, v in overrides or ():
        rules[k] = tuple(v)
    return rules


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def params_shardings(axes_tree: PyTree, shapes_tree: PyTree, mesh,
                     rules) -> PyTree:
    """Placement tree for parameters given their logical-axes tree (the
    shapes tree holds tensors, fake or real, or anything with a
    ``shape``)."""
    if _is_axes(axes_tree):
        return placements_for(mesh, rules, axes_tree, shapes_tree.shape)
    return {k: params_shardings(axes_tree[k], shapes_tree[k], mesh, rules)
            for k in axes_tree}


def batch_shardings(batch_specs: Dict[str, Any], mesh, rules,
                    cluster_dim: bool = False) -> Dict[str, Placements]:
    """tokens/labels (B,S): batch over data axes.  patches/frames
    (B,P,d): hidden over model.  HFL mode adds a leading cluster dim."""
    out = {}
    lead = ("cluster",) if cluster_dim else ()
    for k, v in batch_specs.items():
        if v.ndim - len(lead) == 2 and k in ("tokens", "labels"):
            logical = lead + ("batch", "seq")
        elif k in ("patches", "frames"):
            logical = lead + ("batch", "seq", "embed_act")
        elif k == "windows":
            logical = lead + ("batch", "seq", None)
        elif k == "targets":
            logical = lead + ("batch", None)
        else:
            logical = (None,) * v.ndim
        out[k] = placements_for(mesh, rules, logical, v.shape)
    return out


# ---------------------------------------------------------------------------
# cache shardings (decode dry-run inputs)
# ---------------------------------------------------------------------------

def _cache_leaf_sharding(name, leaf, mesh, rules) -> Placements:
    if name in ("k", "v"):           # KVCache (B,C,H,D)
        logical = ("batch", "kv_seq", "kv_heads_act", None)
    elif name == "c_kv":             # MLA latents (B,C,R)
        logical = ("batch", "kv_seq", "mlp_act")
    elif name == "k_rope":
        logical = ("batch", "kv_seq", None)
    elif name == "pos":
        logical = ("batch", "kv_seq")
    elif name == "conv":             # SSM conv buffer (B,W-1,ch)
        logical = ("batch", None, "mlp_act")
    elif name == "s":                # SSD state (B,H,N,P)
        logical = ("batch", "heads_act", None, None)
    elif name == "C":                # mLSTM matrix memory (B,H,hd,hd)
        logical = ("batch", "heads_act", None, None)
    elif name in ("n", "h", "c", "m"):
        logical = ("batch", "heads_act") + (None,) * (leaf.ndim - 2)
    elif name in ("cross_k", "cross_v"):   # (L,B,F,H,D)
        logical = (None, "batch", None, "kv_heads_act", None)
    elif name == "index":
        logical = ()
    else:
        logical = (None,) * leaf.ndim
    # stacked caches carry a leading layer dim: shift logical axes
    if leaf.ndim > len(logical):
        logical = (None,) * (leaf.ndim - len(logical)) + logical
    logical = logical[:leaf.ndim]
    return placements_for(mesh, rules, logical, leaf.shape)


def _map_fields(fn, tree: PyTree, field=None) -> PyTree:
    """``fn(field, leaf)`` over a cache tree, ``field`` the name of the
    nearest NamedTuple field or dict key above the leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_fields(fn, v, f)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map_fields(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_fields(fn, v, field) for v in tree)
    return fn(field, tree)


def cache_shardings(cache_tree: PyTree, mesh, rules) -> PyTree:
    return _map_fields(
        lambda name, leaf: _cache_leaf_sharding(name, leaf, mesh, rules),
        cache_tree)


def replicated(mesh) -> Placements:
    return (Replicate(),) * len(mesh_shape(mesh))


def scalar_shardings(tree: PyTree, mesh) -> PyTree:
    return _map_fields(lambda _, __: replicated(mesh), tree)


# ---------------------------------------------------------------------------
# laying trees out on a DeviceMesh
# ---------------------------------------------------------------------------

def _is_placements(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(p, Placement) for p in x)


def distribute_tree(tree: PyTree, mesh, placements: PyTree) -> PyTree:
    """Every tensor of ``tree`` as a DTensor on the ``DeviceMesh`` with the
    placements of the matching leaf of ``placements`` (a tree of the same
    structure, or one placement tuple for every leaf).  Each rank keeps
    its own chunk of the tensor it holds: nothing is sent
    (``src_data_rank=None``), so every rank must hold the same global
    tensor, as a seeded draw or a fake tensor gives it."""
    def one(x, pl):
        if x is None or isinstance(x, DTensor):
            return x
        return distribute_tensor(x, mesh, list(pl), src_data_rank=None)

    def walk(t, pl):
        if _is_placements(pl):
            return _map_fields(lambda _, x: one(x, pl), t)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(a, b) for a, b in zip(t, pl)))
        if isinstance(t, dict):
            return {k: walk(v, pl[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(a, b) for a, b in zip(t, pl))
        return one(t, pl)

    return walk(tree, placements)


def local_bytes(tree: PyTree) -> int:
    """Bytes this rank holds of a tree of DTensors (plain tensors count
    whole)."""
    total = 0

    def add(_, x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()
        return x

    _map_fields(add, tree)
    return total

