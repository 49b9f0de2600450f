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

Every leaf also records its *logical axes* (``("embed", "heads",
"head_dim")``) in a parallel ``axes`` tree, as ``ParamBuilder`` does;
``stack`` prepends ``"layers"`` (``stack_axes``).  The launch layer maps
logical axes to mesh axes (``repro_torch/launch/shardings.py``) through
:func:`placements_for`, the counterpart of ``named_sharding_for``: a
DTensor placement per mesh dim instead of a ``PartitionSpec``.

:func:`shard` is the counterpart of the reference's activation
constraint: outside :func:`logical_sharding` (and on a plain tensor) it
returns its argument, so every unsharded path is untouched; inside it, a
DTensor is redistributed to the rule's placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.utils.checkpoint import checkpoint

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def to_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Logical-axis sharding context
# ---------------------------------------------------------------------------

Logical = Sequence[Optional[str]]
Rules = Mapping[str, Tuple[str, ...]]

_CTX = threading.local()


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a plain mapping (the
    launch layer sizes shardings without building the mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def logical_sharding(mesh, rules: Rules):
    """Within this context :func:`shard` redistributes DTensors by
    ``rules`` (logical axis -> mesh axes) over ``mesh``."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, rules)
    try:
        yield
    finally:
        _CTX.state = prev


def mesh_axes_for(mesh: Any, rules: Rules, logical: Logical,
                  shape: Optional[Sequence[int]] = None) -> list:
    """The reference's ``_mesh_axes_for``: per tensor dim, the mesh axes
    it is split over (a name, a tuple of names, or None).  A mesh axis
    serves one dim at most; where the dim's size is no multiple of the
    axes' product, progressively shorter prefixes are tried, and none
    fits means replicated."""
    sizes = mesh_shape(mesh)
    out, used = [], set()
    for i, ax in enumerate(logical):
        if ax is None:
            out.append(None)
            continue
        cand = tuple(a for a in rules.get(ax, ())
                     if a in sizes and a not in used)
        if cand and shape is not None and shape[i] % int(
                np.prod([sizes[a] for a in cand])):
            ok = ()
            for k in range(len(cand), 0, -1):
                if shape[i] % int(np.prod([sizes[a] for a in cand[:k]])) == 0:
                    ok = cand[:k]
                    break
            cand = ok
        if not cand:
            out.append(None)
        else:
            used.update(cand)
            out.append(cand if len(cand) > 1 else cand[0])
    return out


def axes_to_placements(mesh: Any, axes: Sequence[Any]
                       ) -> Tuple[Placement, ...]:
    """One placement per mesh dim for per-tensor-dim mesh axes (as
    :func:`mesh_axes_for` gives them).  DTensor splits a tensor dim over
    several mesh dims in mesh-dim order, the first the outermost, which
    is the order of a ``PartitionSpec`` tuple only when the tuple lists
    its axes in mesh-dim order: any other order raises."""
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, a in enumerate(axes):
        if a is None:
            continue
        group = (a,) if isinstance(a, str) else tuple(a)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(
                f"mesh axes {group} of tensor dim {dim} are not in the "
                f"mesh's order {tuple(names)}: DTensor would split the dim "
                "in another order than the reference's PartitionSpec")
        for j in idx:
            out[j] = Shard(dim)
    return tuple(out)


def placements_for(mesh: Any, rules: Rules, logical: Logical,
                   shape: Sequence[int]) -> Tuple[Placement, ...]:
    """DTensor placements for a tensor of ``shape`` with ``logical`` axes:
    the counterpart of ``named_sharding_for``."""
    return axes_to_placements(
        mesh, mesh_axes_for(mesh, rules, logical, tuple(shape)))


class _Constrain(torch.autograd.Function):
    """A layout constraint on a DTensor and on its gradient, as JAX
    transposes ``with_sharding_constraint`` to the same constraint on the
    cotangent (DTensor's own ``redistribute`` would hand the gradient
    back in whatever layout the backward made it)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.layout = (mesh, placements)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.layout
        return grad.redistribute(mesh, placements), None, None


def shard(x: torch.Tensor, *logical: Optional[str],
          sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Redistribute the DTensor ``x`` (and, in the backward, its
    gradient) to the placements its ``logical`` axes get under the
    enclosing :func:`logical_sharding`; a no-op outside it and for plain
    tensors.  ``sizes`` stands for ``x.shape`` in the divisibility
    fallback: a flattened (..., h * k) dim split only where h divides."""
    state = getattr(_CTX, "state", None)
    if state is None or not isinstance(x, DTensor):
        return x
    mesh, rules = state
    return _Constrain.apply(x, mesh, placements_for(
        mesh, rules, logical, x.shape if sizes is None else sizes))


def fan_in(shape: Tuple[int, ...]) -> int:
    """``ParamBuilder``'s fan-in: the leading dim of a vector or matrix,
    the next-to-last dim of a higher-rank weight (``wq (d, H, hd)`` ->
    H; ``wo (H, hd, d)`` -> hd)."""
    if len(shape) > 2:
        return shape[-2]
    return shape[0] if shape else 1


def _insert(tree: Dict[str, Any], path: str, value: Any) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    if leaf in tree:
        raise ValueError(f"duplicate param {path}")
    tree[leaf] = value


class ParamInit:
    """Builds a nested param dict on ``device``, one leaf at a time, and
    the parallel tree of logical axes (``self.axes``)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.params: Dict[str, Any] = {}
        self.axes: Dict[str, Any] = {}

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

    def param(self, path: str, shape: Tuple[int, ...], axes: Logical,
              init: str = "fan_in", scale: float = 1.0,
              dtype: Optional[torch.dtype] = None,
              stack: int = 0) -> torch.Tensor:
        """Leaf ``path`` ("a/b/c") of ``shape`` with logical ``axes``;
        with ``stack`` > 0 it gains a leading layer axis (logical
        ``"layers"``) and each layer is drawn with the statistics of
        ``shape`` alone, as JAX stacks per-layer trees."""
        if len(shape) != len(axes):
            raise ValueError(f"{path}: shape {shape} has {len(shape)} dims, "
                             f"axes {tuple(axes)} {len(axes)}")
        dtype = dtype or self.dtype
        if stack:
            val = torch.empty((stack,) + tuple(shape), dtype=dtype,
                              device=self.device)
            for i in range(stack):
                val[i] = self._draw(shape, init, scale, dtype).to(self.device)
        else:
            val = self._draw(shape, init, scale, dtype).to(self.device)
        _insert(self.params, path, val)
        _insert(self.axes, path,
                (("layers",) if stack else ()) + tuple(axes))
        return val

    def build(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return self.params, self.axes


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a parameter tree whose leaves carry a leading layer
    axis, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def checkpointed(remat: str, fn: Callable, *args):
    """``fn(*args)``, one layer, under activation checkpointing when
    ``remat`` is not ``"none"`` (``"layer"`` and ``"dots"`` alike, as in
    the reference, whose scanned layer bodies are ``jax.checkpoint``-ed
    whenever ``remat != "none"``) and grad mode is on: the forward keeps
    only the layer's inputs, and the backward runs the layer again.  So a
    recomputed layer launches its kernels' forwards a second time (their
    backward is the plain version's, ``kernels/_grad.py``).  Without grad
    (serving, scoring) ``fn`` is called directly.  Callers slice a layer
    of a stacked tree inside ``fn``, so the recomputation re-slices and
    no view of the stack is held between the passes."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    # The recomputation runs in autograd's thread for the device, which
    # does not see this thread's sharding context (thread-local) or
    # DTensor's implicit replication: the layer takes both along.
    state = getattr(_CTX, "state", None)
    replicate = DTensor._op_dispatcher._allow_implicit_replication

    def layer(*layer_args):
        with _forward_context(state, replicate):
            return fn(*layer_args)

    # No layer draws randomness: the reference's checkpointed bodies
    # (repro/models/transformer.py:180-187, hybrid.py:88-92,
    # xlstm.py:346-349, encdec.py:67-76 and :104-107) have no dropout.
    return checkpoint(layer, *args, use_reentrant=False,
                      preserve_rng_state=False)


@contextlib.contextmanager
def _forward_context(state, replicate: bool):
    """:func:`logical_sharding`'s state and DTensor's implicit replication
    as they were when a checkpointed layer first ran; the previous ones
    after."""
    dispatcher = DTensor._op_dispatcher
    prev = (getattr(_CTX, "state", None),
            dispatcher._allow_implicit_replication)
    _CTX.state = state
    dispatcher._allow_implicit_replication = replicate
    try:
        yield
    finally:
        _CTX.state, dispatcher._allow_implicit_replication = prev


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def count_params(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def param_bytes(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in _leaves(tree))
