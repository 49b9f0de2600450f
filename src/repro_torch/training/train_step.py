"""Train-step assembly over the unified model API, the counterpart of
``repro/training/train_step.py``: loss and gradients
(``torch.autograd.grad`` of ``api.loss``), microbatched accumulation,
and the optimizer update.

``make_hfl_train_step`` is the hierarchical-FL step: parameters and
optimizer state carry a leading *cluster* axis and every cluster takes
its own step, with no cross-cluster reduction; ``hfl_global_round``
(:func:`repro_torch.fl.collectives.global_sync`) is the separate sync run
every ``l`` rounds.  Where the reference vmaps the step over clusters,
the port loops over them (its kernels are ctypes launches behind
``autograd.Function``) and writes each cluster's result back into the
stacked tensors in place, so the stack is never built twice."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.fl.collectives import cluster_slice, global_sync
from repro_torch.models import ModelApi
from repro_torch.params import (flatten_with_path, tree_map, tree_map_multi,
                                unflatten)

Tree = Any


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    """The reference's ``reshape((k, B // k) + ...)``: slice ``i`` holds
    rows ``i * B // k`` to ``(i + 1) * B // k``."""
    mbs = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
           for key, v in batch.items()}
    return [{key: v[i] for key, v in mbs.items()} for i in range(k)]


def value_and_grad(loss_fn: Callable, params: Tree, batch
                   ) -> Tuple[torch.Tensor, Tree]:
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss (detached)
    and its gradients, a tree like ``params`` in the parameters' dtypes."""
    flat = flatten_with_path(params)
    paths = [p for p, _ in flat]
    leaves = [x.detach().requires_grad_() for _, x in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(paths, leaves), batch)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(paths, list(grads))


def make_train_step(api: ModelApi, cfg: ArchConfig, optimizer) -> Callable:
    """(params, opt_state, batch) -> (new params, new opt_state, loss);
    the inputs are left as they were."""
    k = cfg.run.microbatches

    def train_step(params: Tree, opt_state, batch: Dict[str, torch.Tensor]):
        if k <= 1:
            loss, grads = value_and_grad(api.loss, params, batch)
        else:
            # the reference sums in the parameters' dtype: its carry
            # starts from zeros_like(params)
            gsum, lsum = None, 0.0
            for mb in _split_microbatches(batch, k):
                l, g = value_and_grad(api.loss, params, mb)
                gsum = g if gsum is None else tree_map_multi(
                    lambda a, b: (a + b,), gsum, g)[0]
                lsum = lsum + l
            grads = tree_map(lambda g: g / k, gsum)
            loss = lsum / k
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return train_step


def make_eval_step(api: ModelApi) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return api.loss(params, batch)
    return eval_step


# ---------------------------------------------------------------------------
# hierarchical-FL train step (cluster-replicated params)
# ---------------------------------------------------------------------------

def init_hfl_opt_state(optimizer, stacked_params: Tree):
    """``jax.vmap(optimizer.init)(stacked_params)``: the state of every
    cluster, stacked, its ``step`` a (C,) vector."""
    C = flatten_with_path(stacked_params)[0][1].shape[0]
    state = optimizer.init(stacked_params)
    return state._replace(step=state.step.expand(C).clone())


def _copy_into(dst: Tree, src: Tree) -> None:
    if dst is None:
        return
    if isinstance(dst, tuple) and hasattr(dst, "_fields"):
        for d, s in zip(dst, src):
            _copy_into(d, s)
        return
    for (_, d), (_, s) in zip(flatten_with_path(dst), flatten_with_path(src)):
        d.copy_(s)


def make_hfl_train_step(api: ModelApi, cfg: ArchConfig, optimizer
                        ) -> Callable:
    """params / opt_state carry a leading cluster dim; the batch carries a
    matching one.  Each cluster steps on its own replica (no
    cross-cluster reduction), and its new parameters and state are
    written back into the stacked tensors, which the step returns with
    the (C,) losses."""
    base = make_train_step(api, cfg, optimizer)

    def hfl_local_step(stacked_params, stacked_opt, stacked_batch):
        C = flatten_with_path(stacked_params)[0][1].shape[0]
        losses = []
        for c in range(C):
            params = cluster_slice(stacked_params, c)
            opt = cluster_slice(stacked_opt, c)
            new_params, new_opt, loss = base(
                params, opt, {k: v[c] for k, v in stacked_batch.items()})
            with torch.no_grad():
                _copy_into(params, new_params)
                _copy_into(opt, new_opt)
            del new_params, new_opt
            losses.append(loss)
        return stacked_params, stacked_opt, torch.stack(losses)

    return hfl_local_step


def hfl_global_round(stacked_params: Tree, weights=None) -> Tree:
    """The every-l-rounds parameter sync."""
    return global_sync(stacked_params, weights)
