"""Faults planted in the timed path, underneath the harness: the check
has to come out false with each one the cell can have.  The CPU tests
plant them at a tiny size; ``bench/control.py --faults`` reads them on
the chip at the cell's own size."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import torch

from benchkit import program  # noqa: F401  (puts the port on the path)


def _patch(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def altered_token():
    """A served token altered where it is produced (the engine's greedy
    pick moved one id on)."""
    from repro_torch.serving import engine
    return [_patch(engine, "_argmax", lambda logits: (
        torch.argmax(logits, dim=-1) + 1) % logits.shape[-1])]


def no_decode_attention():
    """The decode step's attention left out (zeros)."""
    from repro_torch.models import attention
    return [_patch(attention, "_paged_decode",
                   lambda q, *a, **k: torch.zeros_like(q)),
            _patch(attention, "_paged_mla_ctx",
                   lambda a, q_c, *r: torch.zeros_like(q_c))]


def other_experts():
    """The router's picks shifted to the next experts."""
    from repro_torch.kernels import ops
    route = ops.topk_router

    def shifted(logits, k):
        w, i = route(logits, k)
        return w, (i + 1) % logits.shape[-1]
    return [_patch(ops, "topk_router", shifted)]


def unchanged_state():
    """A training step that returns its state unchanged."""
    from repro_torch.training.optimizer import AdamW
    return [_patch(AdamW, "update",
                   lambda self, grads, state, params: (params, state))]


def half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.training import train_step
    whole = train_step.value_and_grad

    def half(loss_fn, params, batch):
        n = next(iter(batch.values())).shape[0] // 2
        return whole(loss_fn, params, {k: v[:n] for k, v in batch.items()})
    return [_patch(train_step, "value_and_grad", half)]


def no_exchange():
    """The sync between the clusters' replicas left out."""
    from repro_torch.training import train_step
    return [_patch(train_step, "hfl_global_round", lambda stacked, w=None:
                   stacked)]


SERVING: Dict[str, Callable] = {"altered_token": altered_token,
                                "no_decode_attention": no_decode_attention}
MOE: Dict[str, Callable] = {"other_experts": other_experts}
TRAINING: Dict[str, Callable] = {"unchanged_state": unchanged_state,
                                 "half_batch": half_batch,
                                 "no_exchange": no_exchange}


@contextlib.contextmanager
def planted(fault: Callable) -> Iterator[None]:
    undo = fault()
    try:
        yield
    finally:
        for u in reversed(undo):
            u()
