"""Optimizers as pure functions over parameter trees, the counterpart of
``repro/training/optimizer.py``, with its semantics.

AdamW keeps its moments in ``state_dtype`` (llama3-405b runs bf16
moments); SGD with optional momentum is the FL clients' optimizer.  Both
leave their inputs untouched and return new trees.

Kept from the reference, number for number:

- the warm-up: ``update`` first increments ``step`` and then schedules
  with ``(step + 1) / warmup_steps``, so the first update runs at
  ``2 / warmup_steps`` of ``lr``;
- the arithmetic: the schedule and the bias corrections
  ``1 - b1 ** step`` are float32 tensors, as in JAX, not Python floats;
  the update is formed in float32 and each parameter cast back to its
  own dtype;
- weight decay is added to the Adam direction before the ``lr``
  multiply (decoupled, AdamW).

No kernel: the reference has none here either."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import to_dtype
from repro_torch.params import flatten_with_path, tree_map, tree_map_multi

Tree = Any


def _step0(params: Tree) -> torch.Tensor:
    """The step counter, int32 on the parameters' device."""
    leaf = flatten_with_path(params)[0][1]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


class AdamWState(NamedTuple):
    step: torch.Tensor               # int32; (C,) when stacked by cluster
    m: Tree
    v: Tree


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_dtype: str = "float32"
    warmup_steps: int = 100

    def _sched(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        return self.lr * warm

    def init(self, params: Tree) -> AdamWState:
        dt = to_dtype(self.state_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        return AdamWState(step=_step0(params), m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        lr = self._sched(step)
        b1, b2 = self.b1, self.b2
        dt = to_dtype(self.state_dtype)
        stepf = step.float()
        c1 = 1 - torch.pow(b1, stepf)
        c2 = 1 - torch.pow(b2, stepf)

        def upd(g, m, v, p):
            g32 = g.float()
            m2 = b1 * m.float() + (1 - b1) * g32
            v2 = b2 * v.float() + (1 - b2) * torch.square(g32)
            delta = (m2 / c1) / (torch.sqrt(v2 / c2) + self.eps)
            p32 = p.float()
            delta = delta + self.weight_decay * p32
            p2 = p32 - lr * delta
            return p2.to(p.dtype), m2.to(dt), v2.to(dt)

        with torch.no_grad():
            new_p, new_m, new_v = tree_map_multi(upd, grads, state.m,
                                                 state.v, params)
        return new_p, AdamWState(step=step, m=new_m, v=new_v)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Optional[Tree]


@dataclass(frozen=True)
class SGD:
    lr: float = 1e-4
    momentum: float = 0.0

    def init(self, params: Tree) -> SGDState:
        mom = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
               if self.momentum else None)
        return SGDState(step=_step0(params), momentum=mom)

    def update(self, grads: Tree, state: SGDState, params: Tree
               ) -> Tuple[Tree, SGDState]:
        with torch.no_grad():
            if self.momentum:
                mom = tree_map_multi(
                    lambda b, g: (self.momentum * b + g.float(),),
                    state.momentum, grads)[0]
                step_dir = mom
            else:
                mom = None
                step_dir = grads
            new_params = tree_map_multi(
                lambda p, d: ((p.float() - self.lr * d.float()
                               ).to(p.dtype),), params, step_dir)[0]
        return new_params, SGDState(step=state.step + 1, momentum=mom)
