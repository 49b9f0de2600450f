"""The plain reference of hierarchical FL training of a decoder-only
model: per cluster, the mean next-token cross entropy over its batch,
its gradients by autograd through :mod:`reference.transformer` (float32,
TF32 off, each layer recomputed in the backward), AdamW, and every
``global_every`` rounds the clusters' parameters averaged (FedAvg with
equal weights).

What the configuration states is kept: parameters are stored in bf16
(each update rounds them, as the served type), AdamW's moments in
float32; AdamW is the decoupled form with the warm-up ``lr *
min((t + 1) / warmup_steps, 1)`` at step t (counted from 1), bias
corrections, and the weight decay added to the Adam direction before the
``lr`` multiply.  The loss's log-sum-exp runs over every row of the head
(the padded vocabulary).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from reference import transformer as ref


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def loss_and_grads(stored: Dict[str, torch.Tensor], cfg: Dict[str, Any],
                   tokens: torch.Tensor, precision: str = "fp32"):
    """Mean cross entropy of ``tokens`` (B, S + 1) (inputs the first S,
    labels the last S of each row) and its float32 gradients, leaf by
    leaf; one row's backward at a time."""
    p32 = {k: v.detach().to(torch.float32, copy=True).requires_grad_()
           for k, v in stored.items()}
    params = _tree(p32)
    B, S1 = tokens.shape
    n = B * (S1 - 1)
    total = 0.0
    with ref.exact_float32(), torch.enable_grad():
        for b in range(B):
            h = ref.hidden(params, cfg, tokens[b, :-1], precision, remat=True)
            logits = ref.head(params, h, precision)
            nll = torch.logsumexp(logits, -1) - logits.gather(
                1, tokens[b, 1:, None].long())[:, 0]
            part = nll.sum() / n
            part.backward()
            total += float(part.detach())
            del h, logits, nll, part
    grads = {k: v.grad for k, v in p32.items()}
    return total, grads


class AdamW:
    """Reference AdamW over a flat dict of bf16-stored parameters."""

    def __init__(self, hyper: Dict[str, float], stored):
        self.h = hyper
        self.t = 0
        self.m = {k: torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device) for k, v in stored.items()}
        self.v = {k: torch.zeros_like(m) for k, m in self.m.items()}

    def step(self, stored, grads) -> None:
        h = self.h
        self.t += 1
        t = self.t
        lr = h["lr"] * min((t + 1) / h["warmup_steps"], 1.0)
        c1, c2 = 1 - h["b1"] ** t, 1 - h["b2"] ** t
        with torch.no_grad():
            for k, g in grads.items():
                m, v = self.m[k], self.v[k]
                m.mul_(h["b1"]).add_(g, alpha=1 - h["b1"])
                v.mul_(h["b2"]).addcmul_(g, g, value=1 - h["b2"])
                p = stored[k].float()
                d = (m / c1) / (torch.sqrt(v / c2) + h["eps"]) \
                    + h["weight_decay"] * p
                stored[k].copy_((p - lr * d).to(stored[k].dtype))


def fedavg(clusters: Sequence[Dict[str, torch.Tensor]]) -> None:
    """Every cluster's parameters replaced by their float32 mean."""
    with torch.no_grad():
        for k in clusters[0]:
            mean = torch.stack([c[k].float() for c in clusters]).mean(0)
            for c in clusters:
                c[k].copy_(mean.to(c[k].dtype))


def run(params: Dict[str, Any], cfg: Dict[str, Any],
        batches: List[torch.Tensor], hyper: Dict[str, float],
        global_every: int, precision: str = "fp32") -> Dict[str, Any]:
    """Rounds over ``batches`` (one (C, B, S + 1) tensor a round) from
    ``params``: every cluster's losses a round, its first gradient, and
    its parameters after the last round (flat dicts)."""
    init = _flat(params)
    C = batches[0].shape[0]
    stored = [{k: v.detach().clone() for k, v in init.items()}
              for _ in range(C)]
    opts = [AdamW(hyper, s) for s in stored]
    losses, first_grads = [], []
    for r, batch in enumerate(batches, start=1):
        row = []
        for c in range(C):
            loss, grads = loss_and_grads(stored[c], cfg, batch[c], precision)
            if r == 1:
                first_grads.append({k: g.norm().item()
                                    for k, g in grads.items()})
            opts[c].step(stored[c], grads)
            row.append(loss)
            del grads
        losses.append(row)
        if r % global_every == 0:
            fedavg(stored)
    del opts
    return {"losses": losses, "grad_norms": first_grads, "params": stored}
