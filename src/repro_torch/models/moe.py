"""Mixture-of-Experts layer (shared + routed experts, top-k routing with
per-expert capacity), the counterpart of ``repro/models/moe.py``.

The JAX module sorts the token-to-expert assignments by expert and scans
over the experts, each taking a fixed-capacity slice.  The port keeps
that dispatch's semantics exactly (router logits in fp32, a stable sort
by expert, an expert keeping the first ``min(count, C)`` of its sorted
assignments and dropping the rest, capacity ``C`` from
:func:`_capacity`) but runs all experts at once: the kept tokens are
gathered into one ``(E, slots, d)`` block, zero rows where a slot is
empty, each projection is one batched product over the experts, and the
outputs are gathered back per assignment and summed over the k choices.
Every step is a gather or a collision-free write, with no atomic float
adds, so results are deterministic on the card.

The routing itself goes through ``ops.topk_router``: the CUDA kernel for
tensors on the card, its plain version on the CPU (which picks as the
TPU kernel does, so it agrees with the JAX module's ``lax.top_k``
wherever no two probabilities tie).

``groups`` splits the tokens into groups with a capacity each, as
separate calls would: the dense engine's decode step passes one group
per row, because the JAX engine vmaps its decode over slots and every
slot's layer sees one token.  Routing is still one kernel launch over
all the tokens.

On DTensors the routed experts run on each rank's tokens through
``models/sharded.py``, whether the experts are whole or split over the
mesh: capacity and aux loss are then per rank's tokens, a named
deviation (the reference's one program takes them over the global
batch); the shared experts are DTensor ops.  Where the experts are
split over the mesh (the expert-parallel rules), :func:`_routed` hands
its dispatch block to ``sharded.moe``'s placement, which runs this
rank's experts' blocks (from every rank that shares a token axis with
them, through an all-to-all) and returns the block's outputs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models import sharded
from repro_torch.models.common import ParamInit, shard
from repro_torch.models.layers import apply_mlp, init_mlp


def init_moe(pi: ParamInit, path: str, d_model: int, moe: MoEConfig,
             act: str, stack: int = 0) -> None:
    E = moe.num_experts
    pi.param(f"{path}/router", (d_model, E), ("embed", None),
             dtype=torch.float32, stack=stack)
    if act == "silu":
        pi.param(f"{path}/wi_gate", (E, d_model, moe.d_expert),
                 ("expert", "embed", "mlp"), stack=stack)
        pi.param(f"{path}/wi_up", (E, d_model, moe.d_expert),
                 ("expert", "embed", "mlp"), stack=stack)
    else:
        pi.param(f"{path}/wi", (E, d_model, moe.d_expert),
                 ("expert", "embed", "mlp"), stack=stack)
    pi.param(f"{path}/wo", (E, moe.d_expert, d_model),
             ("expert", "mlp", "embed"), stack=stack)
    shared = moe.d_shared if moe.d_shared else moe.num_shared * moe.d_expert
    if shared:
        init_mlp(pi, f"{path}/shared", d_model, shared, act, stack=stack)


def _capacity(num_tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(num_tokens * moe.top_k / moe.num_experts
                  * moe.capacity_factor)
    c = max(8, -(-c // 8) * 8)  # round up to 8
    return min(c, num_tokens * moe.top_k)  # never above total assignments


def _dispatch(topi: torch.Tensor, groups: int, E: int, C: int, width: int
              ) -> torch.Tensor:
    """Block slot of every assignment (row-major over (t, K)), or the
    trash slot ``E * groups * width`` for a dropped one.  Assignments are
    ranked within their (group, expert) by a stable sort, so an expert
    keeps its group's first ``C`` assignments in token order, as the JAX
    scan keeps the first ``C`` of its sorted slice."""
    t, K = topi.shape
    dev = topi.device
    group = torch.arange(t, device=dev) // (t // groups)
    key = (group[:, None] * E + topi.long()).reshape(-1)       # (t*K,)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    starts = torch.searchsorted(sorted_key,
                                torch.arange(groups * E, device=dev))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * K, device=dev) - starts[sorted_key]
    expert, grp = key % E, key // E
    slot = (expert * groups + grp) * width + rank
    return torch.where(rank < C, slot,
                       torch.full_like(slot, E * groups * width))


def _experts(p: Dict[str, Any], xs: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's MLP on its block of rows: xs (E, slots, d)."""
    if "wi_gate" in p:
        g = torch.bmm(xs, p["wi_gate"])
        u = torch.bmm(xs, p["wi_up"])
        h = F.silu(g.float()).to(xs.dtype) * u
    else:
        h = torch.bmm(xs, p["wi"])
        h = F.gelu(h.float(), approximate="tanh").to(xs.dtype)
    return torch.bmm(h, p["wo"])


def aux_loss(probs: torch.Tensor, topi: torch.Tensor,
             moe: MoEConfig) -> torch.Tensor:
    """The Switch load-balance loss of the JAX module: E * sum_e f_e * P_e
    * coef, f the share of assignments and P the mean probability of
    expert e, from the full fp32 softmax ``probs`` (t, E)."""
    E = moe.num_experts
    t, K = topi.shape
    f = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    f = f.index_add(0, topi.reshape(-1).long(),
                    torch.ones((t * K,), device=probs.device)) / (t * K)
    return E * torch.sum(f * probs.mean(dim=0)) * moe.aux_loss_coef


def apply_moe(p: Dict[str, Any], moe: MoEConfig, x: torch.Tensor, act: str,
              groups: int = 1, with_aux: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux loss scalar).  ``groups`` divides
    the B*S tokens (in row-major order) into groups of equal size that
    each get their own capacity.  The aux loss needs the full softmax,
    which the router kernel does not return: it is computed only with
    ``with_aux`` (training's forward), else it is 0."""
    if sharded.is_dtensor(x):
        out, aux = sharded.moe(
            lambda xl, ps, place: _routed(ps, moe, xl, act, groups,
                                          with_aux, place),
            x, {k: v for k, v in p.items() if k != "shared"})
    else:
        out, aux = _routed(p, moe, x, act, groups, with_aux)
    out = shard(out, "batch", "seq", "embed_act")
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act)
    return out, aux


def _route(p: Dict[str, Any], moe: MoEConfig, xf: torch.Tensor,
           with_aux: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing of the tokens xf (t, d): (top-k weights, expert ids (t, K),
    aux loss)."""
    logits = xf.float() @ p["router"]                          # (t, E)
    topw, topi = ops.topk_router(logits.contiguous(), moe.top_k)
    aux = (aux_loss(torch.softmax(logits, dim=-1), topi, moe) if with_aux
           else logits.new_zeros(()))
    return topw, topi, aux


def _routed(p: Dict[str, Any], moe: MoEConfig, x: torch.Tensor, act: str,
            groups: int, with_aux: bool,
            place: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of :func:`apply_moe`: x (B,S,d) -> (out
    (B,S,d), aux).  Routing, then the dispatch into the (E, slots, d)
    block, the experts on it, and the combine.  ``place(xs, run)`` runs
    the experts where they are split over the mesh: it takes the whole
    block ``xs`` of these tokens and ``run``, the experts' MLP on a block
    of this rank's experts (``p`` holds only those), and returns the
    block's outputs (zero rows for experts another rank of a partial
    sum runs)."""
    B, S, d = x.shape
    t = B * S
    E, K = moe.num_experts, moe.top_k
    if t % groups:
        raise ValueError(f"{groups} capacity groups do not divide {t} tokens")
    xf = x.reshape(t, d)
    topw, topi, aux = _route(p, moe, xf, with_aux)

    tg = t // groups
    C = _capacity(tg, moe)
    # an expert sees at most one assignment per token of its group
    width = min(C, tg)
    slot = _dispatch(topi, groups, E, C, width)               # (t*K,)
    n_slots = E * groups * width
    token = torch.arange(t * K, device=x.device) // K
    # which token fills each block slot (t: the zero row); dropped
    # assignments all land on the trash slot, which is cut off
    src = torch.full((n_slots + 1,), t, dtype=torch.long, device=x.device)
    src[slot] = token
    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    xs = x_pad[src[:n_slots]].reshape(E, groups * width, d)

    def run(block):
        return _experts(p, block, act)

    y = (run(xs) if place is None else place(xs, run)).reshape(n_slots, d)
    y = torch.cat([y, y.new_zeros((1, d))])[slot]             # (t*K, d)
    y = y * topw.reshape(t * K, 1).to(x.dtype)
    return y.reshape(t, K, d).sum(dim=1).reshape(B, S, d), aux
