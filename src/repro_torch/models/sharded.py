"""The port's kernel call sites on DTensors.

Under the launch layer's shardings (``launch/shardings.py``) the model
code runs on DTensors, and DTensor's sharding propagation takes every
plain PyTorch op.  A kernel cannot take a DTensor: each kernel call site
hands it *local* tensors through
``torch.distributed.tensor.experimental.local_map``, with placements
that keep the kernel's reduction axis whole, so the plain version (the
dry run's fake CPU tensors) and the kernel (a card) both see one
rank's shard:

- attention (``flash_attention`` and its plain version), the dense
  decode kernel and the two paged ones over (batch, heads)
  (:func:`attention`, :func:`decode_attention`, :func:`paged`);
- the router (``topk_router``) over tokens, inside the MoE's routed
  experts (:func:`moe`), whose expert weights may be split over the
  mesh: along their experts (the reference's ``EXPERT_PARALLEL_RULES``,
  or an override that puts ``expert`` on a token axis, whose dispatch
  is then an all-to-all over that axis) and along their FFN width;
- the SSD scan (``mamba_chunk_scan``) over (batch, heads) (:func:`scan`).

The same is done, for DTensor's sake, where a plain op sequence would
propagate badly or not at all: the mLSTM's parallel form and the sLSTM's
loop over time (:func:`batch_heads`, :func:`heads_scan`), the causal
depthwise convolutions (:func:`depthwise`), the vocab-parallel
embedding (:func:`embedding`), the ring caches' row writes
(:func:`write_rows`) and the page pool's (:func:`write_pages`).  A ``local_map`` input kept whole on mesh axes
where the other inputs' rows are split gets a partial-sum gradient
there (:func:`_grad_pl`), and a partial result comes back stacked on a
leading dim and is summed as a DTensor (:func:`_lead`).

A placement that would split a kernel's reduction axis raises rather
than gathers: the keys' sequence and head dim of attention, the time
axis of a scan.  (The router's logits stay whole along the experts on
every rank: the router weight is gathered, however it is laid out.)
The one exception is a decode cache split along its slots (the
reference's ``kv_seq`` rule):
:func:`decode_attention` runs each rank's slots on their own, through
the dense decode kernel's partial instance (``decode_attention_partial``,
which returns the unnormalised output, the row max and the row sum; its
plain version on the CPU), and merges the partial softmaxes across ranks
(a max, then two sums) in DTensor ops, which is what XLA's partitioner
does with the reference's sharded cache.

Where the query heads are split over a mesh axis and the kv heads are
not (fewer kv heads than the axis is wide: gemma3's single kv head),
each kv head is repeated once per query head it serves before the split,
a local copy that moves nothing between ranks.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, List, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ref


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _check(t: DTensor, name: str, allowed: Sequence[int]) -> None:
    """Raise if ``t`` is split along a dim outside ``allowed`` (partial
    sums are reduced by the redistribution that follows)."""
    names = t.device_mesh.mesh_dim_names
    for j, p in enumerate(t.placements):
        if p.is_shard() and p.dim not in allowed:
            raise ValueError(
                f"{name} of shape {tuple(t.shape)} is {p} over mesh axis "
                f"{names[j]!r}: the kernel takes it split only along dims "
                f"{tuple(allowed)} (a split of its reduction axis would "
                "need a gather)")


def _layout(t: DTensor, keep: Sequence[int]) -> List[Placement]:
    """``t``'s placements with its splits along ``keep`` kept and
    everything else (partial sums, other splits) made whole."""
    return [p if p.is_shard() and p.dim in keep else Replicate()
            for p in t.placements]


def whole_rows_of(y: DTensor, h: int) -> DTensor:
    """``y`` (..., h * k) with its last dim made whole over every mesh
    axis that does not divide ``h``, so it unflattens to (..., h, k)."""
    last = y.ndim - 1
    pl = [Replicate() if p.is_shard(last) and h % y.device_mesh.size(j)
          else p for j, p in enumerate(y.placements)]
    return y if pl == list(y.placements) else y.redistribute(
        y.device_mesh, pl)


def plain(x):
    """A replicated DTensor's full value (positions, masks the caller
    built), or ``x`` itself."""
    if not is_dtensor(x):
        return x
    if not all(p.is_replicate() for p in x.placements):
        raise ValueError(f"expected a replicated tensor, got {x.placements}")
    return x.to_local()


def _match_heads(q_pl: List[Placement], t: DTensor, head_dim: int,
                 n_heads: int) -> DTensor:
    """``t`` (..., Hkv at ``head_dim``, D) with its kv heads split as
    ``q_pl`` splits the query heads: each kv head repeated G = H / Hkv
    times first where the query heads are split and the kv heads are
    not."""
    hkv = t.shape[head_dim]
    if hkv != n_heads and any(
            qp.is_shard(head_dim) and not tp.is_shard(head_dim)
            for qp, tp in zip(q_pl, t.placements)):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(head_dim) else p for p in t.placements])
        g = n_heads // hkv
        shape = tuple(t.shape)
        t = t.unsqueeze(head_dim + 1).expand(
            shape[:head_dim + 1] + (g,) + shape[head_dim + 1:]).reshape(
            shape[:head_dim] + (n_heads,) + shape[head_dim + 1:])
    return t


def attention(fn: Callable, q: DTensor, k: DTensor, v: DTensor
              ) -> DTensor:
    """``fn(q, k, v)`` on each rank's shard: q (B,S,H,D), k/v
    (B,Sk,Hkv,D'), split over batch and heads only; returns (B,S,H,Dv)
    laid out as q."""
    _check(q, "the query", (0, 1, 2))
    _check(k, "the keys", (0, 2))
    _check(v, "the values", (0, 2))
    mesh = q.device_mesh
    q_pl = _layout(q, (0, 2))
    q = q.redistribute(mesh, q_pl)
    k = _match_heads(q_pl, k, 2, q.shape[2]).redistribute(mesh, q_pl)
    v = _match_heads(q_pl, v, 2, q.shape[2]).redistribute(mesh, q_pl)
    return local_map(fn, out_placements=q_pl,
                     in_placements=(q_pl, q_pl, q_pl),
                     device_mesh=mesh)(q, k, v)


def batch_heads(fn: Callable, *ts: DTensor) -> DTensor:
    """``fn(*ts)`` on each rank's batch rows and heads, for tensors that
    all hold the batch at dim 0, the sequence at dim 1 and the heads at
    dim 2 (the mLSTM's q, k, v (B,T,H,hd) and gates (B,T,H)); the layout
    is the first's, the output (B,T,H,...) laid out as it."""
    for t in ts:
        _check(t, "an input", tuple(d for d in range(t.ndim) if d != 1))
    mesh = ts[0].device_mesh
    pl = _layout(ts[0], (0, 2))
    ts = [_as_dtensor(t, mesh).redistribute(mesh, pl) for t in ts]
    return local_map(fn, out_placements=pl,
                     in_placements=tuple(pl for _ in ts),
                     device_mesh=mesh)(*ts)


def heads_scan(fn: Callable, *ts) -> DTensor:
    """A recurrence over time on each rank's batch rows and heads: the
    sLSTM's ``fn(gate_i, gate_f, gate_z, gate_o, *weights)``, gates
    (B,T,H,hd) and per-head weights (H, ...) -> (B,T,H,hd).  Time is the
    reduction axis: a split of it raises."""
    gates, weights = ts[:4], ts[4:]
    for t in gates:
        _check(t, "a gate", (0, 2, 3))
    mesh = gates[0].device_mesh
    pl = _layout(gates[0], (0, 2))
    w_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    args = [t.redistribute(mesh, pl) for t in gates] + [
        _as_dtensor(w, mesh).redistribute(mesh, w_pl) for w in weights]
    rows = [j for j, p in enumerate(pl) if p.is_shard(0)]
    return local_map(fn, out_placements=pl,
                     in_placements=tuple([pl] * 4 + [w_pl] * len(weights)),
                     in_grad_placements=tuple(
                         [pl] * 4 + [_grad_pl(w_pl, rows)] * len(weights)),
                     device_mesh=mesh)(*args)


def embedding(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` with the table's vocab split as it is (the
    vocab-parallel lookup): each rank looks up the tokens of its vocab
    chunk and zeros the rest, and the ranks' rows sum (a partial sum
    over the vocab's mesh axes); the table's other splits are gathered
    and the tokens keep their batch split.  (DTensor's own rules for an
    index into a split table differ between releases.)"""
    mesh = table.device_mesh
    t_pl = [p if p.is_shard(0) else Replicate() for p in table.placements]
    tokens = _as_dtensor(tokens, mesh)
    k_pl = [Shard(0) if p.is_shard(0) and not t_pl[j].is_shard(0)
            else Replicate() for j, p in enumerate(tokens.placements)]
    vocab = [j for j, p in enumerate(t_pl) if p.is_shard(0)]

    def local(tl, ids):
        lo = _chunk_offset(mesh, vocab, tl.shape[0])
        rel = ids.long() - lo
        mine = (rel >= 0) & (rel < tl.shape[0])
        rows = tl[rel.clamp(0, tl.shape[0] - 1)]
        return (rows * mine[..., None].to(rows.dtype))[None]

    rows = [j for j, p in enumerate(k_pl) if p.is_shard(0)]
    return _sum_lead(local_map(
        local, out_placements=_lead(k_pl, vocab), in_placements=(t_pl, k_pl),
        in_grad_placements=(_grad_pl(t_pl, rows), k_pl),
        device_mesh=mesh)(table.redistribute(mesh, t_pl),
                          tokens.redistribute(mesh, k_pl)))


def _lead(pl: Sequence[Placement], over: Sequence[int]) -> List[Placement]:
    """Placements of each rank's result stacked on a new leading dim, that
    dim split over the mesh dims ``over`` and the rest as ``pl`` (its
    dims one further on).  A partial result is returned this way and
    summed at the DTensor level (:func:`_sum_lead`): a ``Partial`` output
    of ``local_map`` would take back a gradient in that layout, which
    DTensor makes by zeroing every rank's but one."""
    return [Shard(0) if j in over else Shard(p.dim + 1) if p.is_shard()
            else p for j, p in enumerate(pl)]


def _sum_lead(x: DTensor) -> DTensor:
    return x.sum(0)


def _grad_pl(pl: Sequence[Placement], split: Sequence[int]
             ) -> List[Placement]:
    """The gradient's placements of an input that ``pl`` keeps whole on
    the mesh dims ``split`` (where the other inputs' rows are split):
    each such rank's gradient is a partial sum over those dims (the
    default, ``pl`` itself, would take one rank's as the whole)."""
    return [Partial() if j in split and p.is_replicate() else p
            for j, p in enumerate(pl)]


def depthwise(fn: Callable, x: DTensor, w, b) -> DTensor:
    """A causal depthwise convolution ``fn(x, w, b)`` over time on each
    rank's batch rows and channels: x (B,T,ch), w (W,ch), b (ch,).
    Any other layout of x (a split of time among them) is made whole
    first: the convolution is no kernel call site."""
    mesh = x.device_mesh
    pl = _layout(x, (0, 2))
    w_pl = [Shard(1) if p.is_shard(2) else Replicate() for p in pl]
    b_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    rows = [j for j, p in enumerate(pl) if p.is_shard(0)]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl, w_pl, b_pl),
                     in_grad_placements=(pl, _grad_pl(w_pl, rows),
                                         _grad_pl(b_pl, rows)),
                     device_mesh=mesh)(
        x.redistribute(mesh, pl), _as_dtensor(w, mesh).redistribute(
            mesh, w_pl), _as_dtensor(b, mesh).redistribute(mesh, b_pl))


def _chunk_offset(mesh, dims: Sequence[int], size: int) -> int:
    """First index of this rank's chunk of a tensor dim of local ``size``
    split over mesh dims ``dims`` (outermost first)."""
    coord = mesh.get_coordinate()
    chunk = 0
    for j in dims:
        chunk = chunk * mesh.size(j) + coord[j]
    return chunk * size


def decode_attention(full: Callable, partial: Callable, q: DTensor,
                     kc: DTensor, vc: DTensor, valid) -> DTensor:
    """One query a row against a cache: q (B,1,H,D), kc/vc (B,C,Hkv,D),
    valid (B,C).  The cache fixes the layout: batch and heads split as it
    is (the query follows), its slots split or not.  Unsplit slots run
    ``full(q, kc, vc, valid)`` on each rank's shard; split slots run
    ``partial(q, kc, vc, valid)`` -> (unnormalised output (B,1,H,Dv)
    fp32, row max (B,1,H), row sum (B,1,H)) on each rank's slots (on
    the card the kernel's partial instance, which raises rather than
    fall back), merged across ranks here.  A rank whose share of a row
    has no valid slot reports the max -2e38 and weighs 0 beside one that
    has; where no rank has one, the merge gives the uniform mean of V,
    as the unsplit kernel does."""
    _check(kc, "the key cache", (0, 1, 2))
    _check(vc, "the value cache", (0, 1, 2))
    mesh = kc.device_mesh
    kv_pl = list(kc.placements)
    q_pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
            else Replicate() for p in kv_pl]
    if not is_dtensor(valid):
        valid = DTensor.from_local(valid, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    valid_pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
                for p in kv_pl]
    valid = valid.redistribute(mesh, valid_pl)
    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # the query's heads follow the cache's: split where its kv heads are
    q = q.redistribute(mesh, q_pl)
    split = [j for j, p in enumerate(kv_pl) if p.is_shard(1)]
    if not split:
        return local_map(full, out_placements=q_pl,
                         in_placements=(q_pl, kv_pl, kv_pl, valid_pl),
                         device_mesh=mesh)(q, kc, vc, valid)
    # each rank's partials gain a leading dim, split over the slot axes
    lead = _lead([Replicate() if j in split else p
                  for j, p in enumerate(q_pl)], split)

    def part(ql, kl, vl, ml):
        o, m, s = partial(ql, kl, vl, ml)
        return o[None], m[None], s[None]

    o, m, s = local_map(part, out_placements=(lead, lead, lead),
                        in_placements=(q_pl, kv_pl, kv_pl, valid_pl),
                        device_mesh=mesh)(q, kc, vc, valid)
    o, _, s = ref.combine_partials(o, m, s)
    return (o / s[..., None]).to(vc.dtype)


def write_rows(buf: DTensor, new, slot) -> None:
    """``buf[b, slot[b]] = new[b]`` in place for every row b of a cache
    ``buf`` (B,C,...) whose rows and slots may be split: each rank writes
    the rows it holds whose slot falls in its chunk of the slots."""
    mesh = buf.device_mesh
    b_pl = list(buf.placements)
    n_pl = [Shard(0) if p.is_shard(0) else Shard(p.dim - 1)
            if p.is_shard() and p.dim >= 2 else Replicate() for p in b_pl]
    s_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in b_pl]
    seq = [j for j, p in enumerate(b_pl) if p.is_shard(1)]

    def as_dt(x, pl):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, pl)

    def local(b, n, s):
        C = b.shape[1]
        ls = s.long() - _chunk_offset(mesh, seq, C)
        inside = (ls >= 0) & (ls < C)
        ls = ls.clamp(0, C - 1)
        rows = torch.arange(b.shape[0], device=b.device)
        cur = b[rows, ls]
        keep = inside.reshape((-1,) + (1,) * (cur.dim() - 1))
        b[rows, ls] = torch.where(keep, n.to(b.dtype), cur)
        return s

    local_map(local, out_placements=s_pl,
              in_placements=(b_pl, n_pl, s_pl), device_mesh=mesh)(
        buf, as_dt(new, n_pl), as_dt(slot, s_pl))


def paged(fn: Callable, qs, pages, block_tables, pos,
          head_pages: bool) -> DTensor:
    """Paged decode ``fn(*qs, *pages, block_tables, pos)`` on each rank's
    batch rows and heads: queries (B,1,H,...) split as the first is over
    batch and heads; the page pool whole on every rank of the batch's
    mesh axes (a rank reads only its rows' pages, which
    :func:`write_pages` wrote into its copy), its heads (dim 2, with
    ``head_pages``) split as the query heads; block tables (B,P) and
    positions (B,) split as the rows.  Returns (B,1,H,...) laid out as
    the first query."""
    mesh = qs[0].device_mesh
    q_pl = _layout(qs[0], (0, 2))
    qs = [_as_dtensor(q, mesh).redistribute(mesh, q_pl) for q in qs]
    pg_pl = [Shard(2) if head_pages and p.is_shard(2) else Replicate()
             for p in q_pl]
    pages = [(_match_heads(q_pl, pg, 2, qs[0].shape[2]) if head_pages
              else pg).redistribute(mesh, pg_pl) for pg in pages]
    r_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in q_pl]
    rows = [_as_dtensor(t, mesh).redistribute(mesh, r_pl)
            for t in (block_tables, pos)]
    return local_map(fn, out_placements=q_pl,
                     in_placements=tuple([q_pl] * len(qs)
                                         + [pg_pl] * len(pages)
                                         + [r_pl, r_pl]),
                     device_mesh=mesh)(*qs, *pages, *rows)


def write_pages(fn: Callable, pages: DTensor, new, page_ids, slot_ids
                ) -> None:
    """The paged write ``fn(pages, new, page_ids, slot_ids)`` in place on
    each rank's copy of the pool: a rank writes its rows (``new`` (B,S,...)
    split over batch as it is, its heads as the pool's), so each copy
    holds the pages of the rows that rank reads (:func:`paged`)."""
    mesh = pages.device_mesh
    pg_pl = list(pages.placements)
    new = _as_dtensor(new, mesh)
    n_pl = [Shard(0) if n.is_shard(0) else Shard(2) if p.is_shard(2)
            else Replicate() for n, p in zip(new.placements, pg_pl)]
    r_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in n_pl]

    def local(pl, nl, il, sl):
        fn(pl, nl, il, sl)
        return il

    local_map(local, out_placements=r_pl,
              in_placements=(pg_pl, n_pl, r_pl, r_pl), device_mesh=mesh)(
        pages, new.redistribute(mesh, n_pl),
        _as_dtensor(page_ids, mesh).redistribute(mesh, r_pl),
        _as_dtensor(slot_ids, mesh).redistribute(mesh, r_pl))


def _as_dtensor(x, mesh):
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def moe(fn: Callable, x: DTensor, weights: dict):
    """The routed experts ``fn(x, weights, place) -> (out, aux)`` on each
    rank's tokens: x (B,S,d) split over its batch rows only (so each rank
    routes whole rows of d), the router whole, each expert weight split
    as ``params_shardings`` lays it out along its experts (dim 0) and its
    FFN width (``"mlp"``), its other splits gathered.  Capacity is per
    rank's tokens, as separate calls would give it, and the aux loss is
    the mean of the ranks'.

    Experts split over mesh dims where x's rows are whole (the
    expert-parallel rules: experts over ``model``, rows over the data
    axes) need no exchange: every rank of such a line routes the same
    tokens, runs its own experts' slots of the dispatch block, and the
    output is a partial sum over those dims, as it is over the dims that
    split the FFN width.  Experts split over mesh dims that also split
    the rows (an override such as ``expert=("data",)``) are reached by
    an all-to-all over those dims: each rank sends every peer the slots
    its tokens give that peer's experts, runs its own experts on the
    slots from every peer, and a second all-to-all returns the outputs
    (:func:`_exchange`).  ``place`` does both for ``fn`` (see
    ``models/moe.py``'s ``_routed``); it is None where no expert weight
    is split.

    Every rank of a partial sum returns its output and aux loss stacked
    on a leading dim split over the partial dims (:func:`_lead`), and
    its gradients of x and of the weights are partial sums there too:
    the routing (router, x through the logits, the aux loss) is the
    same on each such rank, and the aux loss's mean over those copies
    hands each a share of its gradient."""
    mesh = x.device_mesh
    keys = sorted(weights)
    ws = [_as_dtensor(weights[k], mesh) for k in keys]
    ff = {k: 2 if k != "wo" else 1 for k in keys if k != "router"}
    experts = {k: [j for j, p in enumerate(w.placements) if p.is_shard(0)]
               for k, w in zip(keys, ws) if k in ff}
    split = next(iter(experts.values()), [])
    if any(e != split for e in experts.values()):
        raise ValueError(f"the expert weights split their experts over "
                         f"different mesh dims: {experts}")
    split_ff = sorted({j for k, w in zip(keys, ws) if k in ff
                       for j, p in enumerate(w.placements)
                       if p.is_shard(ff[k])})
    rows = [j for j, p in enumerate(x.placements)
            if p.is_shard(0) and j not in split_ff]
    x_pl = [Shard(0) if j in rows else Replicate() for j in range(mesh.ndim)]
    exchange = [j for j in split if j in rows]
    partial = sorted({j for j in split if j not in rows} | set(split_ff))
    w_pl = [[Replicate()] * mesh.ndim if k == "router" else
            [Shard(0) if j in split else Shard(ff[k]) if p.is_shard(ff[k])
             else Replicate() for j, p in enumerate(w.placements)]
            for k, w in zip(keys, ws)]
    place = _expert_placement(mesh, split, exchange) if split else None

    def local(xl, *wl):
        out, aux = fn(xl, dict(zip(keys, wl)), place)
        return out[None], aux[None]

    out, aux = local_map(
        local, out_placements=(_lead(x_pl, partial),
                               _lead([Replicate()] * mesh.ndim,
                                     sorted(rows + partial))),
        in_placements=(x_pl,) + tuple(w_pl),
        in_grad_placements=(_grad_pl(x_pl, partial),) + tuple(
            _grad_pl(pl, rows + partial) for pl in w_pl),
        device_mesh=mesh)(x.redistribute(mesh, x_pl),
                          *(w.redistribute(mesh, pl)
                            for w, pl in zip(ws, w_pl)))
    return _sum_lead(out), aux.mean(0)


def _expert_placement(mesh, split: Sequence[int], exchange: Sequence[int]
                      ) -> Callable:
    """``place(xs, run)`` for experts split over the mesh dims ``split``
    (in mesh order: DTensor's chunk of the expert dim), ``exchange`` the
    ones among them that also split the tokens.  xs (E, slots, d) is the
    dispatch block of this rank's tokens; ``run`` is the experts' MLP on
    a block of this rank's experts.  Returns the (E, slots, d) outputs of
    the experts this rank and its ``exchange`` peers hold (the rows of
    the others zero: a partial sum over the rest of ``split``)."""
    group = None
    if exchange:
        from repro_torch.launch.mesh import axes_group
        group = axes_group(mesh, [mesh.mesh_dim_names[j] for j in exchange])
    n_chunks = math.prod(mesh.size(j) for j in split)

    def place(xs, run):
        E, width, d = xs.shape
        el = E // n_chunks
        coord = mesh.get_coordinate()
        chunks = []
        # the exchange group's members in its rank order (row-major over
        # the exchange dims), each with the chunk of experts it holds
        for peer in itertools.product(*(range(mesh.size(j))
                                         for j in exchange)):
            at = dict(zip(exchange, peer))
            c = 0
            for j in split:
                c = c * mesh.size(j) + at.get(j, coord[j])
            chunks.append(c)
        idx = torch.cat([torch.arange(c * el, (c + 1) * el, device=xs.device)
                         for c in chunks])
        n = len(chunks)
        blk = _exchange(xs[idx], group)     # (n * el, width, d): by peer
        blk = blk.reshape(n, el, width, d).transpose(0, 1)
        ys = run(blk.reshape(el, n * width, d))
        ys = ys.reshape(el, n, width, d).transpose(0, 1).reshape(
            n * el, width, d)
        return xs.new_zeros(xs.shape).index_copy(0, idx,
                                                 _exchange(ys, group))

    return place


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s equal blocks along dim 0, block i sent to the ``group``'s
    rank i, the blocks received stacked in the senders' order (an
    all-to-all, differentiable: its backward is the reverse exchange);
    ``t`` itself where there is no group."""
    if group is None:
        return t
    import torch.distributed._functional_collectives as funcol
    return funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                             group)


def scan(fn: Callable, xin: DTensor, dt, A, Bm, Cm) -> DTensor:
    """The SSD scan ``fn(xin, dt, A, Bm, Cm) -> y`` on each rank's batch
    rows and heads: xin (B,L,H,P), dt (B,L,H), A (H,), Bm/Cm (B,L,G,N)
    (the groups serve every head, so they are split over batch only).
    The time axis is the scan's reduction axis: a split of it raises."""
    _check(xin, "the scan input", (0, 2, 3))
    mesh = xin.device_mesh
    x_pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
            else Replicate() for p in xin.placements]
    dt_pl = x_pl
    a_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in x_pl]
    bc_pl = [p if p.is_shard(0) else Replicate() for p in x_pl]
    args = [_as_dtensor(t, mesh) for t in (xin, dt, A, Bm, Cm)]
    for t, name in zip(args[1:], ("dt", "A", "B", "C")):
        if t.ndim > 1:       # (B,L,...): L is the scan's time
            _check(t, f"the scan's {name}",
                   tuple(d for d in range(t.ndim) if d != 1))
    pls = (x_pl, dt_pl, a_pl, bc_pl, bc_pl)
    args = [t.redistribute(mesh, pl) for t, pl in zip(args, pls)]
    rows = [j for j, p in enumerate(x_pl) if p.is_shard(0)]
    heads = [j for j, p in enumerate(x_pl) if p.is_shard(2)]
    return local_map(fn, out_placements=x_pl, in_placements=pls,
                     in_grad_placements=(x_pl, dt_pl, _grad_pl(a_pl, rows),
                                         _grad_pl(bc_pl, heads),
                                         _grad_pl(bc_pl, heads)),
                     device_mesh=mesh)(*args)
