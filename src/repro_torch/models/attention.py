"""Attention for training, prefill and single-token decode, over a dense
ring cache or a paged cache: grouped-query attention (GQA) and DeepSeek's
multi-head latent attention (MLA) of ``repro/models/attention.py``, with
the same functions and cache layouts.

On CUDA tensors the attention itself goes through the port's kernels:
prefill and forward through ``ops.flash_attention`` (GQA, and MLA with
score dim nope + rope and value dim v), GQA dense decode through
``ops.decode_attention``, GQA paged decode through
``ops.paged_decode_attention``, and MLA paged decode through
``ops.paged_mla_decode_attention`` (absorbed: scores against the latent
cache itself).  MLA dense decode has no TPU kernel (the JAX module
computes it with einsums), so it stays PyTorch ops on the card too.  On
CPU tensors the attention is :func:`_sdpa` or those einsums, the plain
counterpart of the JAX module's XLA path, which the JAX models run.  The
projections, rope and cache writes are the same code on both.

Two departures from the JAX module, both about state:

- Caches are written in place (JAX returns new arrays).  The functions
  still return the cache, so callers read like the reference; a caller
  that needs the old contents clones them first (the engines'
  ``measure()`` does).
- :class:`KVCache` and :class:`MLACache` keep one ring ``index`` per
  batch row, shape (B,), where JAX keeps a scalar and vmaps a batch-1
  cache over slots; the dense engine's batched decode step is then one
  call with per-row positions.

GQA takes gemma3's features as the JAX module does: ``qk_norm`` (the
``q_norm`` / ``k_norm`` leaves, an RMS norm over each head's dims before
rope, in every GQA path) and ``logit_soft_cap``, which the JAX module
applies in decode only (:func:`gqa_decode`, :func:`paged_gqa_decode`)
and not in forward or prefill; the port keeps that asymmetry.  Local and
global layers differ only in the window and rope table the caller passes.

Cross attention (whisper's decoder) is :func:`gqa_forward` with
``kv_source`` and :func:`gqa_decode` with ``cross_kv``, as in JAX: on the
card the forward runs ``ops.flash_attention`` without the causal mask
over a key length of its own (the F encoder frames), and the decode step
runs ``ops.decode_attention`` with every one of the F rows valid.  MLA
with ``q_lora_rank > 0`` projects its queries through the plain ``wq``,
as the reference does (:func:`init_mla`).

On DTensors (the launch layer's shardings) the projections, rope and
norms are DTensor ops under ``shard`` constraints, and the attention
itself, dense decode and the ring writes run on each rank's local
shards through ``models/sharded.py``; a decode cache split along its
slots is merged from each rank's partial softmax (:func:`_decode_partial`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models import sharded
from repro_torch.models.common import ParamInit, shard
from repro_torch.models.rope import apply_rope

_NEG_INF = -2.0e38  # fp32-safe mask value, as in the JAX module
NOT_PORTED = "is not ported to PyTorch yet; see ROADMAP.md"


def init_gqa(pi: ParamInit, path: str, d_model: int, a: AttentionConfig,
             stack: int = 0) -> None:
    hd = a.head_dim
    pi.param(f"{path}/wq", (d_model, a.num_heads, hd),
             ("embed", "heads", "head_dim"), stack=stack)
    pi.param(f"{path}/wk", (d_model, a.num_kv_heads, hd),
             ("embed", "kv_heads", "head_dim"), stack=stack)
    pi.param(f"{path}/wv", (d_model, a.num_kv_heads, hd),
             ("embed", "kv_heads", "head_dim"), stack=stack)
    pi.param(f"{path}/wo", (a.num_heads, hd, d_model),
             ("heads", "head_dim", "embed"), stack=stack)
    if a.qk_norm:
        pi.param(f"{path}/q_norm", (hd,), ("head_dim",), init="ones",
                 stack=stack)
        pi.param(f"{path}/k_norm", (hd,), ("head_dim",), init="ones",
                 stack=stack)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    y = torch.matmul(x, w.reshape(d, h * k))
    if sharded.is_dtensor(y):
        # rows whole on their ranks and whole heads split (no sequence
        # split, which the product's backward cannot take, and no split
        # of h * k that h does not divide, which the weight gradient's
        # reshape cannot take)
        y = sharded.whole_rows_of(shard(y, "batch", "seq", "heads_act",
                                        sizes=tuple(y.shape[:-1]) + (h,)),
                                  h)
    return y.unflatten(-1, (h, k))


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), constrained like the residual stream (a
    constraint the reference leaves to XLA's propagation: DTensor would
    carry its product's layout, a split sequence among them, into the
    next layer)."""
    h, k, d = wo.shape
    return shard(torch.matmul(o.flatten(-2), wo.reshape(h * k, d)),
                 "batch", "seq", "embed_act")


def _qkv(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
         positions: torch.Tensor, inv_freq: Optional[torch.Tensor]):
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if a.qk_norm:
        q = _rms_head_norm(q, p["q_norm"])
        k = _rms_head_norm(k, p["k_norm"])
    if inv_freq is not None:
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    return q, k, v


# ---------------------------------------------------------------------------
# Core scaled-dot-product (plain) and the kernel calls
# ---------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window,
          soft_cap: float, k_valid: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D'), positions (Tq,)/(Tk,); returns
    (B,Tq,Hq,Dv).  The JAX module's ``_sdpa`` step for step: scores in
    q's dtype then fp32, mask -2e38, probabilities cast to v's dtype."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() \
        * (1.0 / math.sqrt(D))
    if soft_cap:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    d = q_pos[:, None].long() - k_pos[None, :].long()
    mask = (d >= 0) if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        mask = mask & (d < window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
        scores = torch.where(mask, scores, _NEG_INF)
    else:
        scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Tq, Hq, v.shape[-1])


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window) -> torch.Tensor:
    """Attention of queries at positions 0..S-1 over keys at 0..Sk-1
    through ``ops.flash_attention``: q (B,S,H,D), k/v (B,Sk,Hkv,D) ->
    (B,S,H,Dv); Sk differs from S only without the causal mask (cross
    attention).  Heads fold into the kernel's BH axis, query head h of
    sequence b at row b*H + h and kv head h // G at row b*Hkv + h // G,
    which the kernel finds as row // G, so the kv heads are passed
    once."""
    B, S, H, D = q.shape
    Dv = v.shape[3]

    def fold(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1],
                                         t.shape[-1]).contiguous()

    out = ops.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                              window=0 if window is None else int(window))
    return out.reshape(B, H, S, Dv).transpose(1, 2)


def _attention(q, k, v, q_pos, k_pos, causal, window):
    """Full-sequence attention, queries at ``q_pos`` = 0..S-1 over keys at
    ``k_pos`` = 0..Sk-1: the flash kernel on the card, :func:`_sdpa` on
    the CPU; on DTensors, either on each rank's batch rows and heads
    (``models/sharded.py``)."""
    if sharded.is_dtensor(q):
        q_pos, k_pos = sharded.plain(q_pos), sharded.plain(k_pos)
        return sharded.attention(
            lambda ql, kl, vl: _attention(ql, kl, vl, q_pos, k_pos, causal,
                                          window), q, k, v)
    if q.is_cuda:
        return _flash(q, k, v, causal, window)
    return _sdpa(q, k, v, q_pos, k_pos, causal, window, 0.0)


def _shard_qkv(q, k, v):
    """The reference's activation constraints before attention."""
    return (shard(q, "batch", "seq", "heads_act", None),
            shard(k, "batch", "seq", "kv_heads_act", None),
            shard(v, "batch", "seq", "kv_heads_act", None))


# ---------------------------------------------------------------------------
# GQA forward (train / prefill) and decode over the dense ring cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffer KV cache.  ``k``/``v``: (B, C, Hkv, D); ``pos``:
    (B, C) absolute position of each slot (-1 = empty); ``index``: (B,)
    next write slot of each row (mod C)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    index: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def init_kv_cache(batch: int, capacity: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device: Optional[torch.device] = None) -> KVCache:
    shape = (batch, capacity, num_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device),
        index=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def ring_positions(capacity: int, tokens: int) -> torch.Tensor:
    """A ring's ``pos`` row (int32) after ``tokens`` tokens written one a
    step from slot 0: slot s holds the last position p < ``tokens`` with
    p % ``capacity`` == s, or -1."""
    s = torch.arange(capacity)
    return torch.where(s < tokens, s + capacity * ((tokens - 1 - s)
                                                   // capacity),
                       -1).to(torch.int32)


def map_kv_caches(fn, cache, *trees):
    """``fn(ring, *matching)`` over every :class:`KVCache` of a cache tree
    (the nested dicts of a model's ``init_cache``) and of the trees
    shaped like it, the results in a tree of the same shape."""
    if isinstance(cache, KVCache):
        return fn(cache, *trees)
    return {k: map_kv_caches(fn, v, *(t[k] for t in trees))
            for k, v in cache.items()}


def _cross_q(p: Dict[str, Any], a: AttentionConfig,
             x: torch.Tensor) -> torch.Tensor:
    """Cross attention's query: no rope."""
    q = _project(x, p["wq"])
    return _rms_head_norm(q, p["q_norm"]) if a.qk_norm else q


def gqa_forward(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, inv_freq: Optional[torch.Tensor],
                window=None, causal: bool = True,
                kv_source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,d), positions 0..S-1 -> (B,S,d).  ``kv_source`` (B,F,d)
    switches to cross attention: keys and values from the encoder output
    at positions 0..F-1, no rope and no causal mask."""
    if kv_source is None:
        q, k, v = _qkv(p, a, x, positions, inv_freq)
        k_pos = positions
    else:
        q = _cross_q(p, a, x)
        k, v = _project(kv_source, p["wk"]), _project(kv_source, p["wv"])
        if a.qk_norm:
            k = _rms_head_norm(k, p["k_norm"])
        causal = False
        k_pos = torch.arange(kv_source.shape[1], device=x.device)
    q, k, v = _shard_qkv(q, k, v)
    out = _attention(q, k, v, positions, k_pos, causal, window)
    return _out_proj(out, p["wo"])


def _ring_write(buf: torch.Tensor, new: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B,S,...) into ring slots along axis 1, in place;
    entries whose slot equals the capacity are dropped (pad /
    out-of-window), as JAX's ``mode='drop'`` scatter drops them."""
    keep = slots < buf.shape[1]
    buf[:, slots[keep]] = new[:, keep].to(buf.dtype)
    return buf


def prefill_slots(capacity: int, positions: torch.Tensor,
                  length: int) -> torch.Tensor:
    """Ring slot for each prompt position: the last ``min(length,
    capacity)`` valid positions land at ``pos % capacity``; everything
    else (right padding, positions older than the ring) maps to
    ``capacity``, which :func:`_ring_write` drops."""
    keep = (positions < length) & (positions >= length - capacity)
    return torch.where(keep, positions % capacity,
                       torch.full_like(positions, capacity))


def gqa_prefill(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, length: int, cache: KVCache,
                inv_freq: Optional[torch.Tensor], window=None,
                ) -> Tuple[torch.Tensor, KVCache]:
    """:func:`gqa_forward` plus a one-shot ring write of the roped K/V of
    positions ``[0, length)``.  ``x`` may be right-padded beyond
    ``length``; causality keeps pad keys out of every valid query."""
    q, k, v = _shard_qkv(*_qkv(p, a, x, positions, inv_freq))
    out = _attention(q, k, v, positions, positions, True, window)
    slots = prefill_slots(cache.capacity, positions, length)
    _ring_write(cache.k, k, slots)
    _ring_write(cache.v, v, slots)
    _ring_write(cache.pos, positions.to(cache.pos.dtype)[None].expand(
        x.shape[0], -1), slots)
    cache.index.fill_(length)
    return _out_proj(out, p["wo"]), cache


def gqa_decode(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
               pos: torch.Tensor, cache: KVCache,
               inv_freq: Optional[torch.Tensor], window=None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode.  x (B,1,d); pos () or (B,) absolute position
    of each row.  Writes row b's K/V at ring slot ``index[b] % C``.  With
    ``cross_kv`` = (k, v), each (B,F,Hkv,D), the query attends to every
    one of the F precomputed encoder rows instead (no rope, no mask, no
    soft cap, as in JAX) and the ring is left as it is."""
    if cross_kv is not None:
        return _cross_decode(p, a, x, *cross_kv), cache
    B = x.shape[0]
    pos = pos.long().expand(B) if pos.dim() == 0 else pos.long()
    q, k, v = _qkv(p, a, x, pos[:, None], inv_freq)
    _write_slot(cache, (k[:, 0], v[:, 0], pos), cache.index.long()
                % cache.capacity)
    cache.index.add_(1)
    valid = cache.pos >= 0
    if window is not None:
        valid = valid & ((pos[:, None] - cache.pos) < window)
    # the cache may be stored in another dtype: upcast for the dot
    kc, vc = cache.k.to(q.dtype), cache.v.to(q.dtype)
    out = _decode(q, kc, vc, valid, a.logit_soft_cap)
    return _out_proj(out, p["wo"]), cache


def _write_slot(cache, rows, slot) -> None:
    """Row b of each of ``rows`` (its new K/V or latents, and its
    position) into the first fields of ``cache`` at ring slot
    ``slot[b]``, in place."""
    for buf, new in zip(cache, rows):
        if sharded.is_dtensor(buf):
            sharded.write_rows(buf, new, slot)
        else:
            buf[torch.arange(buf.shape[0], device=buf.device), slot] = \
                new.to(buf.dtype)


def _decode_plain(q, kc, vc, valid, soft_cap: float) -> torch.Tensor:
    C = kc.shape[1]
    zeros = torch.zeros((C,), dtype=torch.long, device=q.device)
    return _sdpa(q, kc, vc, zeros[:1], zeros, False, None, soft_cap,
                 k_valid=valid)


def _decode_partial(q, kc, vc, valid, soft_cap: float):
    """:func:`_decode` over a share of the slots, unnormalised: (sum of
    exp(score - max) . v (B,1,H,Dv) fp32, the max (B,1,H), the sum of
    exp(score - max) (B,1,H)): ``ops.decode_attention_partial``, its
    kernel on the card, its plain version on the CPU."""
    o, m, l = ops.decode_attention_partial(q[:, 0].contiguous(), kc, vc,
                                           valid, soft_cap=soft_cap)
    return o[:, None], m[:, None], l[:, None]


def _decode(q, kc, vc, valid, soft_cap: float = 0.0) -> torch.Tensor:
    """One query a row (B,1,H,D) over the cache rows kc/vc (B,C,Hkv,D)
    where ``valid`` (B,C): ``ops.decode_attention`` on the card, the plain
    version on the CPU; on DTensors through ``models/sharded.py``."""
    if sharded.is_dtensor(kc):
        return sharded.decode_attention(
            lambda *t: _decode(*t, soft_cap),
            lambda *t: _decode_partial(*t, soft_cap), q, kc, vc, valid)
    if q.is_cuda:
        return ops.decode_attention(q[:, 0].contiguous(), kc, vc, valid,
                                    soft_cap=soft_cap)[:, None]
    return _decode_plain(q, kc, vc, valid, soft_cap)


def _cross_decode(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One query a row over all F encoder rows of ``ck`` / ``cv``: the
    dense decode kernel on the card (every slot valid), :func:`_sdpa` on
    the CPU."""
    q = _cross_q(p, a, x)
    kc, vc = ck.to(q.dtype), cv.to(q.dtype)
    B, F = kc.shape[:2]
    valid = torch.ones((B, F), dtype=torch.bool, device=x.device)
    return _out_proj(_decode(q, kc, vc, valid), p["wo"])


# ---------------------------------------------------------------------------
# Paged KV cache (block-table) variants
# ---------------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """Paged KV cache shared by all sequences of an engine: ``k_pages`` /
    ``v_pages`` (P+1, page_size, Hkv, D).  Token ``t`` of a sequence
    lives at page ``block_table[t // page_size]`` slot ``t %
    page_size``.  The extra page (id P) is a scratch page: free batch
    rows point their whole block table at it so the batched decode write
    lands somewhere harmless."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]


def init_paged_kv_cache(num_pages: int, page_size: int, num_kv_heads: int,
                        head_dim: int, dtype=torch.bfloat16,
                        device: Optional[torch.device] = None
                        ) -> PagedKVCache:
    shape = (num_pages + 1, page_size, num_kv_heads, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device))


def _page_write(pages: torch.Tensor, new: torch.Tensor,
                page_ids: torch.Tensor, slot_ids: torch.Tensor
                ) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``pages`` at (page_ids, slot_ids)
    (both (B, S)), in place; ids past the last page (padding) are
    dropped."""
    if sharded.is_dtensor(pages):
        sharded.write_pages(_page_write, pages, new, page_ids, slot_ids)
        return pages
    keep = page_ids < pages.shape[0]
    pages[page_ids[keep].long(), slot_ids[keep].long()] = \
        new[keep].to(pages.dtype)
    return pages


def prefill_page_ids(block_tables: torch.Tensor, positions: torch.Tensor,
                     length: int, page_size: int, num_pages: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page/slot id per prompt position for a one-shot paged prefill
    write.  ``block_tables`` (B, Pseq); ``positions`` (S,).  Positions at
    or past ``length`` (right padding) map to page id ``num_pages + 1``,
    which :func:`_page_write` drops."""
    B, Pseq = block_tables.shape
    pidx = torch.clamp(positions // page_size, 0, Pseq - 1)
    pages = block_tables.long()[:, pidx]
    keep = (positions < length) & (positions // page_size < Pseq)
    pages = torch.where(keep[None], pages,
                        torch.full_like(pages, num_pages + 1))
    slots = (positions % page_size)[None].expand(B, -1)
    return pages, slots


def paged_gqa_prefill(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                      positions: torch.Tensor, length: int,
                      cache: PagedKVCache, block_tables: torch.Tensor,
                      inv_freq: Optional[torch.Tensor], window=None,
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """The attention of :func:`gqa_prefill`; only the cache write
    differs: K/V scatter through the block table into pages."""
    q, k, v = _qkv(p, a, x, positions, inv_freq)
    out = _attention(q, k, v, positions, positions, True, window)
    num_pages = cache.k_pages.shape[0] - 1
    pages, slots = prefill_page_ids(block_tables, positions, length,
                                    cache.page_size, num_pages)
    _page_write(cache.k_pages, k, pages, slots)
    _page_write(cache.v_pages, v, pages, slots)
    return _out_proj(out, p["wo"]), cache


def paged_gqa_decode(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: PagedKVCache,
                     block_tables: torch.Tensor,
                     inv_freq: Optional[torch.Tensor], window=None,
                     ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Batched single-token paged decode; ``pos`` (B,) per row.  Token t
    of row b counts iff t <= pos[b] (and pos[b] - t < window): the math
    of :func:`gqa_decode`, so greedy tokens match the dense engine."""
    pos = pos.long()
    q, k, v = _qkv(p, a, x, pos[:, None], inv_freq)
    ps = cache.page_size
    bt = block_tables.long()
    pidx = torch.gather(bt, 1, (pos // ps)[:, None])
    slot = (pos % ps)[:, None]
    _page_write(cache.k_pages, k, pidx, slot)
    _page_write(cache.v_pages, v, pidx, slot)
    kp, vp = cache.k_pages.to(q.dtype), cache.v_pages.to(q.dtype)
    out = _paged_decode(q, kp, vp, block_tables, pos, a.logit_soft_cap,
                        window)
    return _out_proj(out, p["wo"]), cache


def _paged_decode(q, kp, vp, block_tables, pos, soft_cap: float, window):
    """One query a row (B,1,H,D) over the rows' pages: the paged kernel on
    the card, a gather then :func:`_sdpa` on the CPU; on DTensors on each
    rank's rows and heads (``models/sharded.py``)."""
    if sharded.is_dtensor(q):
        return sharded.paged(
            lambda ql, kl, vl, bl, pl: _paged_decode(ql, kl, vl, bl, pl,
                                                     soft_cap, window),
            (q,), (kp, vp), block_tables, pos, head_pages=True)
    if q.is_cuda:
        return ops.paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, block_tables.int().contiguous(),
            (pos + 1).int(), soft_cap=soft_cap, window=window)[:, None]
    B, ps = q.shape[0], kp.shape[1]
    bt = block_tables.long()
    C = bt.shape[1] * ps
    kg = kp[bt].reshape(B, C, *kp.shape[2:])
    vg = vp[bt].reshape(B, C, *vp.shape[2:])
    tok = torch.arange(C, device=q.device)[None, :]
    valid = tok <= pos[:, None]
    if window is not None:
        valid &= (pos[:, None] - tok) < window
    zeros = torch.zeros((C,), dtype=torch.long, device=q.device)
    return _sdpa(q, kg, vg, zeros[:1], zeros, False, None, soft_cap,
                 k_valid=valid)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): forward, dense ring cache, paged latent cache
# ---------------------------------------------------------------------------

def init_mla(pi: ParamInit, path: str, d_model: int, a: AttentionConfig,
             stack: int = 0) -> None:
    m = a.mla
    H = a.num_heads
    # The reference builds a plain ``wq`` whatever ``q_lora_rank`` is: it
    # has no query-compression weights (repro/models/attention.py:47-62,
    # applied at :547), so neither has the port.
    pi.param(f"{path}/wq", (d_model, H, m.qk_nope_head_dim
                            + m.qk_rope_head_dim),
             ("embed", "heads", "head_dim"), stack=stack)
    pi.param(f"{path}/w_dkv", (d_model, m.kv_lora_rank),
             ("embed", "kv_lora"), stack=stack)
    pi.param(f"{path}/w_krope", (d_model, m.qk_rope_head_dim),
             ("embed", "head_dim"), stack=stack)
    pi.param(f"{path}/kv_norm", (m.kv_lora_rank,), ("kv_lora",),
             init="ones", stack=stack)
    pi.param(f"{path}/w_uk", (m.kv_lora_rank, H, m.qk_nope_head_dim),
             ("kv_lora", "heads", "head_dim"), stack=stack)
    pi.param(f"{path}/w_uv", (m.kv_lora_rank, H, m.v_head_dim),
             ("kv_lora", "heads", "head_dim"), stack=stack)
    pi.param(f"{path}/wo", (H, m.v_head_dim, d_model),
             ("heads", "head_dim", "embed"), stack=stack)


def _rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _mla_latents(p, a: AttentionConfig, x: torch.Tensor,
                 positions: torch.Tensor, inv_freq: Optional[torch.Tensor]):
    """The compressed KV of ``x``: ``c_kv`` (B,S,R) after the ``kv_norm``
    RMS norm, and the roped ``k_rope`` (B,S,Dr) shared by all heads."""
    # the latents whole on every rank of their rows (DTensor would split
    # their rows over "model" as well, a split its backward cannot
    # propagate)
    c_kv = _rms_head_norm(shard(torch.matmul(x, p["w_dkv"]), "batch", "seq",
                                None), p["kv_norm"])
    k_rope = shard(torch.matmul(x, p["w_krope"]), "batch", "seq", None)
    if inv_freq is not None:
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            inv_freq)[:, :, 0, :]
    return c_kv, k_rope


def _mla_query(p, a: AttentionConfig, x: torch.Tensor,
               positions: torch.Tensor, inv_freq: Optional[torch.Tensor]):
    """(q_nope (B,S,H,nope), roped q_rope (B,S,H,rope))."""
    q = _project(x, p["wq"])
    nope = a.mla.qk_nope_head_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    if inv_freq is not None:
        q_rope = apply_rope(q_rope, positions, inv_freq)
    return q_nope, q_rope


def _mla_attend(p, a: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, inv_freq: Optional[torch.Tensor]):
    """Full-sequence MLA over positions 0..S-1: per-head keys and values
    expanded from the latents, attention at score dim nope + rope (scale
    1/sqrt(nope + rope)) and value dim v.  Returns (out (B,S,d), c_kv,
    k_rope) for the callers that write a cache."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_query(p, a, x, positions, inv_freq)
    c_kv, k_rope = _mla_latents(p, a, x, positions, inv_freq)
    k_nope = _project(c_kv, p["w_uk"])
    v = _project(c_kv, p["w_uv"])
    k_rope_h = k_rope[:, :, None, :].expand(B, S, a.num_heads,
                                            k_rope.shape[-1])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    q_full, k_full, v = _shard_qkv(q_full, k_full, v)
    out = _attention(q_full, k_full, v, positions, positions, True, None)
    return _out_proj(out, p["wo"]), c_kv, k_rope


def _mla_scale(a: AttentionConfig) -> float:
    return 1.0 / math.sqrt(a.mla.qk_nope_head_dim + a.mla.qk_rope_head_dim)


def _absorbed(p, a: AttentionConfig, q_c, q_rope, c_kv, k_rope, valid):
    """The JAX module's absorbed decode over gathered latents, step for
    step: q_c (B,1,H,R), q_rope (B,1,H,Dr), c_kv (B,C,R), k_rope (B,C,Dr)
    in the activations' dtype, valid (B,C) -> per-head values
    (B,1,H,v)."""
    return torch.einsum("bshr,rhk->bshk",
                        _absorbed_ctx(a, q_c, q_rope, c_kv, k_rope, valid),
                        p["w_uv"])


def _absorbed_ctx(a: AttentionConfig, q_c, q_rope, c_kv, k_rope, valid):
    """:func:`_absorbed`'s latent context (B,1,H,R), before ``w_uv``."""
    s_nope = torch.einsum("bshr,bcr->bhsc", q_c, c_kv)
    s_rope = torch.einsum("bshr,bcr->bhsc", q_rope, k_rope)
    scores = (s_nope + s_rope).float() * _mla_scale(a)
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhsc,bcr->bshr", probs, c_kv)


def mla_forward(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, inv_freq: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """x (B,S,d), positions 0..S-1 -> (B,S,d)."""
    return _mla_attend(p, a, x, positions, inv_freq)[0]


class MLACache(NamedTuple):
    """Compressed ring cache: ``c_kv`` (B,C,R) latents, ``k_rope``
    (B,C,Dr), ``pos`` (B,C) absolute position of each slot (-1 = empty),
    ``index`` (B,) next write slot of each row (mod C)."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    pos: torch.Tensor
    index: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.c_kv.shape[-2]


def init_mla_cache(batch: int, capacity: int, a: AttentionConfig,
                   dtype=torch.bfloat16,
                   device: Optional[torch.device] = None) -> MLACache:
    m = a.mla
    return MLACache(
        c_kv=torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, capacity, m.qk_rope_head_dim),
                           dtype=dtype, device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device),
        index=torch.zeros((batch,), dtype=torch.int32, device=device))


def mla_prefill(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, length: int, cache: MLACache,
                inv_freq: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, MLACache]:
    """:func:`mla_forward` plus a one-shot ring write of the latents of
    positions ``[0, length)``."""
    out, c_kv, k_rope = _mla_attend(p, a, x, positions, inv_freq)
    slots = prefill_slots(cache.capacity, positions, length)
    _ring_write(cache.c_kv, c_kv, slots)
    _ring_write(cache.k_rope, k_rope, slots)
    _ring_write(cache.pos, positions.to(cache.pos.dtype)[None].expand(
        x.shape[0], -1), slots)
    cache.index.fill_(length)
    return out, cache


def mla_decode(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
               pos: torch.Tensor, cache: MLACache,
               inv_freq: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed single-token decode: the query is projected into latent
    space (``q_c = q_nope . w_uk``) and scored against the compressed
    cache directly.  x (B,1,d); pos () or (B,) absolute position of each
    row; row b writes ring slot ``index[b] % C``.  There is no TPU kernel
    for this step (the JAX module runs einsums), so it is PyTorch ops on
    every device."""
    B = x.shape[0]
    pos = pos.long().expand(B) if pos.dim() == 0 else pos.long()
    q_nope, q_rope = _mla_query(p, a, x, pos[:, None], inv_freq)
    c_new, kr_new = _mla_latents(p, a, x, pos[:, None], inv_freq)
    _write_slot(cache, (c_new[:, 0], kr_new[:, 0], pos),
                cache.index.long() % cache.capacity)
    cache.index.add_(1)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    out = _absorbed(p, a, q_c, q_rope, cache.c_kv.to(x.dtype),
                    cache.k_rope.to(x.dtype), cache.pos >= 0)
    return _out_proj(out, p["wo"]), cache


class PagedMLACache(NamedTuple):
    """Paged compressed-latent cache: ``ckv_pages`` (P+1, page_size, R),
    ``krope_pages`` (P+1, page_size, Dr).  Same scratch-page convention
    as :class:`PagedKVCache`."""
    ckv_pages: torch.Tensor
    krope_pages: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.ckv_pages.shape[-2]


def init_paged_mla_cache(num_pages: int, page_size: int, a: AttentionConfig,
                         dtype=torch.bfloat16,
                         device: Optional[torch.device] = None
                         ) -> PagedMLACache:
    m = a.mla
    return PagedMLACache(
        ckv_pages=torch.zeros((num_pages + 1, page_size, m.kv_lora_rank),
                              dtype=dtype, device=device),
        krope_pages=torch.zeros((num_pages + 1, page_size,
                                 m.qk_rope_head_dim), dtype=dtype,
                                device=device))


def paged_mla_prefill(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                      positions: torch.Tensor, length: int,
                      cache: PagedMLACache, block_tables: torch.Tensor,
                      inv_freq: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, PagedMLACache]:
    """:func:`mla_prefill` math with the latent write paged."""
    out, c_kv, k_rope = _mla_attend(p, a, x, positions, inv_freq)
    num_pages = cache.ckv_pages.shape[0] - 1
    pages, slots = prefill_page_ids(block_tables, positions, length,
                                    cache.page_size, num_pages)
    _page_write(cache.ckv_pages, c_kv, pages, slots)
    _page_write(cache.krope_pages, k_rope, pages, slots)
    return out, cache


def paged_mla_decode(p: Dict[str, Any], a: AttentionConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: PagedMLACache,
                     block_tables: torch.Tensor,
                     inv_freq: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, PagedMLACache]:
    """Absorbed MLA decode over the paged latent cache; ``pos`` (B,) per
    row, token t of row b counting iff t <= pos[b]: the math of
    :func:`mla_decode`.  On the card the scores, softmax and latent
    context are ``ops.paged_mla_decode_attention`` with ``lengths = pos +
    1``; ``w_uv`` and ``wo`` follow."""
    pos = pos.long()
    q_nope, q_rope = _mla_query(p, a, x, pos[:, None], inv_freq)
    c_new, kr_new = _mla_latents(p, a, x, pos[:, None], inv_freq)
    ps = cache.page_size
    bt = block_tables.long()
    pidx = torch.gather(bt, 1, (pos // ps)[:, None])
    slot = (pos % ps)[:, None]
    _page_write(cache.ckv_pages, c_new, pidx, slot)
    _page_write(cache.krope_pages, kr_new, pidx, slot)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    ckv, kr = cache.ckv_pages.to(x.dtype), cache.krope_pages.to(x.dtype)
    ctx = _paged_mla_ctx(a, q_c, q_rope, ckv, kr, block_tables, pos)
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"])
    return _out_proj(out, p["wo"]), cache


def _paged_mla_ctx(a: AttentionConfig, q_c, q_rope, ckv, kr, block_tables,
                   pos):
    """The latent context (B,1,H,R) of one absorbed query a row over the
    rows' latent pages: the paged MLA kernel on the card, a gather then
    :func:`_absorbed_ctx` on the CPU; on DTensors on each rank's rows and
    heads (the latents serve every head)."""
    if sharded.is_dtensor(q_c):
        return sharded.paged(
            lambda qc, qr, cl, kl, bl, pl: _paged_mla_ctx(a, qc, qr, cl, kl,
                                                          bl, pl),
            (q_c, q_rope), (ckv, kr), block_tables, pos, head_pages=False)
    if q_c.is_cuda:
        return ops.paged_mla_decode_attention(
            q_c[:, 0].contiguous(), q_rope[:, 0].contiguous(), ckv, kr,
            block_tables.int().contiguous(), (pos + 1).int(),
            scale=_mla_scale(a))[:, None]
    B, ps = q_c.shape[0], ckv.shape[1]
    bt = block_tables.long()
    C = bt.shape[1] * ps
    valid = torch.arange(C, device=q_c.device)[None, :] <= pos[:, None]
    return _absorbed_ctx(a, q_c, q_rope, ckv[bt].reshape(B, C, -1),
                         kr[bt].reshape(B, C, -1), valid)
