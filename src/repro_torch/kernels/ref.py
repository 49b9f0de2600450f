"""Plain PyTorch versions of the port's kernels, the counterparts of
``repro/kernels/ref.py``.

The wrappers in this package run these for tensors on the CPU, and
``chip_smoke.py`` holds every kernel against them on the card.
:func:`decode_attention_partial_ref` is the plain version of the dense
decode kernel's partial-statistics instance: a cache split along its
slots over ranks, merged across them (``models/sharded.py``), is the
reference's XLA partitioning, not one of its kernels."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

#: mask value of the JAX kernels and their oracles (``kernels/ref.py``)
NEG_INF = -1e30


def gru_seq_ref(xw: torch.Tensor, h0: torch.Tensor,
                w_h: torch.Tensor) -> torch.Tensor:
    """Fused-gate GRU over time: xw (B,T,3h) = x@w_x+b precomputed;
    h0 (B,h); w_h (h,3h).  Returns (B,T,h)."""
    h = h0
    outs = []
    for t in range(xw.shape[1]):
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        outs.append(h)
    if not outs:
        return xw.new_empty((xw.shape[0], 0, h0.shape[-1]))
    return torch.stack(outs, dim=1)


def fedavg_reduce_ref(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, N); weights (C,) -> (N,) weighted average, summed in
    float32 and returned in the dtype of ``stacked``."""
    w = (weights / weights.sum()).float()
    return (w[:, None] * stacked.float()).sum(dim=0).to(stacked.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (BH,T,D); k/v (BHkv,Tk,D) with BHkv dividing BH (query row bh
    reads kv row bh // G, G = BH/BHkv; G = 1 and Tk = T is the JAX
    signature) -> (BH,T,Dv) in q's dtype: queries at positions 0..T-1,
    keys at 0..Tk-1.  ``window <= 0`` means no window."""
    G = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(G, dim=0)
    v = v.repeat_interleave(G, dim=0)
    T, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    d = (torch.arange(T, device=q.device)[:, None]
         - torch.arange(Tk, device=q.device)[None, :])
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, *,
                         soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,D); k/v (B,C,Hkv,D); valid (B,C) bool -> (B,H,Dv).  With
    ``soft_cap`` the scores are capped before the mask, as in
    :func:`paged_decode_attention_ref` (the JAX oracle has no cap: at 0
    this is it).  Computed in fp32, or in fp64 for fp64 inputs (an exact
    witness for long fp32 rows, whose fp32 sums over thousands of slots
    carry more rounding than a 3e-5 check allows)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bchd->bhgc", qg.to(ct), k.to(ct)) \
        / math.sqrt(D)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.to(ct))
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


#: mask value of the partial statistics: the model's fp32-safe mask
#: (``models/attention.py``), far below the kernels' -1e30, so that a
#: share of the slots with none valid weighs nothing in a merge with one
#: that has some
PARTIAL_NEG_INF = -2.0e38


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, valid: torch.Tensor, *,
                                 soft_cap: float = 0.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """:func:`decode_attention_ref` over one share of the slots, left
    unnormalised: (sum over slots of exp(s - m) . v (B,H,Dv), the row max
    m (B,H), the row sum of exp(s - m) (B,H)), all fp32.  Invalid slots
    score :data:`PARTIAL_NEG_INF`, so a row with no valid slot gives m =
    -2e38, the sum C and the sum of V; with no slot at all, m = -2e38 and
    zeros.  Shares merge as m* = max m, o = sum o exp(m - m*) / sum l
    exp(m - m*)."""
    B, H, D = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if C == 0:
        return (q.new_zeros((B, H, Dv), dtype=torch.float32),
                q.new_full((B, H), PARTIAL_NEG_INF, dtype=torch.float32),
                q.new_zeros((B, H), dtype=torch.float32))
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bchd->bhgc", qg.float(), k.float()) \
        / math.sqrt(D)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    s = torch.where(valid[:, None, None, :], s, PARTIAL_NEG_INF)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bhgc,bchd->bhgd", e, v.float())
    return o.reshape(B, H, Dv), m.reshape(B, H), e.sum(-1).reshape(B, H)


def walk_chunks(first: int, last: int, S: int) -> List[Tuple[int, int]]:
    """The S chunks [begin, end) of a row's walk [first, last) that the
    GQA decode kernels give their blocks (``csrc/decode_rows.cuh``
    ``walk_chunk``): round_up(ceil((last - first) / S), 32) slots each,
    from ``first`` on; trailing chunks may be empty."""
    size = -(-max(last - first, 0) // S)
    size = -(-size // 32) * 32
    out = []
    for c in range(S):
        begin = min(last, first + c * size)
        out.append((begin, min(last, begin + size)))
    return out


#: keys a tile of the flash kernel's walk (``csrc/flash_attention.cu``)
FLASH_TILE = 64


def flash_walk(row0: int, row1: int, Tk: int, causal: bool,
               window: int) -> Tuple[int, int]:
    """The 64-key tiles [first, end) that query rows [row0, row1) of
    the flash kernel can see: from the tile of the first row's window
    start (0 without a window) to the tile of the last row's diagonal
    (every key without the causal mask)."""
    lo = max(0, row0 - window + 1) if window > 0 else 0
    hi = min(Tk, row1) if causal else Tk
    return lo // FLASH_TILE, -(-hi // FLASH_TILE)


def flash_chunks(first: int, end: int, S: int) -> List[Tuple[int, int]]:
    """The S chunks [begin, end) of a walk over key tiles [first, end)
    that the flash kernel's split gives its blocks: ceil(walk / S) whole
    tiles each, from ``first`` on; trailing chunks may be empty."""
    per = -(-max(end - first, 0) // S)
    out = []
    for c in range(S):
        begin = min(end, first + c * per)
        out.append((begin, min(end, begin + per)))
    return out


def flash_split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         S: int, *, rows: int, causal: bool = True,
                         window: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The plain model of the flash kernel's split: the query rows in
    blocks of ``rows`` (64 when two heads share a block, 128 when two
    row tiles do), each block's walk (:func:`flash_walk`) in S chunks
    (:func:`flash_chunks`), and for each chunk every row's fp32 (o, m,
    l) over the chunk's keys as the kernel reports them: o = sum exp(s -
    m) v, m the row max of the scaled scores, l = sum exp(s - m).  A row
    with no visible key in its chunk, and every row of an empty chunk,
    gives (0, :data:`PARTIAL_NEG_INF`, 0).  Returns o (S,BH,T,Dv), m and
    l (S,BH,T), for :func:`combine_partials`."""
    G = q.shape[0] // k.shape[0]
    BH, T, D = q.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    ct = torch.promote_types(q.dtype, torch.float32)
    kx, vx = (x.repeat_interleave(G, dim=0).to(ct) for x in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.to(ct), kx) / math.sqrt(D)
    d = (torch.arange(T, device=q.device)[:, None]
         - torch.arange(Tk, device=q.device)[None, :])
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    o = q.new_zeros((S, BH, T, Dv), dtype=ct)
    m = q.new_full((S, BH, T), PARTIAL_NEG_INF, dtype=ct)
    l = q.new_zeros((S, BH, T), dtype=ct)
    for r0 in range(0, T, rows):
        r1 = min(T, r0 + rows)
        for c, (b, e) in enumerate(flash_chunks(
                *flash_walk(r0, r1, Tk, causal, window), S)):
            lo, hi = b * FLASH_TILE, min(Tk, e * FLASH_TILE)
            if hi <= lo:
                continue
            seen = mask[r0:r1, lo:hi]
            sc = torch.where(seen, s[:, r0:r1, lo:hi], PARTIAL_NEG_INF)
            top = sc.amax(-1)
            w = torch.exp(sc - top[..., None]) * seen
            has = seen.any(-1)
            o[c, :, r0:r1] = torch.einsum("bqk,bkd->bqd", w, vx[:, lo:hi])
            m[c, :, r0:r1] = torch.where(has, top, PARTIAL_NEG_INF)
            l[c, :, r0:r1] = w.sum(-1)
    return o, m, l


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge partial softmax statistics over their leading dim (the
    chunks of a split walk, or ranks' shares of the slots): o (S,...,Dv),
    m and l (S,...) -> (sum o e^(m - m*), m*, sum l e^(m - m*)) with m* =
    max m.  o / l of the result is the attention over all the parts; a
    part with m = :data:`PARTIAL_NEG_INF` weighs nothing beside one with
    a counted slot, and where every part has that m each weighs 1."""
    top = m.amax(0)
    w = torch.exp(m - top)
    return (o * w[..., None]).sum(0), top, (l * w).sum(0)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               soft_cap: float = 0.0,
                               window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D); k/v_pages (P, ps, Hkv, D); block_tables (B, Pseq) page
    ids; lengths (B,) -> (B,H,Dv).  Gathers each row's pages into a
    contiguous view and masks logical token t of row b unless
    ``t < lengths[b]`` (and ``lengths[b]-1-t < window``)."""
    B, H, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    C = block_tables.shape[1] * ps
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, C, Hkv, D)
    v = v_pages[bt].reshape(B, C, Hkv, v_pages.shape[-1])
    tok = torch.arange(C, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = tok < ln
    if window is not None:
        valid &= (ln - 1 - tok) < window
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bchd->bhgc", qg.float(), k.float()) \
        / math.sqrt(D)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def paged_mla_decode_attention_ref(q_c: torch.Tensor, q_rope: torch.Tensor,
                                   ckv_pages: torch.Tensor,
                                   krope_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   lengths: torch.Tensor, *,
                                   scale: float) -> torch.Tensor:
    """Absorbed-MLA paged decode: q_c (B,H,R) latent-space queries;
    q_rope (B,H,Dr); ckv/krope_pages (P, ps, R|Dr); block_tables (B,
    Pseq); lengths (B,) -> latent context (B,H,R) in q_c's dtype.  Scores
    are ``(q_c . c_kv + q_rope . k_rope) * scale`` (``scale`` the full
    1/sqrt(nope + rope)); token t of row b counts iff t < lengths[b]."""
    B, H, R = q_c.shape
    ps = ckv_pages.shape[1]
    C = block_tables.shape[1] * ps
    bt = block_tables.long()
    ckv = ckv_pages[bt].reshape(B, C, R).float()
    kr = krope_pages[bt].reshape(B, C, krope_pages.shape[-1]).float()
    valid = torch.arange(C, device=q_c.device)[None, :] \
        < lengths.long()[:, None]
    s = (torch.einsum("bhr,bcr->bhc", q_c.float(), ckv)
         + torch.einsum("bhd,bcd->bhc", q_rope.float(), kr)) * scale
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhc,bcr->bhr", p, ckv).to(q_c.dtype)


def topk_router_ref(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T,E) -> (weights (T,k) f32, idx (T,k) int32): the fp32
    softmax over experts, then ``k`` rounds of argmax with the winner
    masked to -1, as the TPU kernel picks them.  A tie goes to the lowest
    index (``torch.argmax`` returns the first maximum; ``torch.topk``
    promises no order among equal values)."""
    x = logits.float()
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    cur = e / e.sum(dim=-1, keepdim=True)
    ws, ids = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        ws.append(torch.gather(cur, -1, i))
        ids.append(i)
        cur = cur.scatter(-1, i, -1.0)
    return torch.cat(ws, dim=-1), torch.cat(ids, dim=-1).int()


def mamba_chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; Bm/Cm
    (B,L,N) (ngroups 1) -> (y (B,L,H,P) in x's dtype, final state
    (B,H,N,P) fp32).  Delegates to the model's plain SSD scan with a
    group axis of 1, as ``repro/kernels/ref.py`` delegates to the XLA
    path."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, Bm[:, :, None, :], Cm[:, :, None, :], chunk)
