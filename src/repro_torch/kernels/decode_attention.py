"""Wrapper of the hand-written CUDA kernel ``csrc/decode_attention.cu``:
one query token per sequence against a contiguous KV cache, the dense
engine's decode step.  Counterpart of ``repro/kernels/decode_attention.py``.
:func:`decode_attention_partial` is the same kernel over one rank's
share of a cache split along its slots, returning the partial softmax
statistics that ``models/sharded.py`` merges across the ranks.

A CPU tensor takes the plain version (:func:`ref.decode_attention_ref`,
:func:`ref.decode_attention_partial_ref`); a CUDA tensor launches the
kernel or raises.

The signature departs from the JAX kernel's by one keyword,
``soft_cap``, which the paged kernel of both packages already takes.  It
exists for parity with ``repro/models/attention.py``'s ``gqa_decode``,
which caps a config's decode scores (``logit_soft_cap``) through XLA; the
JAX models never call their own kernels, so the port's kernel takes what
the port's model needs.  No registered config sets a cap (gemma3-1b's is
0); the tests set one.

A long row's walk is split over blocks: :func:`decode_splits` picks the
number of chunks S from the shapes alone (never from ``valid`` or
``lengths``, which live on the device), the kernel walks each chunk in a
block of its own and a second kernel, launched behind it by the same
entry point, merges the chunks' statistics (``csrc/decode_rows.cuh``).
A call adds one to its wrapper's ``launches`` whatever S is; with S > 1
it takes an fp32 scratch of S * B * H * (Dv + 2) floats from the caching
allocator (``torch.empty`` on the current stream, so CUDA-graph capture
holds)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import head_dims, kernel_inputs
from repro_torch.kernels import fedavg_reduce as fr

#: a walk of at most this many slots is not split: the serving tiers'
#: caches (256 ring slots; 16 pages of 16 tokens) stay one block a (row,
#: kv head, head group); their rows hold 57-64 tokens, two windows, so a
#: split would read nothing more at once and add the merge (and the dense
#: kernel's 8 warps already take one window each of 256 slots)
SPLIT_MIN_WALK = 256
#: fewest slots a chunk of a split walk holds
SPLIT_MIN_CHUNK = 64
#: warps a block of the dense kernel (``csrc/decode_attention.cu``) and
#: of the paged one (``csrc/paged_decode_attention.cu``)
DENSE_WARPS, PAGED_WARPS = 8, 2


def heads_per_block(G: int, D: int, Dv: int) -> int:
    """Query heads of one kv head that a block of either GQA decode kernel
    takes (``decode_rows.cuh`` ``decode_dispatch_group``): one at rows
    wider than 128, all of G = 1, 8 at D, Dv <= 64 and G > 4, else 4."""
    if D > 128 or Dv > 128 or G == 1:
        return 1
    return 8 if D <= 64 and Dv <= 64 and G > 4 else 4


def decode_splits(B: int, Hkv: int, G: int, kGB: int, walk: int, sms: int,
                  warps: int = DENSE_WARPS) -> int:
    """Chunks S a row's walk is split into, from shapes alone.  ``walk``
    is the longest walk a row of the call can have, ``sms`` the card's
    SM count, ``warps`` a block's.  The rows and heads give Hkv * B *
    ceil(G / kGB) blocks; S = 1 where they fill the SMs or the walk is
    at most :data:`SPLIT_MIN_WALK` slots.  Else a chunk is enough whole
    32-slot windows that the blocks stay within two for each SM (at most
    two waves of the largest blocks, which fit one an SM; one wave of the
    dense kernel's at D 64, which fit two), but no fewer than
    :data:`SPLIT_MIN_CHUNK` slots or one window for each of a block's
    warps, and S = ceil(walk / chunk).  The device makes each row's chunk
    round_up(ceil(row walk / S), 32) slots, at most that chunk."""
    base = Hkv * B * -(-G // kGB)
    if base == 0 or base >= sms or walk <= SPLIT_MIN_WALK:
        return 1
    per = -(-walk // (2 * sms // base))   # slots a chunk at 2 blocks an SM
    chunk = max(SPLIT_MIN_CHUNK, 32 * warps, -(-per // 32) * 32)
    return -(-walk // chunk)


def splits(B: int, H: int, Hkv: int, C: int, D: int, Dv: int,
           device: torch.device) -> int:
    """S of a dense decode call of these shapes on ``device``."""
    return decode_splits(B, Hkv, H // Hkv, heads_per_block(H // Hkv, D, Dv),
                         C, fr.sms(device.index))


def scratch(S: int, B: int, H: int, Dv: int, device) -> torch.Tensor:
    """fp32 scratch of an S-chunk split (none for S = 1): (S, B, H) rows
    of o (Dv), then m and l."""
    return torch.empty((S * B * H * (Dv + 2),) if S > 1 else (0,),
                       dtype=torch.float32, device=device)


def _check(name, q, k, v, valid, soft_cap):
    """The shapes (B, H, Hkv, C, D, Dv) of a decode call, after its
    argument checks."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes q (B,H,D), k/v (B,C,Hkv,D)")
    B, H, D = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(k.shape) != (B, C, Hkv, D) or tuple(v.shape[:3]) != (B, C, Hkv)
            or tuple(valid.shape) != (B, C) or Hkv == 0 or H % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, valid {tuple(valid.shape)} "
                         "do not agree")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    if soft_cap < 0:
        raise ValueError(f"soft_cap must be >= 0, got {soft_cap}")
    return B, H, Hkv, C, D, Dv


def _kernel_suffix(name, dev, q, k, v, valid, D, Dv) -> str:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    suffix = kernel_inputs(name, q=q, k=k, v=v, valid=valid)
    head_dims(name, D, Dv)
    return suffix


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,D); k/v (B,C,Hkv,D); valid (B,C) bool -> (B,H,Dv).  With
    ``soft_cap`` > 0 each score s becomes tanh(s / cap) * cap before the
    mask.  D and Dv up to 256."""
    dev = common_device(q, k, v, valid)
    B, H, Hkv, C, D, Dv = _check("decode_attention", q, k, v, valid,
                                 soft_cap)
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, soft_cap=soft_cap)
    suffix = _kernel_suffix("decode_attention", dev, q, k, v, valid, D, Dv)

    def launch(q, k, v, valid):
        out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
        if B == 0 or H == 0 or C == 0:
            return out.zero_()
        S = splits(B, H, Hkv, C, D, Dv, dev)
        work = scratch(S, B, H, Dv, dev)
        with torch.cuda.device(dev):
            build.launch(f"decode_attention_{suffix}", q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                         out.data_ptr(), work.data_ptr(), B, H, Hkv, C, D,
                         Dv, S, float(soft_cap),
                         torch.cuda.current_stream().cuda_stream)
        decode_attention.launches += 1
        return out

    return with_grad(launch, lambda *t: ref.decode_attention_ref(
        *t, soft_cap=soft_cap), q, k, v, valid)


decode_attention.launches = 0


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             soft_cap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`decode_attention` over one share of a row's slots, left
    unnormalised: (o (B,H,Dv), m (B,H), l (B,H)), all fp32, where m is
    the row max of the scores, l the sum of exp(s - m) and o the sum of
    exp(s - m) . v.  A row with no valid slot gives m = -2e38
    (:data:`ref.PARTIAL_NEG_INF`), l = C and o = the sum of V, so that
    shares merged as m* = max m, sum o e^(m - m*) / sum l e^(m - m*)
    give :func:`decode_attention` over all the slots."""
    dev = common_device(q, k, v, valid)
    B, H, Hkv, C, D, Dv = _check("decode_attention_partial", q, k, v, valid,
                                 soft_cap)
    if dev.type == "cpu":
        return ref.decode_attention_partial_ref(q, k, v, valid,
                                                soft_cap=soft_cap)
    suffix = _kernel_suffix("decode_attention_partial", dev, q, k, v, valid,
                            D, Dv)

    def launch(q, k, v, valid):
        f32 = dict(dtype=torch.float32, device=dev)
        o, m, l = (torch.empty((B, H, Dv), **f32), torch.empty((B, H), **f32),
                   torch.empty((B, H), **f32))
        if B == 0 or H == 0 or C == 0:
            return o.zero_(), m.fill_(ref.PARTIAL_NEG_INF), l.zero_()
        S = splits(B, H, Hkv, C, D, Dv, dev)
        work = scratch(S, B, H, Dv, dev)
        with torch.cuda.device(dev):
            build.launch(f"decode_attention_partial_{suffix}", q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                         o.data_ptr(), m.data_ptr(), l.data_ptr(),
                         work.data_ptr(), B, H, Hkv, C, D, Dv, S,
                         float(soft_cap),
                         torch.cuda.current_stream().cuda_stream)
        decode_attention_partial.launches += 1
        return o, m, l

    return with_grad(launch, lambda *t: ref.decode_attention_partial_ref(
        *t, soft_cap=soft_cap), q, k, v, valid)


decode_attention_partial.launches = 0
