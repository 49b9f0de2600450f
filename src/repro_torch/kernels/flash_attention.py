"""Wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``:
causal (optionally sliding-window) attention, the prefill of both LM
serving engines; without the causal mask also whisper's encoder and,
over a key length of its own, its cross attention.  Counterpart of
``repro/kernels/flash_attention.py``.

A CPU tensor takes the plain version (:func:`ref.flash_attention_ref`);
a CUDA tensor launches the kernel or raises.

Which instance serves which rows (:func:`instance`):

- bf16 whose rows are whole 16-byte pieces (D and Dv multiples of 8) and
  whose q, k and v start on 16 bytes, which is every main path: the TMA
  instance, grid (S, units, row tiles).  A block is a producer warp that
  loads K/V tiles by TMA into a ring and two consumer warpgroups of 64
  query rows each that share every tile: under GQA with G = BH / BHkv
  even, the same 64 rows of two query heads of one kv head (a unit is a
  pair of heads); else 128 rows of one head.  Where those blocks leave
  SMs idle, :func:`flash_splits` splits each block's walk over the keys
  into S chunks, a block each, whose fp32 statistics a second kernel
  merges: S from the shapes alone, S = 1 runs without scratch or merge.
- other bf16 rows (D or Dv no multiple of 8, or an unaligned view): one
  warpgroup a (bh, 64-row query tile), grid (BH, ceil(T / 64)), its
  tiles stored element by element; never split.
- fp32 (the parity cuts): CUDA cores, grid (BH, ceil(T / 32)); never
  split.

A call adds one to ``flash_attention.launches`` whatever S is, and one
more to ``flash_attention.merges`` where it also launched the merge."""
from __future__ import annotations

import functools

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import head_dims, kernel_inputs
from repro_torch.kernels import fedavg_reduce as fr

#: a walk of at most this many 64-key tiles is not split: the serving
#: prefills (T 64: one tile) and the expert-parallel rank's T 256 (four)
SPLIT_MIN_WALK = 4
#: fewest key tiles a chunk of a split walk holds
SPLIT_MIN_CHUNK = 2


def instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """"tma" or "wgmma": the bf16 instance the kernel's entry point runs
    for these tensors (the fp32 entry has one)."""
    D, Dv = q.shape[-1], v.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "tma" if D % 8 == 0 and Dv % 8 == 0 and aligned else "wgmma"


def paired(BH: int, BHkv: int) -> bool:
    """Whether a TMA block's two consumers take two query heads of one kv
    head (G even) rather than two row tiles of one head."""
    return (BH // BHkv) % 2 == 0


def blocks_per_sm(D: int, Dv: int) -> int:
    """TMA blocks an SM holds (``csrc/flash_attention.cu``
    ``tma_blocks_per_sm`` and its shared-memory budget): two at Dv <= 64
    with D <= 128, else one."""
    return 2 if Dv <= 64 and D <= 128 else 1


@functools.lru_cache(maxsize=None)
def flash_splits(BH: int, BHkv: int, T: int, Tk: int, causal: bool,
                 window: int, D: int, Dv: int, sms: int) -> int:
    """Chunks S each block's walk over the keys is split into, from
    shapes alone (``window`` as the kernel takes it: 0, or in 1..T-1).

    The TMA instance's blocks are ``units`` (query heads, or pairs of
    them) times row tiles (64 rows paired, else 128), each walking the
    key tiles ``ref.flash_walk`` gives, :func:`blocks_per_sm` of them on
    each of the ``sms`` SMs at once.  S = 1 where they fill those block
    slots or no walk is longer than :data:`SPLIT_MIN_WALK` tiles.  Else
    a time is modelled in key-tile steps of a block: unsplit, the
    longest walk; split into S, the waves of non-empty chunk blocks
    times one step more than the longest chunk (a chunk block's start
    and its output), plus the partial statistics written and read back
    by the merge, in steps of one K/V tile's bytes on every block slot.
    S is the first that minimises it, with chunks of at least
    :data:`SPLIT_MIN_CHUNK` tiles and at most four waves of chunk blocks
    (the scratch grows with S)."""
    units = BH // 2 if paired(BH, BHkv) else BH
    rows = 64 if paired(BH, BHkv) else 128
    slots = sms * blocks_per_sm(D, Dv)
    walks = [e - f for f, e in (ref.flash_walk(r, min(T, r + rows), Tk,
                                               causal, window)
                                for r in range(0, T, rows))]
    base, longest = units * len(walks), max(walks, default=0)
    if base >= slots or longest <= SPLIT_MIN_WALK:
        return 1
    best, best_cost = 1, longest   # one wave of whole walks
    step_bytes = 2 * 64 * (D + Dv)
    for S in range(2, min(-(-longest // SPLIT_MIN_CHUNK),
                          4 * slots // base) + 1):
        blocks = units * sum(-(-w // -(-w // S)) for w in walks)
        merge = 8 * S * BH * T * Dv / (slots * step_bytes)
        cost = -(-blocks // slots) * (-(-longest // S) + 1) + merge
        if cost < best_cost:
            best, best_cost = S, cost
    return best


def splits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int) -> int:
    """S of a call of these tensors (1 but for the bf16 TMA instance);
    ``window`` as the kernel takes it."""
    if q.dtype != torch.bfloat16 or instance(q, k, v) != "tma":
        return 1
    return flash_splits(q.shape[0], k.shape[0], q.shape[1], k.shape[1],
                        bool(causal), window, q.shape[2], v.shape[2],
                        fr.sms(q.device.index))


def scratch(S: int, BH: int, T: int, Dv: int, device) -> torch.Tensor:
    """fp32 scratch of an S-chunk split (none for S = 1): o (S, BH, T,
    Dv), then m and l (S, BH, T)."""
    return torch.empty((S * BH * T * (Dv + 2),) if S > 1 else (0,),
                       dtype=torch.float32, device=device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH,T,D); k/v (BHkv,Tk,D) -> (BH,T,Dv) in q's dtype, queries at
    positions 0..T-1 and keys at 0..Tk-1.  BHkv = BH and Tk = T is the
    JAX signature; a GQA caller may instead pass each kv head once (BHkv
    dividing BH, query row bh reads kv row bh // (BH // BHkv)), and a
    call without the causal mask may give the keys a length of their own
    (cross attention; the JAX kernel asserts one T).  ``window <= 0``
    means no window; any T.  The kernel takes D and Dv up to 256 (MLA
    prefill: D 192, Dv 128; gemma3: D = Dv = 256)."""
    dev = common_device(q, k, v)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH,T,D) q, k and v")
    BH, T, D = q.shape
    BHkv, Tk, Dv = k.shape[0], k.shape[1], v.shape[2]
    if (tuple(k.shape) != (BHkv, Tk, D) or tuple(v.shape[:2]) != (BHkv, Tk)
            or BHkv == 0 or BH % BHkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if Tk != T and (causal or Tk == 0):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"do not agree: a key length of its own ({Tk} "
                         f"keys for {T} queries) needs causal=False and at "
                         "least one key")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    suffix = kernel_inputs("flash_attention", q=q, k=k, v=v)
    head_dims("flash_attention", D, Dv)
    # a window that reaches past every key is no window (and the kernel
    # then never forms q_pos - window)
    win = int(window) if 0 < window < T else 0

    def launch(q, k, v):
        out = torch.empty((BH, T, Dv), dtype=q.dtype, device=dev)
        if BH == 0 or T == 0:
            return out
        shapes = (BH, BHkv, T, Tk, D, Dv, int(bool(causal)), win)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if suffix == "f32":
                build.launch("flash_attention_f32", q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             *shapes, stream)
                S = 1
            else:
                S = splits(q, k, v, causal, win)
                work = scratch(S, BH, T, Dv, dev)
                build.launch("flash_attention_bf16", q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             work.data_ptr(), *shapes, S, stream)
        flash_attention.launches += 1
        flash_attention.merges += S > 1
        return out

    return with_grad(launch, lambda q, k, v: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), q, k, v)


flash_attention.launches = 0
flash_attention.merges = 0
