"""Wrappers of the hand-written CUDA kernels
``csrc/paged_decode_attention.cu`` (GQA) and
``csrc/paged_mla_decode_attention.cu`` (absorbed MLA): one query token
per sequence against a paged cache read through block tables, the paged
engine's decode step.  Counterpart of
``repro/kernels/paged_decode_attention.py``, which holds both variants.

A CPU tensor takes the plain version
(:func:`ref.paged_decode_attention_ref`,
:func:`ref.paged_mla_decode_attention_ref`); a CUDA tensor launches the
kernel or raises.  With grad on, the kernel's output is differentiable
through the plain version (``kernels/_grad.py``).

A row with ``lengths[b] = 0`` has no counted token: every score is
-1e30 in the JAX kernels, so they, the plain versions and the kernels
here give the uniform mean of V (of the ``c_kv`` latents) over all
``Pseq * ps`` gathered slots of the row, reading every table entry of
that row.

The GQA kernel splits a long row's walk over blocks as the dense one does
(``decode_attention.decode_splits``), sized from the longest walk a row
can have: every ``Pseq * ps`` slot, or with a window
``round_up(window, 32) + 32`` of them (a walk starts at the window of its
first counted token)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels._checks import head_dims, kernel_inputs
from repro_torch.kernels._grad import with_grad

#: most block-table entries a row may have: the kernels stage a row's
#: entries in shared memory
MAX_PAGES_PER_SEQ = 16384


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, soft_cap: float = 0.0,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D); k/v_pages (P, ps, Hkv, D); block_tables (B, Pseq) int32
    page ids; lengths (B,) int32 valid tokens -> (B,H,Dv).  The kernel
    reads only the table entries of a row's counted tokens (every entry
    of a row with ``lengths[b] = 0``), and the ids there must lie in the
    pool (it does not check them)."""
    dev = common_device(q, k_pages, v_pages, block_tables, lengths)
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("paged_decode_attention takes q (B,H,D) and "
                         "k/v_pages (P,ps,Hkv,D)")
    B, H, D = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    Dv = v_pages.shape[3]
    if (k_pages.shape[3] != D or tuple(v_pages.shape[:3]) != (P, ps, Hkv)
            or block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(lengths.shape) != (B,) or Hkv == 0 or H % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, "
                         f"block_tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not agree")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if soft_cap < 0:
        raise ValueError(f"soft_cap must be >= 0, got {soft_cap}")
    if dev.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, soft_cap=soft_cap,
            window=window)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, "
                         f"not {dev}")
    suffix = kernel_inputs("paged_decode_attention", q=q, k_pages=k_pages,
                           v_pages=v_pages, block_tables=block_tables,
                           lengths=lengths)
    head_dims("paged_decode_attention", D, Dv)
    Pseq = _pages_per_seq("paged_decode_attention", block_tables)
    # a window at least as long as the table reaches every token
    win = int(window) if window is not None and window < Pseq * ps else 0

    def launch(q, k_pages, v_pages, block_tables, lengths):
        out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
        if B == 0 or H == 0:
            return out
        S = splits(B, H, Hkv, ps, Pseq, D, Dv, win, dev)
        work = da.scratch(S, B, H, Dv, dev)
        with torch.cuda.device(dev):
            build.launch(f"paged_decode_attention_{suffix}", q.data_ptr(),
                         k_pages.data_ptr(), v_pages.data_ptr(),
                         block_tables.data_ptr(), lengths.data_ptr(),
                         out.data_ptr(), work.data_ptr(), B, H, Hkv, ps,
                         Pseq, D, Dv, S, float(soft_cap), win,
                         torch.cuda.current_stream().cuda_stream)
        paged_decode_attention.launches += 1
        return out

    return with_grad(launch, lambda *t: ref.paged_decode_attention_ref(
        *t, soft_cap=soft_cap, window=window), q, k_pages, v_pages,
        block_tables, lengths)


paged_decode_attention.launches = 0


def longest_walk(ps: int, Pseq: int, window: int) -> int:
    """Slots the longest walk of a row of ``Pseq`` pages of ``ps`` takes:
    every slot, or with a window (0: none) the tokens from the 32-slot
    window of its first counted one, at most window + 31."""
    slots = Pseq * ps
    if not window:
        return slots
    return min(-(-window // 32) * 32 + 32, slots)


def splits(B: int, H: int, Hkv: int, ps: int, Pseq: int, D: int, Dv: int,
           window: int, device: torch.device) -> int:
    """S of a paged GQA decode call of these shapes on ``device``
    (``window`` 0: none)."""
    G = H // Hkv
    return da.decode_splits(B, Hkv, G, da.heads_per_block(G, D, Dv),
                            longest_walk(ps, Pseq, window),
                            fr.sms(device.index), warps=da.PAGED_WARPS)


def _pages_per_seq(name: str, block_tables: torch.Tensor) -> int:
    Pseq = block_tables.shape[1]
    if Pseq > MAX_PAGES_PER_SEQ:
        raise ValueError(f"{name} kernel takes at most {MAX_PAGES_PER_SEQ} "
                         f"block-table entries a row, got {Pseq}")
    return Pseq


#: largest latent rank R of the MLA kernel (16 accumulators a lane) and
#: largest R + Dr (16 query rows and 16 tokens of it in shared memory)
MAX_RANK = 512
MAX_LATENT_WIDTH = 1024


def paged_mla_decode_attention(q_c: torch.Tensor, q_rope: torch.Tensor,
                               ckv_pages: torch.Tensor,
                               krope_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               scale: float) -> torch.Tensor:
    """Absorbed-MLA paged decode.  q_c (B,H,R) latent-space queries;
    q_rope (B,H,Dr); ckv/krope_pages (P, ps, R|Dr); block_tables (B,
    Pseq) int32; lengths (B,) int32 valid tokens; ``scale`` the full
    1/sqrt(nope + rope).  Returns the latent context (B,H,R) in q_c's
    dtype (apply ``w_uv`` outside).  The kernel reads only the table
    entries of a row's first ceil(lengths[b] / ps) pages (every entry of
    a row with ``lengths[b] = 0``), whose ids must lie in the pool.  One
    call is one launch."""
    dev = common_device(q_c, q_rope, ckv_pages, krope_pages, block_tables,
                        lengths)
    if q_c.dim() != 3 or q_rope.dim() != 3 or ckv_pages.dim() != 3 \
            or krope_pages.dim() != 3:
        raise ValueError("paged_mla_decode_attention takes q_c (B,H,R), "
                         "q_rope (B,H,Dr) and ckv/krope_pages (P,ps,R|Dr)")
    B, H, R = q_c.shape
    Dr = q_rope.shape[2]
    P, ps = ckv_pages.shape[:2]
    if (tuple(q_rope.shape[:2]) != (B, H) or ckv_pages.shape[2] != R
            or tuple(krope_pages.shape) != (P, ps, Dr)
            or block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"shapes q_c {tuple(q_c.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, pages "
                         f"{tuple(ckv_pages.shape)} / "
                         f"{tuple(krope_pages.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not agree")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if dev.type == "cpu":
        return ref.paged_mla_decode_attention_ref(
            q_c, q_rope, ckv_pages, krope_pages, block_tables, lengths,
            scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged_mla_decode_attention runs on cpu or cuda, "
                         f"not {dev}")
    suffix = kernel_inputs("paged_mla_decode_attention", q_c=q_c,
                           q_rope=q_rope, ckv_pages=ckv_pages,
                           krope_pages=krope_pages,
                           block_tables=block_tables, lengths=lengths)
    if not 1 <= R <= MAX_RANK or R + Dr > MAX_LATENT_WIDTH:
        raise ValueError(f"paged_mla_decode_attention kernel takes R in "
                         f"1..{MAX_RANK} and R + Dr <= {MAX_LATENT_WIDTH}, "
                         f"got R={R}, Dr={Dr}")
    Pseq = _pages_per_seq("paged_mla_decode_attention", block_tables)

    def launch(q_c, q_rope, ckv_pages, krope_pages, block_tables, lengths):
        out = torch.empty((B, H, R), dtype=q_c.dtype, device=dev)
        if B == 0 or H == 0:
            return out
        with torch.cuda.device(dev):
            build.launch(f"paged_mla_decode_attention_{suffix}",
                         q_c.data_ptr(), q_rope.data_ptr(),
                         ckv_pages.data_ptr(), krope_pages.data_ptr(),
                         block_tables.data_ptr(), lengths.data_ptr(),
                         out.data_ptr(), B, H, R, Dr, ps, Pseq, float(scale),
                         torch.cuda.current_stream().cuda_stream)
        paged_mla_decode_attention.launches += 1
        return out

    return with_grad(launch, lambda *t: ref.paged_mla_decode_attention_ref(
        *t, scale=scale), q_c, q_rope, ckv_pages, krope_pages, block_tables,
        lengths)


paged_mla_decode_attention.launches = 0
