"""Wrapper of the hand-written CUDA kernel
``csrc/paged_decode_attention.cu``: one query token per sequence against
a paged KV cache read through block tables, the paged engine's decode
step.  Counterpart of ``repro/kernels/paged_decode_attention.py``
(the GQA variant; the MLA variant waits for its slice, ROADMAP.md).

A CPU tensor takes the plain version
(:func:`ref.paged_decode_attention_ref`); a CUDA tensor launches the
kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import head_dims, kernel_inputs


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, soft_cap: float = 0.0,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D); k/v_pages (P, ps, Hkv, D); block_tables (B, Pseq) int32
    page ids; lengths (B,) int32 valid tokens -> (B,H,Dv).  The kernel
    reads only a row's first ceil(lengths[b] / ps) table entries, and
    the ids there must lie in the pool (it does not check them)."""
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
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
    if B == 0 or H == 0:
        return out
    Pseq = block_tables.shape[1]
    # a window at least as long as the table reaches every token
    win = int(window) if window is not None and window < Pseq * ps else 0
    with torch.cuda.device(dev):
        build.launch(f"paged_decode_attention_{suffix}", q.data_ptr(),
                     k_pages.data_ptr(), v_pages.data_ptr(),
                     block_tables.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), B, H, Hkv, ps, Pseq, D, Dv,
                     float(soft_cap), win,
                     torch.cuda.current_stream().cuda_stream)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
