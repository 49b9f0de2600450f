"""Wrapper of the hand-written CUDA kernel ``csrc/gru_seq.cu``: the GRU
recurrence of the paper's traffic model, the per-request unit of work at
every serving tier.  Counterpart of ``repro/kernels/gru_cell.py``.

The input projection x@W_x+b is one matrix product done outside the
kernel; the kernel runs the sequential recurrence with the hidden state
on chip.  A CPU tensor takes the plain version (:func:`ref.gru_seq_ref`);
a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad

#: largest hidden size: 4h floats of shared memory within 48 KB
MAX_HIDDEN = 3072


def gru_seq(xw: torch.Tensor, h0: torch.Tensor,
            w_h: torch.Tensor) -> torch.Tensor:
    """xw (B,T,3h) precomputed input projection; h0 (B,h); w_h (h,3h).
    Returns hidden states (B,T,h).  Any B."""
    dev = common_device(xw, h0, w_h)
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"xw must be (B,T,3h), got {tuple(xw.shape)}")
    B, T, h3 = xw.shape
    h = h3 // 3
    if tuple(h0.shape) != (B, h) or tuple(w_h.shape) != (h, h3):
        raise ValueError(f"shapes xw {tuple(xw.shape)}, h0 {tuple(h0.shape)},"
                         f" w_h {tuple(w_h.shape)} do not agree")
    if dev.type == "cpu":
        return ref.gru_seq_ref(xw, h0, w_h)
    if dev.type != "cuda":
        raise ValueError(f"gru_seq runs on cpu or cuda, not {dev}")
    for name, t in (("xw", xw), ("h0", h0), ("w_h", w_h)):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_seq kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_seq kernel needs contiguous {name}")
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden {h} > {MAX_HIDDEN}: the state does not fit "
                         "one block's shared memory")

    def launch(xw, h0, w_h):
        out = torch.empty((B, T, h), dtype=xw.dtype, device=dev)
        if B == 0 or T == 0:
            return out
        with torch.cuda.device(dev):
            build.launch("gru_seq_f32", xw.data_ptr(), h0.data_ptr(),
                         w_h.data_ptr(), out.data_ptr(), B, T, h,
                         torch.cuda.current_stream().cuda_stream)
        gru_seq.launches += 1
        return out

    return with_grad(launch, ref.gru_seq_ref, xw, h0, w_h)


gru_seq.launches = 0
