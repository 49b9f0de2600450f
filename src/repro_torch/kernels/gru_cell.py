"""Wrapper of the hand-written CUDA kernel ``csrc/gru_seq.cu``: the GRU
recurrence of the paper's traffic model, the per-request unit of work at
every serving tier.  Counterpart of ``repro/kernels/gru_cell.py``.

The input projection x@W_x+b is one matrix product done outside the
kernel; the kernel runs the sequential recurrence with the hidden state
on chip.  A CPU tensor takes the plain version (:func:`ref.gru_seq_ref`);
a CUDA tensor launches the kernel or raises.

Two instances, picked by :func:`instance` from h alone, never in
response to a failure:

- ``"cluster"`` for h <= ``CLUSTER_MAX_HIDDEN`` = 128: clusters of S
  blocks, ``bb`` batch rows each, every block holding its units' three
  columns of W_h in registers for all T steps and the state exchanged
  through distributed shared memory.  128 is the widest W_h slice a
  thread holds: 8 lanes a unit with at most 16 rows of W_h each (48
  registers).  :func:`cluster_shape` gives (S, bb) for (B, h).
- ``"general"`` for 128 < h <= ``MAX_HIDDEN`` = 3072: one block per
  sequence, W_h read through L2 at every step."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad

#: largest hidden size: the general instance's 4h floats of shared memory
#: within 48 KB
MAX_HIDDEN = 3072
#: largest hidden size of the cluster instance
CLUSTER_MAX_HIDDEN = 128


def instance(h: int) -> str:
    """The kernel instance that runs hidden size ``h``."""
    return "cluster" if h <= CLUSTER_MAX_HIDDEN else "general"


def cluster_shape(B: int, h: int) -> Tuple[int, int]:
    """(S, bb) of the cluster instance: clusters of S blocks, each running
    bb batch rows (the grid is ceil(B / bb) clusters).

    S = the largest power of two <= min(8, h / 8) (at least 1), so that a
    block owns 16 units at h 128 and 8 at h 32 and 64; bb = the least
    power of two (at most 8) with ceil(B / bb) * S <= 64, so that the
    clusters take at most half of the card's SMs.  At h 128 that is
    (8, 1) for B 1 and 4 and (8, 2) for B 16, the fastest shapes of
    ``scripts/torch_gru_seq_sweep.py``'s sweep on an H100.  Clusters stop
    at 8 blocks, the portable size: 16 were measured no faster."""
    S = 1
    while S < 8 and 2 * S <= h // 8:
        S *= 2
    bb = 1
    while bb < 8 and -(-B // bb) * S > 64:
        bb *= 2
    return S, bb


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
            ptrs = (xw.data_ptr(), h0.data_ptr(), w_h.data_ptr(),
                    out.data_ptr(), B, T, h)
            stream = torch.cuda.current_stream().cuda_stream
            if instance(h) == "cluster":
                build.launch("gru_seq_cluster_f32", *ptrs,
                             *cluster_shape(B, h), stream)
            else:
                build.launch("gru_seq_f32", *ptrs, stream)
        gru_seq.launches += 1
        return out

    return with_grad(launch, ref.gru_seq_ref, xw, h0, w_h)


gru_seq.launches = 0
