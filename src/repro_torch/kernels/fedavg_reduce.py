"""Wrapper of the hand-written CUDA kernel ``csrc/fedavg_reduce.cu``: the
weighted reduction over model replicas that every FedAvg round performs.
Counterpart of ``repro/kernels/fedavg_reduce.py``.

A CPU tensor takes the plain version (:func:`ref.fedavg_reduce_ref`); a
CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad

#: largest replica count: C normalised weights in 48 KB of shared memory
MAX_REPLICAS = 12288
_ENTRY = {torch.float32: "fedavg_reduce_f32",
          torch.bfloat16: "fedavg_reduce_bf16"}


def fedavg_reduce(stacked: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, N) replica matrix; weights (C,) -> (N,) average,
    summed in float32, in the dtype of ``stacked``."""
    dev = common_device(stacked, weights)
    if stacked.dim() != 2 or tuple(weights.shape) != (stacked.shape[0],):
        raise ValueError(f"need stacked (C,N) and weights (C,), got "
                         f"{tuple(stacked.shape)} and {tuple(weights.shape)}")
    if dev.type == "cpu":
        return ref.fedavg_reduce_ref(stacked, weights)
    if dev.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cpu or cuda, not {dev}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"fedavg_reduce kernel takes float32 or bfloat16, "
                        f"not {stacked.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, not {weights.dtype}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg_reduce kernel needs contiguous inputs")
    C, N = stacked.shape
    if not 1 <= C <= MAX_REPLICAS:
        raise ValueError(f"replica count {C} outside 1..{MAX_REPLICAS}")

    def launch(stacked, weights):
        out = torch.empty((N,), dtype=stacked.dtype, device=dev)
        if N == 0:
            return out
        with torch.cuda.device(dev):
            build.launch(_ENTRY[stacked.dtype], stacked.data_ptr(),
                         weights.data_ptr(), out.data_ptr(), C, N,
                         torch.cuda.current_stream().cuda_stream)
        fedavg_reduce.launches += 1
        return out

    return with_grad(launch, ref.fedavg_reduce_ref, stacked, weights)


fedavg_reduce.launches = 0
