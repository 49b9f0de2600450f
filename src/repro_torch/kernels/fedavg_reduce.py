"""Wrapper of the hand-written CUDA kernel ``csrc/fedavg_reduce.cu``: the
weighted reduction over model replicas that every FedAvg round performs.
Counterpart of ``repro/kernels/fedavg_reduce.py``.

A CPU tensor takes the plain version (:func:`ref.fedavg_reduce_ref`); a
CUDA tensor launches the kernel or raises.

Two instances, picked by :func:`instance` from shape, dtype and pointer
alignment alone, never in response to a failure:

- ``"vector"`` where every replica row starts on a 16-byte boundary
  (``N * item % 16 == 0``, ``x`` and ``out`` 16-byte aligned): each
  thread loads 16-byte chunks (4 fp32 or 8 bf16 columns), all C rows of
  a tile before its first multiply-add.  The LM syncs take it.
- ``"scalar"`` for everything else, one element a load, 256 columns a
  block: the GRU's odd N (148,737), views with a storage offset.

Both walk N over a persistent grid, a few blocks an SM, which the kernel
works out from the SM count passed to it; any grid gives the same bits."""
from __future__ import annotations

import functools

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad

#: largest replica count: C normalised weights in the 48 KB of shared
#: memory a block gets without an opt-in (the kernel uses no other)
MAX_REPLICAS = 12288
_ITEM = {torch.float32: 4, torch.bfloat16: 2}
_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}


def instance(C: int, N: int, dtype: torch.dtype, x_ptr: int,
             out_ptr: int) -> str:
    """The kernel instance that averages C replicas of N columns of
    ``dtype`` from address ``x_ptr`` into ``out_ptr``."""
    if not 1 <= C <= MAX_REPLICAS:
        raise ValueError(f"replica count {C} outside 1..{MAX_REPLICAS}")
    if dtype not in _ITEM:
        raise TypeError(f"fedavg_reduce kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    aligned = (N * _ITEM[dtype]) % 16 == 0 and x_ptr % 16 == 0 \
        and out_ptr % 16 == 0
    return "vector" if aligned else "scalar"


@functools.lru_cache(maxsize=None)
def sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if stacked.dtype not in _ITEM:
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
        inst = instance(C, N, stacked.dtype, stacked.data_ptr(),
                        out.data_ptr())
        with torch.cuda.device(dev):
            build.launch(f"fedavg_reduce_{inst}_{_NAME[stacked.dtype]}",
                         stacked.data_ptr(), weights.data_ptr(),
                         out.data_ptr(), C, N, sms(dev.index),
                         torch.cuda.current_stream().cuda_stream)
        fedavg_reduce.launches += 1
        return out

    return with_grad(launch, ref.fedavg_reduce_ref, stacked, weights)


fedavg_reduce.launches = 0
