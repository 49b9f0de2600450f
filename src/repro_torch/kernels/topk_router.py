"""Wrapper of the hand-written CUDA kernel ``csrc/topk_router.cu``: the
fused softmax and top-k expert choice of every MoE layer.  Counterpart
of ``repro/kernels/topk_router.py``.

A CPU tensor takes the plain version (:func:`ref.topk_router_ref`); a
CUDA tensor launches the kernel or raises."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad

#: largest expert count: rows of up to 256 experts stay in registers,
#: wider ones take 8 token rows of E fp32 probabilities in shared memory
MAX_EXPERTS = 4096


def topk_router(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T,E) -> (weights (T,k) f32, idx (T,k) int32): softmax over
    the E experts in fp32, then k rounds of argmax-and-mask, a tie going
    to the lowest index.  The kernel takes fp32 logits (the router's
    product is fp32) and any T."""
    dev = logits.device
    if logits.dim() != 2:
        raise ValueError(f"topk_router takes logits (T,E), got "
                         f"{tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"topk_router needs 1 <= k <= E, got k={k}, E={E}")
    if dev.type == "cpu":
        return ref.topk_router_ref(logits, k)
    if dev.type != "cuda":
        raise ValueError(f"topk_router runs on cpu or cuda, not {dev}")
    if logits.dtype != torch.float32:
        raise TypeError(f"topk_router kernel takes float32 logits, not "
                        f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("topk_router kernel needs contiguous logits")
    if E > MAX_EXPERTS:
        raise ValueError(f"topk_router kernel takes at most {MAX_EXPERTS} "
                         f"experts, got {E}")

    def launch(logits):
        weights = torch.empty((T, k), dtype=torch.float32, device=dev)
        idx = torch.empty((T, k), dtype=torch.int32, device=dev)
        if T == 0:
            return weights, idx
        with torch.cuda.device(dev):
            build.launch("topk_router_f32", logits.data_ptr(),
                         weights.data_ptr(), idx.data_ptr(), T, E, k,
                         torch.cuda.current_stream().cuda_stream)
        topk_router.launches += 1
        return weights, idx

    # the indices are integers: only the weights carry a gradient
    return with_grad(launch, lambda x: ref.topk_router_ref(x, k), logits)


topk_router.launches = 0
