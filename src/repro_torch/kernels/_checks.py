"""Argument checks shared by the attention kernels' wrappers."""
from __future__ import annotations

import torch

#: largest head dim (score and value) of the three GQA attention
#: kernels: gemma3's 256.  A decode row wider than 128 is spread over 16
#: lanes; flash's bf16 instance holds a 64 x 256 fp32 O tile a warpgroup,
#: its fp32 instance 8 output dims a lane
MAX_HEAD_DIM = 256
ENTRY_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def kernel_inputs(name: str, **tensors: torch.Tensor) -> str:
    """Raise unless the floating inputs share one dtype the kernel takes
    and every input is contiguous; return the entry point's suffix."""
    dtypes = {t.dtype for t in tensors.values() if t.is_floating_point()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in ENTRY_SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 inputs of "
                        f"one dtype, got {sorted(map(str, dtypes))}")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous {key}")
    return ENTRY_SUFFIX[dtypes.pop()]


def head_dims(name: str, *dims: int) -> None:
    for d in dims:
        if not 1 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"{name} kernel takes head dims "
                             f"1..{MAX_HEAD_DIM}, got {d}")
