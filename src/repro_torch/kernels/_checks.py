"""Argument checks shared by the attention kernels' wrappers."""
from __future__ import annotations

import torch

#: largest value dim the attention kernels take (each lane of a warp owns
#: 4 output dims), and the decode kernels' head dim
MAX_HEAD_DIM = 128
#: largest score (query/key) dim of ``flash_attention``, which only loops
#: over it in shared memory: MLA prefill scores over nope + rope = 192
MAX_SCORE_DIM = 256
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


def head_dims(name: str, *dims: int, limit: int = MAX_HEAD_DIM) -> None:
    for d in dims:
        if not 1 <= d <= limit:
            raise ValueError(f"{name} kernel takes head dims 1..{limit}, "
                             f"got {d}")
