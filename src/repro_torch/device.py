"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  Raises when CUDA is asked for (explicitly
    or by default) and is not there: the port never quietly runs on the
    CPU, the caller has to pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def common_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; raises if they differ."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devs))}")
    return devs.pop()
