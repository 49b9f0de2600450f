"""Input specs for every (architecture x input shape) combination, the
counterpart of ``repro/launch/specs.py``: where the reference gives
``jax.ShapeDtypeStruct`` trees from ``jax.eval_shape``, these give
``FakeTensorMode`` tensors on ``"cpu"``, which carry shape, dtype and
device and allocate nothing.  A llama3-405b tree of 405.9 B parameters
is drawn this way in about two seconds on a host CPU.

Why fake CPU tensors and not ``meta``: the port's entry points resolve
a device with ``repro_torch.device.resolve_device``, which takes only
cuda and cpu, and on (fake) CPU tensors the plain PyTorch path runs as
it is, so the dry run traces the very code the CPU tests check.

Every function takes the ``FakeTensorMode`` to draw in (``fake_mode``);
tensors of one trace must share one mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import ModelApi


def _mode(fake_mode: Optional[FakeTensorMode]) -> FakeTensorMode:
    return fake_mode if fake_mode is not None else FakeTensorMode()


def model_batch_specs(cfg: ArchConfig, shape: InputShape,
                      with_labels: bool = True,
                      fake_mode: Optional[FakeTensorMode] = None
                      ) -> Dict[str, torch.Tensor]:
    """Batch specs for train (with labels) / prefill (without)."""
    m = cfg.model
    B, S = shape.global_batch, shape.seq_len
    i32, bf16, f32 = torch.int32, torch.bfloat16, torch.float32
    with _mode(fake_mode):
        def sds(shp, dt):
            return torch.empty(shp, dtype=dt, device="cpu")

        if m.family == "rnn":
            return {"windows": sds((B, 12, 1), f32),
                    "targets": sds((B, 1), f32)}
        out: Dict[str, torch.Tensor] = {}
        if m.family == "vlm":
            P = m.frontend.num_positions
            out["patches"] = sds((B, P, m.frontend.embed_dim), bf16)
            out["tokens"] = sds((B, S - P), i32)
            if with_labels:
                out["labels"] = sds((B, S - P), i32)
        elif m.family == "audio":
            F = m.frontend.num_positions
            out["frames"] = sds((B, F, m.frontend.embed_dim), bf16)
            out["tokens"] = sds((B, S), i32)
            if with_labels:
                out["labels"] = sds((B, S), i32)
        else:
            out["tokens"] = sds((B, S), i32)
            if with_labels:
                out["labels"] = sds((B, S), i32)
        return out


def param_specs_and_axes(api: ModelApi,
                         fake_mode: Optional[FakeTensorMode] = None
                         ) -> Tuple[Any, Any]:
    """(fake parameter tree, logical-axes tree) without allocating."""
    with _mode(fake_mode):
        return api.init_params(torch.Generator(), device="cpu",
                               with_axes=True)


def cache_specs(api: ModelApi, batch: int, max_len: int,
                fake_mode: Optional[FakeTensorMode] = None) -> Any:
    with _mode(fake_mode):
        return api.init_cache(batch, max_len, device="cpu")


def decode_token_specs(cfg: ArchConfig, shape: InputShape,
                       fake_mode: Optional[FakeTensorMode] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    B = shape.global_batch
    with _mode(fake_mode):
        if cfg.model.family == "rnn":
            return (torch.empty((B, 12, 1), dtype=torch.float32),
                    torch.empty((), dtype=torch.int32))
        return (torch.empty((B, 1), dtype=torch.int32),
                torch.empty((), dtype=torch.int32))
