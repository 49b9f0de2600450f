"""Wrapper of the hand-written CUDA kernel ``csrc/decode_attention.cu``:
one query token per sequence against a contiguous KV cache, the dense
engine's decode step.  Counterpart of ``repro/kernels/decode_attention.py``.

A CPU tensor takes the plain version (:func:`ref.decode_attention_ref`);
a CUDA tensor launches the kernel or raises.

The signature departs from the JAX kernel's by one keyword,
``soft_cap``, which the paged kernel of both packages already takes.  It
exists for parity with ``repro/models/attention.py``'s ``gqa_decode``,
which caps a config's decode scores (``logit_soft_cap``) through XLA; the
JAX models never call their own kernels, so the port's kernel takes what
the port's model needs.  No registered config sets a cap (gemma3-1b's is
0); the tests set one."""
from __future__ import annotations

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import head_dims, kernel_inputs


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,D); k/v (B,C,Hkv,D); valid (B,C) bool -> (B,H,Dv).  With
    ``soft_cap`` > 0 each score s becomes tanh(s / cap) * cap before the
    mask.  D and Dv up to 256."""
    dev = common_device(q, k, v, valid)
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention takes q (B,H,D), k/v (B,C,Hkv,D)")
    B, H, D = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(k.shape) != (B, C, Hkv, D) or tuple(v.shape[:3]) != (B, C, Hkv)
            or tuple(valid.shape) != (B, C) or Hkv == 0 or H % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, valid {tuple(valid.shape)} "
                         "do not agree")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    if soft_cap < 0:
        raise ValueError(f"soft_cap must be >= 0, got {soft_cap}")
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, soft_cap=soft_cap)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {dev}")
    suffix = kernel_inputs("decode_attention", q=q, k=k, v=v, valid=valid)
    head_dims("decode_attention", D, Dv)

    def launch(q, k, v, valid):
        out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
        if B == 0 or H == 0 or C == 0:
            return out.zero_()
        with torch.cuda.device(dev):
            build.launch(f"decode_attention_{suffix}", q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                         out.data_ptr(), B, H, Hkv, C, D, Dv,
                         float(soft_cap),
                         torch.cuda.current_stream().cuda_stream)
        decode_attention.launches += 1
        return out

    return with_grad(launch, lambda *t: ref.decode_attention_ref(
        *t, soft_cap=soft_cap), q, k, v, valid)


decode_attention.launches = 0
