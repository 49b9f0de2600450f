"""Wrapper of the hand-written CUDA kernel ``csrc/decode_attention.cu``:
one query token per sequence against a contiguous KV cache, the dense
engine's decode step.  Counterpart of ``repro/kernels/decode_attention.py``.
:func:`decode_attention_partial` is the same kernel over one rank's
share of a cache split along its slots, returning the partial softmax
statistics that ``models/sharded.py`` merges across the ranks.

A CPU tensor takes the plain version (:func:`ref.decode_attention_ref`,
:func:`ref.decode_attention_partial_ref`); a CUDA tensor launches the
kernel or raises.

The signature departs from the JAX kernel's by one keyword,
``soft_cap``, which the paged kernel of both packages already takes.  It
exists for parity with ``repro/models/attention.py``'s ``gqa_decode``,
which caps a config's decode scores (``logit_soft_cap``) through XLA; the
JAX models never call their own kernels, so the port's kernel takes what
the port's model needs.  No registered config sets a cap (gemma3-1b's is
0); the tests set one."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import head_dims, kernel_inputs


def _check(name, q, k, v, valid, soft_cap):
    """The shapes (B, H, Hkv, C, D, Dv) of a decode call, after its
    argument checks."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes q (B,H,D), k/v (B,C,Hkv,D)")
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
    return B, H, Hkv, C, D, Dv


def _kernel_suffix(name, dev, q, k, v, valid, D, Dv) -> str:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    suffix = kernel_inputs(name, q=q, k=k, v=v, valid=valid)
    head_dims(name, D, Dv)
    return suffix


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,H,D); k/v (B,C,Hkv,D); valid (B,C) bool -> (B,H,Dv).  With
    ``soft_cap`` > 0 each score s becomes tanh(s / cap) * cap before the
    mask.  D and Dv up to 256."""
    dev = common_device(q, k, v, valid)
    B, H, Hkv, C, D, Dv = _check("decode_attention", q, k, v, valid,
                                 soft_cap)
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, soft_cap=soft_cap)
    suffix = _kernel_suffix("decode_attention", dev, q, k, v, valid, D, Dv)

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


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             soft_cap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`decode_attention` over one share of a row's slots, left
    unnormalised: (o (B,H,Dv), m (B,H), l (B,H)), all fp32, where m is
    the row max of the scores, l the sum of exp(s - m) and o the sum of
    exp(s - m) . v.  A row with no valid slot gives m = -2e38
    (:data:`ref.PARTIAL_NEG_INF`), l = C and o = the sum of V, so that
    shares merged as m* = max m, sum o e^(m - m*) / sum l e^(m - m*)
    give :func:`decode_attention` over all the slots."""
    dev = common_device(q, k, v, valid)
    B, H, Hkv, C, D, Dv = _check("decode_attention_partial", q, k, v, valid,
                                 soft_cap)
    if dev.type == "cpu":
        return ref.decode_attention_partial_ref(q, k, v, valid,
                                                soft_cap=soft_cap)
    suffix = _kernel_suffix("decode_attention_partial", dev, q, k, v, valid,
                            D, Dv)

    def launch(q, k, v, valid):
        f32 = dict(dtype=torch.float32, device=dev)
        o, m, l = (torch.empty((B, H, Dv), **f32), torch.empty((B, H), **f32),
                   torch.empty((B, H), **f32))
        if B == 0 or H == 0 or C == 0:
            return o.zero_(), m.fill_(ref.PARTIAL_NEG_INF), l.zero_()
        with torch.cuda.device(dev):
            build.launch(f"decode_attention_partial_{suffix}", q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                         o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Hkv,
                         C, D, Dv, float(soft_cap),
                         torch.cuda.current_stream().cuda_stream)
        decode_attention_partial.launches += 1
        return o, m, l

    return with_grad(launch, lambda *t: ref.decode_attention_partial_ref(
        *t, soft_cap=soft_cap), q, k, v, valid)


decode_attention_partial.launches = 0
