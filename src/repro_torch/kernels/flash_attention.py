"""Wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``:
causal (optionally sliding-window) attention, the prefill of both LM
serving engines; without the causal mask also whisper's encoder and,
over a key length of its own, its cross attention.  Counterpart of
``repro/kernels/flash_attention.py``.

A CPU tensor takes the plain version (:func:`ref.flash_attention_ref`);
a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import head_dims, kernel_inputs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH,T,D); k/v (BHkv,Tk,D) -> (BH,T,Dv) in q's dtype, queries at
    positions 0..T-1 and keys at 0..Tk-1.  BHkv = BH and Tk = T is the
    JAX signature; a GQA caller may instead pass each kv head once (BHkv
    dividing BH, query row bh reads kv row bh // (BH // BHkv)), and a
    call without the causal mask may give the keys a length of their own
    (cross attention; the JAX kernel asserts one T).  ``window <= 0``
    means no window; any T.  The kernel takes D and Dv up to 256 (MLA
    prefill: D 192, Dv 128; gemma3: D = Dv = 256)."""
    dev = common_device(q, k, v)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH,T,D) q, k and v")
    BH, T, D = q.shape
    BHkv, Tk, Dv = k.shape[0], k.shape[1], v.shape[2]
    if (tuple(k.shape) != (BHkv, Tk, D) or tuple(v.shape[:2]) != (BHkv, Tk)
            or BHkv == 0 or BH % BHkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if Tk != T and (causal or Tk == 0):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"do not agree: a key length of its own ({Tk} "
                         f"keys for {T} queries) needs causal=False and at "
                         "least one key")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    suffix = kernel_inputs("flash_attention", q=q, k=k, v=v)
    head_dims("flash_attention", D, Dv)
    # a window that reaches past every key is no window (and the kernel
    # then never forms q_pos - window)
    win = int(window) if 0 < window < T else 0

    def launch(q, k, v):
        out = torch.empty((BH, T, Dv), dtype=q.dtype, device=dev)
        if BH == 0 or T == 0:
            return out
        with torch.cuda.device(dev):
            build.launch(f"flash_attention_{suffix}", q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                         BHkv, T, Tk, D, Dv, int(bool(causal)), win,
                         torch.cuda.current_stream().cuda_stream)
        flash_attention.launches += 1
        return out

    return with_grad(launch, lambda q, k, v: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), q, k, v)


flash_attention.launches = 0
