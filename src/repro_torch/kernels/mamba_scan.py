"""Wrapper of the hand-written CUDA kernel ``csrc/mamba_chunk_scan.cu``:
the chunked Mamba2 SSD scan of zamba2's full-sequence forward.
Counterpart of ``repro/kernels/mamba_scan.py``; the TPU kernel's tiling
knobs (``bh``, ``interpret``) are not carried over.

A CPU tensor takes the plain version (:func:`ref.mamba_chunk_scan_ref`);
a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import common_device
from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import with_grad
from repro_torch.kernels._checks import ENTRY_SUFFIX

#: the kernel's limits: chunk rows and state / head dims it stages in
#: registers and shared memory (csrc/mamba_chunk_scan.cu), and the
#: shared memory a block may use on Hopper
MAX_CHUNK = 256
MAX_STATE_DIM = 128
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232_448


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block of 16 warps: B and C of the
    chunk (rows padded to N + 1 floats), u (Q x P), the state (N x P),
    one 64-row tile of scores (rows padded to Q + 1), dt * A, its prefix
    sums, the end-of-chunk decays and each warp's segment sums (Q each)."""
    return 4 * (2 * Q * (N + 1) + Q * P + N * P + 64 * (Q + 1) + 19 * Q)


def mamba_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; Bm/Cm
    (B,L,N) (ngroups 1); ``chunk`` divides L.  Returns (y (B,L,H,P) in
    x's dtype, final state (B,H,N,P) fp32); all arithmetic in fp32.  On
    the card x, Bm and Cm are fp32 or bf16 (one dtype), dt and A fp32,
    all contiguous."""
    dev = common_device(x, dt, A, Bm, Cm)
    if x.dim() != 4:
        raise ValueError(f"mamba_chunk_scan takes x (B,L,H,P), got "
                         f"{tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, L, H) or tuple(A.shape) != (H,)
            or Bm.dim() != 3 or tuple(Bm.shape) != (B, L, N)
            or tuple(Cm.shape) != (B, L, N)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} "
            "do not agree")
    if chunk < 1 or L % chunk:
        raise ValueError(f"chunk {chunk} does not divide L {L}")
    if dev.type == "cpu":
        return ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)
    if dev.type != "cuda":
        raise ValueError(f"mamba_chunk_scan runs on cpu or cuda, not {dev}")
    dtypes = {x.dtype, Bm.dtype, Cm.dtype}
    if len(dtypes) != 1 or x.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"mamba_chunk_scan kernel takes x, Bm and Cm in one "
                        f"dtype, float32 or bfloat16; got "
                        f"{sorted(map(str, dtypes))}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"mamba_chunk_scan kernel takes float32 dt and A, "
                        f"got {dt.dtype} and {A.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"mamba_chunk_scan kernel needs contiguous "
                             f"{name}")
    if (chunk > MAX_CHUNK or not 1 <= N <= MAX_STATE_DIM
            or not 1 <= P <= MAX_HEAD_DIM
            or smem_bytes(chunk, N, P) > MAX_SMEM_BYTES):
        raise ValueError(
            f"mamba_chunk_scan kernel takes chunk <= {MAX_CHUNK}, N <= "
            f"{MAX_STATE_DIM}, P <= {MAX_HEAD_DIM} within "
            f"{MAX_SMEM_BYTES} bytes of shared memory; got chunk {chunk}, "
            f"N {N}, P {P}")

    def launch(x, dt, A, Bm, Cm):
        y = torch.empty_like(x)
        state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
        if y.numel() == 0:
            return y, state.zero_()
        with torch.cuda.device(dev):
            build.launch(f"mamba_chunk_scan_{ENTRY_SUFFIX[x.dtype]}",
                         x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                         state.data_ptr(), B, L, H, P, N, chunk,
                         torch.cuda.current_stream().cuda_stream)
        mamba_chunk_scan.launches += 1
        return y, state

    # both outputs, y and the final state, carry gradients
    return with_grad(launch, lambda *t: ref.mamba_chunk_scan_ref(*t, chunk),
                     x, dt, A, Bm, Cm)


mamba_chunk_scan.launches = 0
