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

#: the kernel's limits (csrc/mamba_chunk_scan.cu): it runs chunks of at
#: most 128 rows (a caller's chunk of 129 to 256 rows, if even, in two
#: halves: the chunk only regroups the sum), state and head dims up to
#: 128 in registers, and the shared memory a block may use on Hopper
MAX_CHUNK = 256
KERNEL_CHUNK = 128
MAX_STATE_DIM = 128
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232_448


def kernel_chunk(chunk: int) -> int:
    """The chunk the kernel runs for a caller's ``chunk``: the same up to
    128 rows, half of an even chunk up to 256; else 0 (not taken)."""
    if 1 <= chunk <= KERNEL_CHUNK:
        return chunk
    if chunk <= MAX_CHUNK and chunk % 2 == 0:
        return chunk // 2
    return 0


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(Q: int, N: int, P: int, itemsize: int = 4) -> int:
    """Dynamic shared memory the kernel needs for its chunk Q and inputs
    of ``itemsize`` bytes: the larger of its two staging kernels' blocks,
    as csrc/mamba_chunk_scan.cu lays them out (rows padded by 16 bytes).
    Local states: B (Q x N), one head's x (Q rows of 64 or 128) and dt,
    then each warp's suffix sums and decay weights.  Outputs: B and C (Q
    x N), each warp's suffix sums and two 16 x 17 tables, and one slot of
    x, the entering state (N x P fp32; for bf16 its hi and lo bf16
    planes, N rows of 64 or 128 each) and dt; the kernel takes a second
    slot where it fits."""
    pad = 16 // itemsize
    warps = (Q + 15) // 16
    xc = 64 if P <= 64 else 128
    local = (_round16(itemsize * Q * (N + pad))
             + _round16(itemsize * Q * (xc + pad)) + _round16(4 * Q)
             + _round16(4 * ((N + 15) // 16) * (2 * Q + 1)))
    outputs = (2 * _round16(itemsize * Q * (N + pad))
               + _round16(4 * warps * (Q + 1 + 2 * 16 * 17))
               + _round16(itemsize * Q * (xc + pad))
               + _round16(4 * N * (P + 4 if itemsize == 4 else xc + 8))
               + _round16(4 * Q))
    return max(local, outputs)


def scratch_floats(B: int, L: int, H: int, N: int, P: int, Q: int) -> int:
    """The kernel's fp32 scratch for the kernel chunk Q: every chunk's
    local end state, the state entering every chunk after the first, and
    every chunk's decay."""
    nc = L // Q
    return (2 * nc - 1) * B * H * N * P + B * nc * H


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
    Q = kernel_chunk(chunk)
    if (not Q or not 1 <= N <= MAX_STATE_DIM or not 1 <= P <= MAX_HEAD_DIM
            or smem_bytes(Q, N, P, x.element_size()) > MAX_SMEM_BYTES):
        raise ValueError(
            f"mamba_chunk_scan kernel takes chunk <= {KERNEL_CHUNK} (or an "
            f"even chunk <= {MAX_CHUNK}), N <= {MAX_STATE_DIM}, P <= "
            f"{MAX_HEAD_DIM} within {MAX_SMEM_BYTES} bytes of shared "
            f"memory; got chunk {chunk}, N {N}, P {P}")

    def launch(x, dt, A, Bm, Cm):
        y = torch.empty_like(x)
        state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
        if y.numel() == 0:
            return y, state.zero_()
        scratch = torch.empty(scratch_floats(B, L, H, N, P, Q),
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            build.launch(f"mamba_chunk_scan_{ENTRY_SUFFIX[x.dtype]}",
                         x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                         state.data_ptr(), scratch.data_ptr(), B, L, H, P, N,
                         Q, torch.cuda.current_stream().cuda_stream)
        mamba_chunk_scan.launches += 1
        return y, state

    # both outputs, y and the final state, carry gradients
    return with_grad(launch, lambda *t: ref.mamba_chunk_scan_ref(*t, chunk),
                     x, dt, A, Bm, Cm)


mamba_chunk_scan.launches = 0
