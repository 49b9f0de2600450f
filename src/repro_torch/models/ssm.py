"""Mamba2 (State Space Duality) block: the chunked full-sequence scan and
the O(1)-state decode, the counterpart of ``repro/models/ssm.py`` with
the same functions, parameter paths, shapes and dtypes.

Recurrence per head (state N x P):
    S_t = a_t * S_{t-1} + B_t (x) u_t        a_t = exp(dt_t * A),  u_t = dt_t * x_t
    y_t = C_t . S_t + D * x_t

On a CUDA tensor :func:`mamba2_forward` runs the scan in
``ops.mamba_chunk_scan`` (ngroups 1; a model with ``ngroups > 1`` raises
there, as no config of the repo has one); on a CPU tensor it runs
:func:`ssd_chunked`, the plain chunked SSD of the JAX module, which is
also the kernel's plain version (``kernels/ref.py``).
:func:`mamba2_decode` is plain PyTorch on both devices (the JAX package
has no kernel there) and writes the new state into the state it is given.

bf16 rounds where the JAX module rounds: the causal conv sums its taps in
the input dtype and applies ``silu`` in fp32, the scan returns ``y`` in
``x``'s dtype and ``y + x * D`` is taken in it, ``dt``, ``A`` and the
gated norm are fp32.  The decode state (conv ring and SSD state) is fp32.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import sharded
from repro_torch.models.common import ParamInit, shard


class SSMState(NamedTuple):
    """Decode-time state: conv ring buffer + SSD state."""
    conv: torch.Tensor   # (B, W-1, conv_ch)
    s: torch.Tensor      # (B, H, N, P)


def mamba_dims(d_model: int, s: SSMConfig) -> Dict[str, int]:
    d_in = d_model * s.expand
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.state_dim
    return dict(d_in=d_in, H=H, P=s.head_dim, N=s.state_dim,
                G=s.ngroups, conv_ch=conv_ch)


def init_mamba2(pi: ParamInit, path: str, d_model: int, s: SSMConfig,
                stack: int = 0) -> None:
    dd = mamba_dims(d_model, s)
    d_in, H, N, G, conv_ch = (dd["d_in"], dd["H"], dd["N"], dd["G"],
                              dd["conv_ch"])
    f32 = torch.float32
    # fused input projection: [z, x, B, C, dt]
    pi.param(f"{path}/in_proj", (d_model, 2 * d_in + 2 * G * N + H),
             ("embed", "mlp"), stack=stack)
    pi.param(f"{path}/conv_w", (s.conv_width, conv_ch), (None, "mlp"),
             stack=stack)
    pi.param(f"{path}/conv_b", (conv_ch,), ("mlp",), init="zeros",
             stack=stack)
    pi.param(f"{path}/A_log", (H,), ("heads",), init="zeros", dtype=f32,
             stack=stack)
    pi.param(f"{path}/D", (H,), ("heads",), init="ones", dtype=f32,
             stack=stack)
    pi.param(f"{path}/dt_bias", (H,), ("heads",), init="zeros", dtype=f32,
             stack=stack)
    pi.param(f"{path}/norm_scale", (d_in,), ("mlp",), init="ones",
             stack=stack)
    pi.param(f"{path}/out_proj", (d_in, d_model), ("mlp", "embed"),
             stack=stack)


def _split_proj(p: Dict[str, Any], x: torch.Tensor, d_model: int,
                s: SSMConfig):
    dd = mamba_dims(d_model, s)
    d_in, GN = dd["d_in"], dd["G"] * dd["N"]
    zxbcdt = shard(torch.matmul(x, p["in_proj"]), "batch", "seq", "mlp_act")
    z = zxbcdt[..., :d_in]
    xin = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + GN]
    Cm = zxbcdt[..., 2 * d_in + GN:2 * d_in + 2 * GN]
    dt = zxbcdt[..., 2 * d_in + 2 * GN:]
    return z, xin, Bm, Cm, dt, dd


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: xbc (B,L,ch), w (W,ch).  The W taps are
    summed in xbc's dtype, in JAX's order (``F.conv1d`` would accumulate
    otherwise), then ``silu`` in fp32."""
    if sharded.is_dtensor(xbc):
        return sharded.depthwise(_causal_conv, xbc, w, b)
    W, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for k in range(W):
        out = out + pad[:, k:k + L, :] * w[k]
    return F.silu((out + b).float()).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    y32 = y.float() * F.silu(z.float())
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la (..., Q, H) -> (..., i, j, H): the sum of la over (j, i] for
    i >= j, -inf above the diagonal.  Each entry is summed over its own
    segment, as the Mamba2 reference's ``segsum`` does, so its rounding
    is relative to its own size; JAX's ``cum_i - cum_j`` subtracts two
    prefix sums that reach several hundred in a 128-token chunk of
    zamba2 and loses ~1e-5 of each decay, which the forward amplifies
    to ~1e-3 in the logits."""
    Q = la.shape[-2]
    ii = torch.arange(Q, device=la.device)
    x = la[..., :, None, :].expand(*la.shape[:-2], Q, Q, la.shape[-1])
    x = x.masked_fill(~(ii[:, None] > ii[None, :])[:, :, None], 0.0)
    seg = torch.cumsum(x, dim=-3)                  # over k: k in (j, i]
    return seg.masked_fill(~(ii[:, None] >= ii[None, :])[:, :, None],
                           float("-inf"))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                s_init: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, plain PyTorch (any ngroups G).

    xh (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; Bm/Cm
    (B,L,G,N); ``chunk`` divides L.  Returns (y (B,L,H,P) in xh's dtype,
    final_state (B,H,N,P) fp32).  The JAX function's math; its decays
    ``exp(cum_i - cum_j)`` and ``exp(cum_Q - cum_j)`` are taken as
    exponentials of segment sums (:func:`_segsum`), for i >= j only: the
    masked entries are ``exp(-inf) = 0``, where JAX forms ``exp`` of every
    entry and masks after (for i < j that exp may overflow, and ``where``
    drops it)."""
    B, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    c = L // chunk
    Q = chunk

    la = (dt * A).float()                                     # (B,L,H)
    u = xh.float() * dt[..., None]                            # (B,L,H,P)

    def r(x_, sh):  # reshape to chunks
        return x_.reshape((B, c, Q) + sh)
    la_c = r(la, (H,))
    u_c = r(u, (H, P))
    B_c = r(Bm.float(), (G, N)).repeat_interleave(rep, dim=3)   # (B,c,Q,H,N)
    C_c = r(Cm.float(), (G, N)).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(la_c, dim=2)                           # (B,c,Q,H)
    seg = _segsum(la_c)                                       # (B,c,i,j,H)
    decay = torch.exp(seg)
    scores = torch.einsum("bcihn,bcjhn->bcijh", C_c, B_c) * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, u_c)

    # per-chunk local end state: sum_j exp(cum_Q - cum_j) B_j (x) u_j
    wlast = torch.exp(seg[:, :, -1])                          # (B,c,Q,H)
    s_local = torch.einsum("bcqhn,bcqhp,bcqh->bchnp", B_c, u_c, wlast)
    a_chunk = torch.exp(cum[:, :, -1, :])                     # (B,c,H)

    s = (xh.new_zeros((B, H, N, P), dtype=torch.float32) if s_init is None
         else s_init.float())
    s_prevs = []
    for k in range(c):                                        # state *before* chunk k
        s_prevs.append(s)
        s = a_chunk[:, k, :, None, None] * s + s_local[:, k]
    s_prevs = torch.stack(s_prevs, dim=1)                     # (B,c,H,N,P)

    w_in = torch.exp(cum)                                     # L_i within chunk
    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", C_c, s_prevs, w_in)

    y = (y_intra + y_inter).reshape(B, L, H, P)
    return y.to(xh.dtype), s


def scan_per_group(scan: Callable, xin: torch.Tensor, dt: torch.Tensor,
                   A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> torch.Tensor:
    """The SSD scan of G groups as G scans of one group each: ``scan``
    (x, dt, A, B, C with B / C (B,L,N)) -> y runs on heads
    ``g*H/G : (g+1)*H/G`` with ``Bm[:, :, g]`` and ``Cm[:, :, g]``, and
    the outputs are concatenated along heads.  That is the reference's
    mapping, head h on group ``h // (H/G)`` (``jnp.repeat(..., rep)``,
    ``repro/models/ssm.py:94-106``)."""
    G, rep = Bm.shape[2], xin.shape[2] // Bm.shape[2]
    if G == 1:
        return scan(xin, dt, A, Bm[:, :, 0], Cm[:, :, 0])
    heads = [slice(g * rep, (g + 1) * rep) for g in range(G)]
    return torch.cat([scan(xin[:, :, h], dt[:, :, h], A[h], Bm[:, :, g],
                           Cm[:, :, g]) for g, h in enumerate(heads)], dim=2)


def _scan(xin: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan of :func:`mamba2_forward`: on the card one
    ``mamba_chunk_scan`` a group (:func:`scan_per_group`),
    :func:`ssd_chunked` on the CPU."""
    if sharded.is_dtensor(xin):
        return sharded.scan(lambda *t: _scan(*t, chunk), xin, dt, A, Bm, Cm)
    if not xin.is_cuda:
        return ssd_chunked(xin, dt, A, Bm, Cm, chunk)[0]

    def kernel(x, d, a, b, c):
        return ops.mamba_chunk_scan(x.contiguous(), d.contiguous(),
                                    a.contiguous(), b.contiguous(),
                                    c.contiguous(), chunk=chunk)[0]
    return scan_per_group(kernel, xin, dt, A, Bm, Cm)


def mamba2_forward(p: Dict[str, Any], d_model: int, s: SSMConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """x (B,L,d) -> (B,L,d); the chunk is ``min(s.chunk, L)`` and must
    divide L."""
    z, xin, Bm, Cm, dt, dd = _split_proj(p, x, d_model, s)
    H, P, N, G = dd["H"], dd["P"], dd["N"], dd["G"]
    B, L, _ = x.shape
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin = xbc[..., :dd["d_in"]].reshape(B, L, H, P)
    Bm = xbc[..., dd["d_in"]:dd["d_in"] + G * N].reshape(B, L, G, N)
    Cm = xbc[..., dd["d_in"] + G * N:].reshape(B, L, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    chunk = min(s.chunk, L)
    if L % chunk:
        raise ValueError(f"seq len {L} not divisible by chunk {chunk}")
    y = _scan(xin, dt, A, Bm, Cm, chunk)
    y = y + xin * p["D"][:, None].to(y.dtype)
    y = y.reshape(B, L, dd["d_in"])
    y = _gated_norm(y, z, p["norm_scale"])
    y = shard(y, "batch", "seq", "mlp_act")
    # the output constrained like the residual stream (DTensor could
    # otherwise split the sequence over an idle mesh axis)
    return shard(torch.matmul(y, p["out_proj"]), "batch", "seq",
                 "embed_act")


def init_ssm_state(batch: int, d_model: int, s: SSMConfig,
                   dtype=torch.float32,
                   device: Optional[torch.device] = None) -> SSMState:
    dd = mamba_dims(d_model, s)
    return SSMState(
        conv=torch.zeros((batch, s.conv_width - 1, dd["conv_ch"]),
                         dtype=dtype, device=device),
        s=torch.zeros((batch, dd["H"], dd["N"], dd["P"]),
                      dtype=torch.float32, device=device),
    )


def mamba2_decode(p: Dict[str, Any], d_model: int, s: SSMConfig,
                  x: torch.Tensor, state: SSMState
                  ) -> Tuple[torch.Tensor, SSMState]:
    """x (B,1,d) -> (y (B,1,d), state), the new conv ring and SSD state
    written into ``state`` in place."""
    z, xin, Bm, Cm, dt, dd = _split_proj(p, x, d_model, s)
    H, P, N, G = dd["H"], dd["P"], dd["N"], dd["G"]
    B = x.shape[0]
    xbc = torch.cat([xin, Bm, Cm], dim=-1)[:, 0]              # (B,ch)
    # conv ring step; buf is a new tensor, so the shift below copies
    # between two storages, never within the ring
    buf = torch.cat([state.conv, xbc[:, None, :].to(state.conv.dtype)],
                    dim=1)                                    # (B,W,ch)
    conv_out = torch.einsum("bwc,wc->bc", buf.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    conv_out = F.silu(conv_out).to(x.dtype)
    state.conv.copy_(buf[:, 1:, :])
    xin = conv_out[:, :dd["d_in"]].reshape(B, H, P)
    Bm = conv_out[:, dd["d_in"]:dd["d_in"] + G * N].reshape(B, G, N)
    Cm = conv_out[:, dd["d_in"] + G * N:].reshape(B, G, N)
    rep = H // G
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])         # (B,H)
    a = torch.exp(dt1 * (-torch.exp(p["A_log"])))             # (B,H)
    u = xin.float() * dt1[..., None]                          # (B,H,P)
    # group g's B and C serve its rep heads by broadcasting over a
    # (B,G,rep,...) view, the values JAX's repeat gives
    outer = Bm.float()[:, :, None, :, None] * u.view(B, G, rep, 1, P)
    s_new = a[..., None, None] * state.s + outer.view(B, H, N, P)
    state.s.copy_(s_new)
    y = torch.einsum("bgn,bgrnp->bgrp", Cm.float(),
                     s_new.view(B, G, rep, N, P)).reshape(B, H, P)
    y = y + xin.float() * p["D"][:, None]
    y = y.reshape(B, 1, dd["d_in"]).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    return shard(torch.matmul(y, p["out_proj"]), "batch", "seq",
                 "embed_act"), state
