"""xLSTM blocks (arXiv:2405.04517) and the xlstm-125m model: the
counterpart of ``repro/models/xlstm.py``, with the same functions,
parameter tree and state layouts.

mLSTM (matrix memory) trains in its stabilised parallel form, a linear
attention with input- and forget-gate decay whose queries are taken in
chunks of ``q_chunk`` for long sequences (a python loop replaces JAX's
``lax.scan`` over the chunks), and decodes with the O(1) recurrent
update.  sLSTM (scalar memory, recurrent matrix R) has no parallel form:
the forward runs its cell in a python loop over time, as JAX scans it.

The parameter tree is JAX's key for key: ``embed/table``,
``final_norm``, and ``blocks/{i}`` holding an mLSTM or, at the layers in
``xlstm.slstm_layers``, an sLSTM block.  The gates' ``w_i``, ``w_f``,
``b_i``, ``b_f`` (mLSTM) and every sLSTM bias are fp32 whatever
``param_dtype`` is.  The cache is ``{str(i): MLSTMState | SLSTMState}``
with the batch on axis 0: fp32 states whose stabiliser ``m`` starts at
-1e30, and a conv ring of the last ``conv_width - 1`` inputs in
``cfg.dtype``.  The decode step writes it in place.

The JAX package has no Pallas kernel for xLSTM, so neither has the port:
it runs PyTorch ops on the card as on the CPU.  On DTensors the mLSTM's
parallel form, the sLSTM's loop and the convolutions run on each rank's
batch rows and heads (``models/sharded.py``); the dry run traces the
sLSTM's loop for a bounded number of steps (:func:`bounded_recurrence`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import sharded
from repro_torch.models.attention import _project
from repro_torch.models.common import (ParamInit, checkpointed, shard,
                                       to_dtype)
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       init_embedding, init_norm,
                                       logits_from_hidden)

_NEG_INF = -2.0e38  # fp32-safe mask value, as in the JAX module
Params = Dict[str, Any]


def _conv_silu(xc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time (front-padded, shifted copies
    summed in xc's dtype), then SiLU in fp32."""
    if isinstance(xc, DTensor):
        return sharded.depthwise(_conv_silu, xc, w, b)
    W, T = w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xc)
    for k in range(W):
        out = out + pad[:, k:k + T, :] * w[k]
    return F.silu((out + b).float()).to(xc.dtype)


def _conv_step(buf: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The conv's output at the newest of the W inputs in ``buf`` (B,W,c),
    in fp32 before the SiLU."""
    return torch.einsum("bwc,wc->bc", buf.float(), w.float()) + b.float()


def _head_groupnorm(h: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """h (B,T,H,hd) normalised per head (population variance, fp32),
    flattened to (B,T,H*hd) and scaled; returns fp32."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = h32.var(-1, keepdim=True, unbiased=False)
    y = (h32 - mu) * torch.rsqrt(var + eps)
    # the heads whole on every rank in the gradient too: its unflatten
    # back to (H, hd) cannot take a split H does not divide
    return shard(y.flatten(-2), "batch", "seq", None) * scale.float()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B,H,hd,hd) matrix memory
    n: torch.Tensor     # (B,H,hd)
    m: torch.Tensor     # (B,H) stabiliser
    conv: torch.Tensor  # (B,W-1,dc)


def _mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm
    dc = int(cfg.d_model * x.proj_factor_mlstm)
    H = x.num_heads
    return dc, H, dc // H


def init_mlstm(pi: ParamInit, path: str, cfg: ModelConfig) -> None:
    x, d = cfg.xlstm, cfg.d_model
    dc, H, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    init_norm(pi, f"{path}/norm", d, cfg.norm)
    pi.param(f"{path}/w_up", (d, 2 * dc), ("embed", "mlp"))
    pi.param(f"{path}/conv_w", (x.conv_width, dc), (None, "mlp"))
    pi.param(f"{path}/conv_b", (dc,), ("mlp",), init="zeros")
    for nm in ("wq", "wk", "wv"):
        pi.param(f"{path}/{nm}", (dc, H, hd), ("mlp", "heads", "head_dim"))
    pi.param(f"{path}/w_i", (dc, H), ("mlp", "heads"), dtype=f32)
    pi.param(f"{path}/w_f", (dc, H), ("mlp", "heads"), dtype=f32)
    pi.param(f"{path}/b_i", (H,), ("heads",), init="zeros", dtype=f32)
    pi.param(f"{path}/b_f", (H,), ("heads",), init="ones", dtype=f32)
    pi.param(f"{path}/out_norm", (dc,), ("mlp",), init="ones")
    pi.param(f"{path}/w_down", (dc, d), ("mlp", "embed"))


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logf: torch.Tensor, logi: torch.Tensor,
                   q_chunk: int = 2048) -> torch.Tensor:
    """Stabilised parallel mLSTM.  q, k, v (B,T,H,hd); logf, logi (B,T,H)
    fp32.  Returns h (B,T,H,hd) in q's dtype.  When T is a multiple of
    ``q_chunk`` above it, the queries go in chunks of ``q_chunk`` (peak
    memory O(q_chunk * T)), as in JAX.  On DTensors it runs on each
    rank's batch rows and heads (``models/sharded.py``)."""
    if isinstance(q, DTensor):
        return sharded.batch_heads(
            lambda *t: mlstm_parallel(*t, q_chunk=q_chunk),
            q, k, v, logf, logi)
    B, T, H, hd = q.shape
    cumf = torch.cumsum(logf, dim=1)                          # (B,T,H)
    scale = 1.0 / math.sqrt(hd)
    k32, v32 = k.float(), v.float()
    keys = torch.arange(T, device=q.device)

    def block(qc, q_pos, cumf_q):
        d = (cumf_q[:, :, None, :] - cumf[:, None, :, :]
             + logi[:, None, :, :])                           # (B,c,T,H)
        mask = q_pos[:, None] >= keys[None, :]                # (c,T)
        d = torch.where(mask[None, :, :, None], d, _NEG_INF)
        m = d.amax(dim=2, keepdim=True)                       # (B,c,1,H)
        dexp = torch.exp(d - m)
        qk = torch.einsum("bchd,bthd->bcth", qc.float(), k32) * scale
        S = qk * dexp
        n = torch.maximum(S.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
        hout = torch.einsum("bcth,bthd->bchd", S, v32)
        return hout / n[..., None]

    if T > q_chunk and T % q_chunk == 0:
        h = torch.cat([block(q[:, s:s + q_chunk], keys[s:s + q_chunk],
                             cumf[:, s:s + q_chunk])
                       for s in range(0, T, q_chunk)], dim=1)
    else:
        h = block(q, keys, cumf)
    return h.to(q.dtype)


def _mlstm_gates(p: Params, xc: torch.Tensor):
    """(logi, logf) of conv output ``xc`` (..., dc), in fp32."""
    x32 = xc.float()
    # (B,T,H) gates constrained like the heads: DTensor would otherwise
    # split a few heads' gates along the sequence
    axes = ("batch", "seq", "heads_act")[-x32.ndim:]
    logi = shard(torch.matmul(x32, p["w_i"]) + p["b_i"], *axes)
    zf = shard(torch.matmul(x32, p["w_f"]) + p["b_f"], *axes)
    # DTensor has no rule for log_sigmoid; -softplus(-z) is the same
    # function
    logf = -F.softplus(-zf) if isinstance(zf, DTensor) else F.logsigmoid(zf)
    return logi, logf


def _mlstm_out(p: Params, x: torch.Tensor, h: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    hn = _head_groupnorm(h, p["out_norm"])
    y = shard((hn * F.silu(z.float())).to(x.dtype), "batch", "seq",
              "mlp_act")
    return x + shard(torch.matmul(y, p["w_down"]), "batch", "seq",
                     "embed_act")


def apply_mlstm(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    dc, _, _ = _mlstm_dims(cfg)
    r = apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    up = shard(torch.matmul(r, p["w_up"]), "batch", "seq", "mlp_act")
    xi, z = up[..., :dc], up[..., dc:]
    xc = _conv_silu(xi, p["conv_w"], p["conv_b"])
    q, k = _project(xc, p["wq"]), _project(xc, p["wk"])
    v = _project(xi, p["wv"])
    logi, logf = _mlstm_gates(p, xc)
    return _mlstm_out(p, x, mlstm_parallel(q, k, v, logf, logi), z)


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = None) -> MLSTMState:
    dc, H, hd = _mlstm_dims(cfg)
    dev = resolve_device(device)
    W = cfg.xlstm.conv_width
    f32 = dict(dtype=torch.float32, device=dev)
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), **f32),
        n=torch.zeros((batch, H, hd), **f32),
        m=torch.full((batch, H), -1e30, **f32),
        conv=torch.zeros((batch, W - 1, dc), dtype=to_dtype(cfg.dtype),
                         device=dev))


def mlstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 st: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B,1,d) -> (out (B,1,d), st), the new state written into ``st``
    in place."""
    dc, H, hd = _mlstm_dims(cfg)
    r = apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    up = torch.matmul(r, p["w_up"])
    xi, z = up[..., :dc], up[..., dc:]
    # a new tensor: the shift below copies between two storages
    buf = torch.cat([st.conv, xi[:, :1].to(st.conv.dtype)], dim=1)
    xc = F.silu(_conv_step(buf, p["conv_w"], p["conv_b"])).to(x.dtype)
    xc = xc[:, None, :]
    q = _project(xc, p["wq"])[:, 0].float()
    k = _project(xc, p["wk"])[:, 0].float()
    v = _project(xi, p["wv"])[:, 0].float()
    logi, logf = _mlstm_gates(p, xc[:, 0])
    m_new = torch.maximum(logf + st.m, logi)
    fg = torch.exp(logf + st.m - m_new)
    ig = torch.exp(logi - m_new)
    scale = 1.0 / math.sqrt(hd)
    C = fg[..., None, None] * st.C + ig[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", v, k)
    n = fg[..., None] * st.n + ig[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q) * scale
    den = torch.maximum((torch.einsum("bhe,bhe->bh", n, q) * scale).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None])[:, None]                       # (B,1,H,hd)
    out = _mlstm_out(p, x, h.to(x.dtype), z)
    for dst, src in ((st.C, C), (st.n, n), (st.m, m_new),
                     (st.conv, buf[:, 1:])):
        dst.copy_(src)
    return out, st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B,H,hd)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor     # (B,H,hd) stabiliser
    conv: torch.Tensor  # (B,W-1,d)


def _slstm_dims(cfg: ModelConfig):
    H = cfg.xlstm.num_heads
    return H, cfg.d_model // H


def init_slstm(pi: ParamInit, path: str, cfg: ModelConfig) -> None:
    x, d = cfg.xlstm, cfg.d_model
    H, hd = _slstm_dims(cfg)
    dff = int(d * x.proj_factor_slstm)
    init_norm(pi, f"{path}/norm", d, cfg.norm)
    pi.param(f"{path}/conv_w", (x.conv_width, d), (None, "embed"))
    pi.param(f"{path}/conv_b", (d,), ("embed",), init="zeros")
    for g in ("i", "f", "z", "o"):
        pi.param(f"{path}/w_{g}", (d, H, hd), ("embed", "heads", "head_dim"))
        pi.param(f"{path}/r_{g}", (H, hd, hd), ("heads", "head_dim", None))
        pi.param(f"{path}/b_{g}", (H, hd), ("heads", "head_dim"),
                 dtype=torch.float32,
                 init="ones" if g == "f" else "zeros")
    pi.param(f"{path}/out_norm", (d,), ("embed",), init="ones")
    # post-block gated FFN (proj factor 4/3)
    pi.param(f"{path}/ffn_norm", (d,), ("embed",), init="ones")
    pi.param(f"{path}/w_up", (d, 2 * dff), ("embed", "mlp"))
    pi.param(f"{path}/w_down", (dff, d), ("mlp", "embed"))


def _slstm_gate_inputs(p: Params, xc: torch.Tensor, r: torch.Tensor):
    """Per-gate inputs (B,T,H,hd) in fp32: i and f from the conv output,
    z and o from the normed input."""
    return {g: _project(src, p[f"w_{g}"]).float()
            for g, src in (("i", xc), ("f", xc), ("z", r), ("o", r))}


def _slstm_cell(p: Params, xt: Dict[str, torch.Tensor], c, n, h, m):
    """One sLSTM step on fp32 (B,H,hd) states; returns (c, n, h, m)."""
    def pre(g):
        rec = torch.einsum("bhd,hde->bhe", h, p[f"r_{g}"].float())
        return xt[g] + rec + p[f"b_{g}"]
    zi, zf, zz, zo = pre("i"), pre("f"), pre("z"), pre("o")
    m_new = torch.maximum(zf + m, zi)
    ig = torch.exp(zi - m_new)
    fg = torch.exp(zf + m - m_new)
    c = fg * c + ig * torch.tanh(zz)
    n = fg * n + ig
    h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def _slstm_out(p: Params, cfg: ModelConfig, x: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """The block after the cell: head norm, residual and the gated FFN
    (GELU, tanh form as ``jax.nn.gelu``'s default)."""
    hn = _head_groupnorm(h.to(x.dtype), p["out_norm"]).to(x.dtype)
    y = x + shard(hn, "batch", "seq", "embed_act")
    rn = apply_norm({"scale": p["ffn_norm"]}, y, "rmsnorm", cfg.norm_eps)
    up = shard(torch.matmul(rn, p["w_up"]), "batch", "seq", "mlp_act")
    dff = up.shape[-1] // 2
    gelu = F.gelu(up[..., :dff].float(), approximate="tanh").to(x.dtype)
    h = shard(gelu * up[..., dff:], "batch", "seq", "mlp_act")
    return y + shard(torch.matmul(h, p["w_down"]), "batch", "seq",
                     "embed_act")


def apply_slstm(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    H, hd = _slstm_dims(cfg)
    B, T, _ = x.shape
    r = apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    xc = _conv_silu(r, p["conv_w"], p["conv_b"])
    gates = _slstm_gate_inputs(p, xc, r)
    cell = {f"{w}_{g}": p[f"{w}_{g}"] for w in "rb" for g in "ifzo"}
    args = [gates[g] for g in "ifzo"] + [cell[k] for k in sorted(cell)]
    if isinstance(x, DTensor):
        hs = sharded.heads_scan(
            lambda *t: _slstm_scan(*t, keys=sorted(cell)), *args)
    else:
        hs = _slstm_scan(*args, keys=sorted(cell))
    return _slstm_out(p, cfg, x, hs)


def _slstm_scan(gi, gf, gz, go, *weights, keys) -> torch.Tensor:
    """The sLSTM's loop over time from zero states: gates (B,T,H,hd) fp32
    and the cell's ``r_*`` (H,hd,hd) and ``b_*`` (H,hd) weights (named
    by ``keys``) -> h at every step (B,T,H,hd)."""
    p = dict(zip(keys, weights))
    gates = {"i": gi, "f": gf, "z": gz, "o": go}
    B, T, H, hd = gi.shape
    c, n, h = (gi.new_zeros((B, H, hd)) for _ in range(3))
    m = torch.full((B, H, hd), -1e30, dtype=torch.float32, device=gi.device)
    bound = getattr(_BOUND, "state", None)
    steps = T if bound is None else min(T, bound[0])
    if steps < T:
        _count_as(bound, steps, T, gates)
    hs = []
    for t in range(steps):
        c, n, h, m = _slstm_cell(p, {g: v[:, t] for g, v in gates.items()},
                                 c, n, h, m)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if steps < T:
        hs = _count_as(bound, steps, T, hs, end=True)
        hs = torch.cat([hs, h[:, None].expand(B, T - steps, H, hd)], dim=1)
    return hs


# ---------------------------------------------------------------------------
# bounded recurrence, for the dry run
# ---------------------------------------------------------------------------

_BOUND = threading.local()


@contextlib.contextmanager
def bounded_recurrence(steps: int, counter):
    """Within this context :func:`apply_slstm` runs at most ``steps``
    steps of its loop over time and has ``counter`` (the dry run's
    ``TraceCounter``, which counts under its ``scale``) count them as
    the whole sequence's, T / steps each; the steps after them repeat
    the last output.  Only the dry run enters it: its trace of 4,096 or
    32,768 steps would take hours and its numbers are not used.  The
    yielded dict gets the steps traced and the steps they stand for."""
    prev = getattr(_BOUND, "state", None)
    info = {"traced": 0, "total": 0}
    _BOUND.state = (steps, counter, info)
    try:
        yield info
    finally:
        _BOUND.state = prev


def _count_as(bound, steps: int, T: int, x, end: bool = False):
    """Scale ``counter`` by T / steps from the loop's start to its end,
    in the forward and (through hooks on the loop's inputs and output)
    in the backward, which runs the loop's steps in reverse."""
    _, counter, info = bound
    f = T / steps

    def scale(on: bool):
        counter.scale = counter.scale * f if on else counter.scale / f

    if not end:
        info["traced"] += steps
        info["total"] += T
        scale(True)
        for g in x.values():
            if g.requires_grad:
                g.register_hook(lambda grad: (scale(False), grad)[1])
                break
        return x
    scale(False)
    if x.requires_grad:
        x.register_hook(lambda grad: (scale(True), grad)[1])
    return x


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = None) -> SLSTMState:
    H, hd = _slstm_dims(cfg)
    dev = resolve_device(device)
    W = cfg.xlstm.conv_width
    f32 = dict(dtype=torch.float32, device=dev)
    return SLSTMState(
        c=torch.zeros((batch, H, hd), **f32),
        n=torch.zeros((batch, H, hd), **f32),
        h=torch.zeros((batch, H, hd), **f32),
        m=torch.full((batch, H, hd), -1e30, **f32),
        conv=torch.zeros((batch, W - 1, cfg.d_model),
                         dtype=to_dtype(cfg.dtype), device=dev))


def slstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """x (B,1,d) -> (out (B,1,d), st), the new state written into ``st``
    in place."""
    r = apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    buf = torch.cat([st.conv, r[:, :1].to(st.conv.dtype)], dim=1)
    xc = F.silu(_conv_step(buf, p["conv_w"], p["conv_b"])).to(x.dtype)
    gates = _slstm_gate_inputs(p, xc[:, None], r)
    new = _slstm_cell(p, {g: v[:, 0] for g, v in gates.items()},
                      st.c, st.n, st.h, st.m)
    out = _slstm_out(p, cfg, x, new[2][:, None])
    for dst, src in zip(st, new + (buf[:, 1:],)):
        dst.copy_(src)
    return out, st


# ---------------------------------------------------------------------------
# xlstm-125m model assembly
# ---------------------------------------------------------------------------

def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return i in cfg.xlstm.slstm_layers


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None,
                with_axes: bool = False) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (the gates' weights and
    biases named above in fp32), each leaf drawn where ``generator``
    lives and moved to ``device`` before the next."""
    pi = ParamInit(generator, to_dtype(cfg.param_dtype),
                   resolve_device(device))
    init_embedding(pi, cfg)
    for i in range(cfg.num_layers):
        (init_slstm if _is_slstm(cfg, i) else init_mlstm)(
            pi, f"blocks/{i}", cfg)
    init_norm(pi, "final_norm", cfg.d_model, cfg.norm)
    return pi.build() if with_axes else pi.params


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            remat: str = "layer") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V), aux loss 0).  Under grad with
    ``remat != "none"`` each mLSTM and sLSTM block is checkpointed, as in
    the reference (:func:`~repro_torch.models.common.checkpointed`)."""
    x = embed_tokens(params, cfg, tokens)
    for i in range(cfg.num_layers):
        block = apply_slstm if _is_slstm(cfg, i) else apply_mlstm
        x = checkpointed(remat, block, params["blocks"][str(i)], cfg, x)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return (logits_from_hidden(params, cfg, x),
            x.new_zeros((), dtype=torch.float32))


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device: DeviceLike = None):
    """{str(i): fresh state of layer i}.  ``capacity`` and ``dtype`` are
    taken for the API's sake: the states are O(1) in the sequence and
    fp32, the conv rings in ``cfg.dtype``, as in JAX."""
    return {str(i): (init_slstm_state if _is_slstm(cfg, i)
                     else init_mlstm_state)(cfg, batch, device)
            for i in range(cfg.num_layers)}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache):
    """tokens (B,1); ``pos`` is unused (the states carry the sequence).
    Returns (logits (B,1,V), cache), the cache written in place."""
    x = embed_tokens(params, cfg, tokens)
    for i in range(cfg.num_layers):
        step = slstm_decode if _is_slstm(cfg, i) else mlstm_decode
        x, _ = step(params["blocks"][str(i)], cfg, x, cache[str(i)])
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache
