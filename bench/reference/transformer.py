"""The plain reference of the decoder-only configurations: a full
forward pass over one sequence, layer by layer, in float32 with TF32
off, with no kernel, cache or batching.

This module holds the blocks (norms, rotary positions, causal
attention, grouped-query and latent attention, SwiGLU, routed experts);
each architecture's ``configs/<model_type>.py`` puts them together in its
``hidden`` (the departures from the published model that its
configuration file lists under ``departures`` included), and reads the
weights in the layout the benchmark draws them (``benchkit/weights.py``).

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (weights per tensor, activations per row, each scaled to
the format's range; gradients pass the rounding unchanged), the rest
unchanged.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch

import configs

E4M3_MAX = 448.0
QUERY_BLOCK = 1024


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to e4m3 after scaling its largest magnitude (per
    tensor, or per slice along ``dim``) to the format's largest."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    s = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """Rounds the operands of every product (identity in fp32)."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.fp8 = name == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _through(t, _fp8(t, None)) if self.fp8 else t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        return _through(t, _fp8(t, -1)) if self.fp8 else t


def _through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q``'s values with ``x``'s gradient (a straight-through rounding)."""
    return x + (q - x).detach()


def layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, rot: int, theta: float
         ) -> torch.Tensor:
    """Rotate the leading ``rot`` dims of ``x`` (S, ..., dim): dim i with
    dim i + rot/2, angle pos * theta ** (-2i / rot) (in float64)."""
    half = rot // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=torch.float64,
                                        device=x.device) / rot)
    ang = pos.double()[:, None] * inv                     # (S, half)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
    cos, sin = (f(ang).float().reshape(shape) for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     dim=-1)


def mm(pr: Precision, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w, w's leading dims (k in all) flattened into the
    contraction and the rest into the output."""
    return pr.a(x) @ pr.w(w.reshape(x.shape[-1], -1))


def causal(pr: Precision, q, k, v, scale: float) -> torch.Tensor:
    """q (S,H,D), k (S,Hkv,D), v (S,Hkv,Dv) -> (S,H,Dv), causal, in
    blocks of queries."""
    S, H = q.shape[:2]
    G = H // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    q, k, v = pr.a(q), pr.a(k), pr.a(v)
    out = []
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        allowed = (torch.arange(a, b, device=q.device)[:, None]
                   >= torch.arange(b, device=q.device)[None, :])
        s = torch.where(allowed, s, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:b]))
    return torch.cat(out)


def gqa(pr, p, h, pos, heads: int, kv_heads: int, rot: int, theta: float):
    """Grouped-query attention of ``h`` (S, d): heads of d / ``heads``
    dims, rotary positions on the leading ``rot`` of each, scale
    1/sqrt(head dims)."""
    S, d = h.shape
    hd = d // heads
    q = mm(pr, h, p["wq"]).view(S, heads, hd)
    k = mm(pr, h, p["wk"]).view(S, kv_heads, hd)
    v = mm(pr, h, p["wv"]).view(S, kv_heads, hd)
    q, k = rope(q, pos, rot, theta), rope(k, pos, rot, theta)
    o = causal(pr, q, k, v, 1.0 / math.sqrt(hd))
    return mm(pr, o.reshape(S, -1), p["wo"])


def mla(pr, p, h, pos, heads: int, nope: int, rot: int, v_dim: int,
        theta: float, eps: float):
    """Multi-head latent attention of ``h`` (S, d) without query
    compression: keys and values expanded from the RMS-normed latent
    ``c_kv``, a rotary key of ``rot`` dims shared by the heads, scale
    1/sqrt(nope + rot)."""
    S = h.shape[0]
    q = mm(pr, h, p["wq"]).view(S, heads, nope + rot)
    q_rope = rope(q[..., nope:], pos, rot, theta)
    c = rms_norm(mm(pr, h, p["w_dkv"]), p["kv_norm"], eps)
    k_rope = rope(mm(pr, h, p["w_krope"]), pos, rot, theta)   # (S, rot)
    k_nope = mm(pr, c, p["w_uk"]).view(S, heads, nope)
    v = mm(pr, c, p["w_uv"]).view(S, heads, v_dim)
    qf = torch.cat([q[..., :nope], q_rope], -1)
    kf = torch.cat([k_nope, k_rope[:, None, :].expand(S, heads, rot)], -1)
    o = causal(pr, qf, kf, v, 1.0 / math.sqrt(nope + rot))
    return mm(pr, o.reshape(S, -1), p["wo"])


def swiglu(pr, p, x):
    g = mm(pr, x, p["wi_gate"])
    u = mm(pr, x, p["wi_up"])
    return mm(pr, torch.nn.functional.silu(g) * u, p["wo"])


def moe(pr, p, x, top_k: int):
    """Routed experts plus the shared ones: softmax over the experts, the
    ``top_k`` largest kept with their probabilities as weights (not
    renormalised); no token dropped."""
    probs = torch.softmax(mm(pr, x, p["router"]), dim=-1)         # (S, E)
    w, idx = torch.topk(probs, top_k, dim=-1)
    y = swiglu(pr, p["shared"], x)
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        pe = {k: p[k][e] for k in ("wi_gate", "wi_up", "wo")}
        y.index_add_(0, rows, swiglu(pr, pe, x[rows]) * w[rows, slot, None])
    return y


def embed(pr: Precision, params, tokens: torch.Tensor) -> torch.Tensor:
    """The float32 embedding rows of ``tokens`` (S,)."""
    return pr.w(params["embed"]["table"][tokens.long()])


def layer(tree, j: int):
    """Layer ``j`` of a tree of stacked layers."""
    if isinstance(tree, dict):
        return {k: layer(v, j) for k, v in tree.items()}
    return tree[j]


def checkpointed(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward with ``remat``."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def hidden(params: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor,
           precision: str = "fp32", remat: bool = False) -> torch.Tensor:
    """Float32 final hidden states (S, d) of the sequence ``tokens`` (S,),
    after the final norm, by the configuration's architecture;
    differentiable, each layer recomputed in the backward with
    ``remat``."""
    return configs.arch(cfg).hidden(params, cfg, tokens, Precision(precision),
                                    remat)


def head(params, h: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    return mm(Precision(precision), h, params["lm_head"]["w"])


@torch.no_grad()
def logits(params: Dict[str, Any], cfg: Dict[str, Any],
           tokens: torch.Tensor, start: int, precision: str = "fp32"
           ) -> torch.Tensor:
    """Float32 logits (S - start, padded vocab) at positions start..S-1
    of the sequence ``tokens`` (S,)."""
    with exact_float32():
        h = hidden(params, cfg, tokens, precision)
        return head(params, h[start:], precision)
