"""Basic layers of the port's transformer: norms, MLPs, embeddings and
the logits head, the counterparts of ``repro/models/layers.py``.

Products go to ``torch.matmul`` (the JAX package leaves them to XLA);
norm statistics and activations are taken in fp32 and cast back, as
there."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.common import ParamInit, shard


def init_norm(pi: ParamInit, path: str, dim: int, kind: str,
              stack: int = 0) -> None:
    pi.param(f"{path}/scale", (dim,), ("embed",), init="ones", stack=stack)
    if kind == "layernorm":
        pi.param(f"{path}/bias", (dim,), ("embed",), init="zeros",
                 stack=stack)


def apply_norm(p: Dict[str, Any], x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    else:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def init_mlp(pi: ParamInit, path: str, d_model: int, d_ff: int, act: str,
             stack: int = 0) -> None:
    if act == "silu":
        pi.param(f"{path}/wi_gate", (d_model, d_ff), ("embed", "mlp"),
                 stack=stack)
        pi.param(f"{path}/wi_up", (d_model, d_ff), ("embed", "mlp"),
                 stack=stack)
    else:
        pi.param(f"{path}/wi", (d_model, d_ff), ("embed", "mlp"),
                 stack=stack)
    pi.param(f"{path}/wo", (d_ff, d_model), ("mlp", "embed"), stack=stack)


def apply_mlp(p: Dict[str, Any], x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU for ``act="silu"``, a plain 2-matrix MLP for ``"gelu"``."""
    if act == "silu":
        g = shard(torch.matmul(x, p["wi_gate"]), "batch", "seq", "mlp_act")
        u = shard(torch.matmul(x, p["wi_up"]), "batch", "seq", "mlp_act")
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = shard(torch.matmul(x, p["wi"]), "batch", "seq", "mlp_act")
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "mlp_act")
    # the output constrained like the residual stream: DTensor would
    # otherwise scatter its partial sums along the sequence
    return shard(torch.matmul(h, p["wo"]), "batch", "seq", "embed_act")


def init_embedding(pi: ParamInit, cfg: ModelConfig) -> None:
    v = cfg.padded_vocab
    pi.param("embed/table", (v, cfg.d_model), ("vocab", "embed"),
             init="normal", scale=0.02)
    if not cfg.tie_embeddings:
        pi.param("lm_head/w", (cfg.d_model, v), ("embed", "vocab"))


def embed_tokens(params: Dict[str, Any], cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["table"]
    x = (sharded.embedding(table, tokens) if sharded.is_dtensor(table)
         else table[tokens.long()])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32
                             ).to(x.dtype)
    return shard(x, "batch", "seq", "embed_act")


def logits_from_hidden(params: Dict[str, Any], cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return shard(torch.matmul(x, w), "batch", "seq", "vocab_act")
