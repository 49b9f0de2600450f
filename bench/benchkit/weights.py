"""Weights drawn from the seed, on the device, in the type they are
served in, in the tree layout the port's transformer takes.

Every leaf of the served type (``torch_dtype``) is a view of one buffer
filled by one ``randn`` call of a generator on the device; the router
matrices (fp32 in the port) share a second buffer.  Each leaf is then scaled in place.  The scales keep a
deep random model well conditioned: inputs of a product at 1/sqrt(fan
in), each layer's output projection further by 1/sqrt(2 L) so that the
residual stream does not grow with depth, queries and keys large enough
that attention is sharp, router logits wide enough that routing is
peaked, and norm scales and biases away from 1 and 0 so that the check
sees them.  The reference reads the same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

import configs

Leaf = Tuple[str, Tuple[int, ...], str, float]   # path, shape, kind, std

QK_STD = 1.6        # query / key projections, times 1/sqrt(fan in)
ROUTER_STD = 4.0    # router logits' spread


def padded_vocab(cfg: Dict[str, Any]) -> int:
    v = int(cfg["vocab_size"])
    return -(-v // 256) * 256


def norm(path: str, d: int, stack: Tuple[int, ...], bias: bool
         ) -> List[Leaf]:
    out = [(f"{path}/scale", stack + (d,), "scale", 0.1)]
    if bias:
        out.append((f"{path}/bias", stack + (d,), "normal", 0.1))
    return out


def mlp(path: str, d: int, ff: int, stack: Tuple[int, ...], depth: int
        ) -> List[Leaf]:
    out_std = 1 / math.sqrt(ff) / math.sqrt(2 * depth)
    return [(f"{path}/wi_gate", stack + (d, ff), "normal", 1 / math.sqrt(d)),
            (f"{path}/wi_up", stack + (d, ff), "normal", 1 / math.sqrt(d)),
            (f"{path}/wo", stack + (ff, d), "normal", out_std)]


def gqa(path: str, d: int, heads: int, kv_heads: int,
        stack: Tuple[int, ...], depth: int) -> List[Leaf]:
    hd = d // heads
    s = 1 / math.sqrt(d)
    return [(f"{path}/wq", stack + (d, heads, hd), "normal", QK_STD * s),
            (f"{path}/wk", stack + (d, kv_heads, hd), "normal", QK_STD * s),
            (f"{path}/wv", stack + (d, kv_heads, hd), "normal", s),
            (f"{path}/wo", stack + (heads, hd, d), "normal",
             1 / math.sqrt(heads * hd) / math.sqrt(2 * depth))]


def mla(path: str, d: int, heads: int, rank: int, nope: int, rope: int,
        v_dim: int, stack: Tuple[int, ...], depth: int) -> List[Leaf]:
    s, sr = 1 / math.sqrt(d), 1 / math.sqrt(rank)
    return [(f"{path}/wq", stack + (d, heads, nope + rope), "normal",
             QK_STD * s),
            (f"{path}/w_dkv", stack + (d, rank), "normal", s),
            (f"{path}/w_krope", stack + (d, rope), "normal", QK_STD * s),
            (f"{path}/kv_norm", stack + (rank,), "scale", 0.1),
            (f"{path}/w_uk", stack + (rank, heads, nope), "normal",
             QK_STD * sr),
            (f"{path}/w_uv", stack + (rank, heads, v_dim), "normal", sr),
            (f"{path}/wo", stack + (heads, v_dim, d), "normal",
             1 / math.sqrt(heads * v_dim) / math.sqrt(2 * depth))]


def moe(path: str, d: int, experts: int, ff: int, shared_ff: int,
        stack: Tuple[int, ...], depth: int) -> List[Leaf]:
    out_std = 1 / math.sqrt(ff) / math.sqrt(2 * depth)
    return ([(f"{path}/router", stack + (d, experts), "router",
              ROUTER_STD / math.sqrt(d)),
             (f"{path}/wi_gate", stack + (experts, d, ff), "normal",
              1 / math.sqrt(d)),
             (f"{path}/wi_up", stack + (experts, d, ff), "normal",
              1 / math.sqrt(d)),
             (f"{path}/wo", stack + (experts, ff, d), "normal", out_std)]
            + mlp(f"{path}/shared", d, shared_ff, stack, depth))


def embedding_and_head(cfg: Dict[str, Any]) -> List[Leaf]:
    """The embedding table and the untied head, over the padded
    vocabulary."""
    d, V = cfg["hidden_size"], padded_vocab(cfg)
    return [("embed/table", (V, d), "normal", 1.0),
            ("lm_head/w", (d, V), "normal", 1 / math.sqrt(d))]


def leaves(cfg: Dict[str, Any]) -> List[Leaf]:
    """Every leaf of the configuration's tree, by its architecture's
    module: (path, shape, kind, std).  ``kind`` is ``normal`` (N(0,
    std)), ``scale`` (1 + N(0, std)) or ``router`` (N(0, std) in fp32)."""
    return configs.arch(cfg).leaves(cfg)


def _insert(tree: Dict[str, Any], path: str, value: torch.Tensor) -> None:
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_params(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The configuration's weights from ``seed`` on ``device``: leaves in
    its ``torch_dtype`` (the served type) and fp32 routers, two
    ``randn`` calls."""
    spec = leaves(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree: Dict[str, Any] = {}
    served = DTYPES[cfg.get("torch_dtype", "bfloat16")]
    for dtype, kinds in ((served, ("normal", "scale")),
                         (torch.float32, ("router",))):
        mine = [lf for lf in spec if lf[2] in kinds]
        total = sum(math.prod(lf[1]) for lf in mine)
        if not total:
            continue
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        with torch.no_grad():
            for path, shape, kind, std in mine:
                n = math.prod(shape)
                leaf = buf[off:off + n].view(shape)
                off += n
                leaf.mul_(std)
                if kind == "scale":
                    leaf.add_(1.0)
                _insert(tree, path, leaf)
    return tree
