"""Model FLOPs of a configuration, from its published keys: the products
a token needs (two operations per multiply-add), without the embedding
lookup and without recomputation.  What each architecture counts comes
from its module (``configs/<model_type>.py``):

- ``matmul_params``: the weights a token multiplies by in the layers
  (routed experts: only its ``num_experts_per_tok``, plus the shared
  ones and the router), not the head.
- ``attention``: the layers with attention, the heads and each head's
  score and value dims (latent attention at its expanded dims), for the
  scores and values over ``ctx`` keys.
- The head once per token that yields logits.
"""
from __future__ import annotations

from typing import Any, Dict

import configs
from roofline import peaks


def matmul_params(cfg: Dict[str, Any]) -> int:
    return configs.arch(cfg).matmul_params(cfg)


def head_flops(cfg: Dict[str, Any]) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def attention_flops(cfg: Dict[str, Any], pairs: int) -> int:
    """Scores and values over ``pairs`` (query, key) pairs, all layers."""
    layers, heads, _, score, value = configs.arch(cfg).attention(cfg)
    return 2 * pairs * heads * (score + value) * layers


def decode_token_flops(cfg: Dict[str, Any], ctx: int) -> int:
    """One decoded token that attends to ``ctx`` keys (itself included)."""
    return (2 * matmul_params(cfg) + attention_flops(cfg, ctx)
            + head_flops(cfg))


def prefill_flops(cfg: Dict[str, Any], S: int) -> int:
    """A prompt of S tokens, causal, with logits at its last position."""
    return (2 * matmul_params(cfg) * S + attention_flops(cfg, S * (S + 1) // 2)
            + head_flops(cfg))


def mfu_percent(flops: float, seconds: float) -> float:
    """``flops`` in ``seconds`` as a share of the H100's bf16 peak."""
    return 100.0 * flops / (seconds * peaks.BF16_FLOP_PER_S)
