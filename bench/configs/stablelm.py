"""``stablelm`` (StableLM 2): pre-LayerNorm blocks (scale and bias),
grouped-query attention with rotary positions on the leading
``partial_rotary_factor`` of each head's dims (dim i paired with dim
i + rot/2), a SwiGLU MLP, a final LayerNorm and an untied head."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from benchkit import weights as W
from reference import transformer as T

RUNS_AS = {"hidden_act": "silu", "use_qkv_bias": False,
           "qk_layernorm": False, "use_parallel_residual": False,
           "rope_scaling": None, "tie_word_embeddings": False}


def _rot(cfg: Dict[str, Any]) -> int:
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    rot = int(hd * float(cfg["partial_rotary_factor"]))
    return rot - rot % 2


def leaves(cfg: Dict[str, Any]) -> List[W.Leaf]:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    st = (L,)
    return (W.embedding_and_head(cfg) + W.norm("final_norm", d, (), True)
            + W.norm("layers/ln1", d, st, True)
            + W.gqa("layers/attn", d, H, Hkv, st, L)
            + W.norm("layers/ln2", d, st, True)
            + W.mlp("layers/mlp", d, cfg["intermediate_size"], st, L))


def hidden(params, cfg: Dict[str, Any], tokens, pr: T.Precision,
           remat: bool):
    eps = float(cfg["layer_norm_eps"])
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    rot, theta = _rot(cfg), float(cfg["rope_theta"])
    x = T.embed(pr, params, tokens)
    pos = torch.arange(tokens.shape[0], device=tokens.device)

    def block(p, x):
        x = x + T.gqa(pr, p["attn"], T.layer_norm(x, p["ln1"], eps), pos,
                      H, Hkv, rot, theta)
        return x + T.swiglu(pr, p["mlp"], T.layer_norm(x, p["ln2"], eps))

    for j in range(cfg["num_hidden_layers"]):
        p = T.layer(params["layers"], j)
        x = T.checkpointed(remat, lambda x, p=p: block(p, x), x)
    return T.layer_norm(x, params["final_norm"], eps)


def matmul_params(cfg: Dict[str, Any]) -> int:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, Hkv = d // H, cfg["num_key_value_heads"]
    attn = 2 * d * H * hd + 2 * d * Hkv * hd
    return cfg["num_hidden_layers"] * (attn + 3 * d * cfg["intermediate_size"])


def attention(cfg: Dict[str, Any]) -> Tuple[int, int, int, int, int]:
    """(layers with attention, heads, kv heads, score dims, value dims)."""
    H = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // H
    return (cfg["num_hidden_layers"], H, cfg["num_key_value_heads"], hd, hd)


def port_model(cfg: Dict[str, Any], port, common: Dict[str, Any]):
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    attn = port.AttentionConfig(
        kind="full", num_heads=H, num_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // H, rope_theta=float(cfg["rope_theta"]),
        rope_fraction=float(cfg["partial_rotary_factor"]))
    return port.ModelConfig(family="dense", d_ff=cfg["intermediate_size"],
                            norm="layernorm",
                            norm_eps=float(cfg["layer_norm_eps"]),
                            attention=attn, **common)
