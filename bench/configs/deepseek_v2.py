"""``deepseek_v2`` (DeepSeek-V2): pre-RMSNorm blocks, multi-head latent
attention (queries without compression; keys and values expanded from
the RMS-normed latent ``c_kv``, a rotary key of ``qk_rope_head_dim``
dims shared by the heads, scale 1/sqrt(nope + rope)), the first
``first_k_dense_replace`` layers with a dense SwiGLU MLP and the rest
with ``n_routed_experts`` experts (softmax over the experts, the
``num_experts_per_tok`` largest kept with their probabilities as
weights, not renormalised) plus the shared experts, a final RMSNorm and
an untied head.  The harness serves it only where no routed token is
dropped (``capacity_factor``)."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from benchkit import weights as W
from reference import transformer as T

RUNS_AS = {"hidden_act": "silu", "rope_scaling": None, "q_lora_rank": None,
           "attention_bias": False, "scoring_func": "softmax",
           "topk_method": "greedy", "norm_topk_prob": False, "n_group": 1,
           "topk_group": 1, "routed_scaling_factor": 1, "moe_layer_freq": 1,
           "tie_word_embeddings": False}


def leaves(cfg: Dict[str, Any]) -> List[W.Leaf]:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, f = cfg["num_attention_heads"], cfg["moe_intermediate_size"]
    n_lead = cfg["first_k_dense_replace"]

    def attn(path, stack):
        return W.mla(path, d, H, cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"], stack, L)

    out = W.embedding_and_head(cfg) + W.norm("final_norm", d, (), False)
    for i in range(n_lead):
        out += W.norm(f"lead/{i}/ln1", d, (), False) + attn(f"lead/{i}/attn",
                                                            ())
        out += W.norm(f"lead/{i}/ln2", d, (), False)
        out += W.mlp(f"lead/{i}/mlp", d, cfg["intermediate_size"], (), L)
    st = (L - n_lead,)
    out += W.norm("layers/ln1", d, st, False) + attn("layers/attn", st)
    out += W.norm("layers/ln2", d, st, False)
    out += W.moe("layers/moe", d, cfg["n_routed_experts"], f,
                 cfg["n_shared_experts"] * f, st, L)
    return out


def hidden(params, cfg: Dict[str, Any], tokens, pr: T.Precision,
           remat: bool):
    eps = float(cfg["rms_norm_eps"])
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rot, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    theta, k = float(cfg["rope_theta"]), cfg["num_experts_per_tok"]
    n_lead = cfg["first_k_dense_replace"]
    x = T.embed(pr, params, tokens)
    pos = torch.arange(tokens.shape[0], device=tokens.device)

    def block(p, routed, x):
        x = x + T.mla(pr, p["attn"], T.rms_norm(x, p["ln1"]["scale"], eps),
                      pos, H, nope, rot, vd, theta, eps)
        h = T.rms_norm(x, p["ln2"]["scale"], eps)
        return x + (T.moe(pr, p["moe"], h, k) if routed
                    else T.swiglu(pr, p["mlp"], h))

    for i in range(cfg["num_hidden_layers"]):
        routed = i >= n_lead
        p = T.layer(params["layers"], i - n_lead) if routed \
            else params["lead"][str(i)]
        x = T.checkpointed(remat, lambda x, p=p, r=routed: block(p, r, x), x)
    return T.rms_norm(x, params["final_norm"]["scale"], eps)


def _attn_params(cfg: Dict[str, Any]) -> int:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    R, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return (d * H * (nope + rope) + d * (R + rope) + R * H * (nope + vd)
            + H * vd * d)


def matmul_params(cfg: Dict[str, Any]) -> int:
    """The weights a token multiplies by in the layers: its
    ``num_experts_per_tok`` routed experts, the shared ones and the
    router."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_lead, f = cfg["first_k_dense_replace"], cfg["moe_intermediate_size"]
    attn = _attn_params(cfg)
    routed = (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) \
        * 3 * d * f + d * cfg["n_routed_experts"]
    return (n_lead * (attn + 3 * d * cfg["intermediate_size"])
            + (L - n_lead) * (attn + routed))


def attention(cfg: Dict[str, Any]) -> Tuple[int, int, int, int, int]:
    """(layers with attention, heads, kv heads, score dims, value dims):
    latent attention counted at its expanded per-head dims."""
    H = cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], H, H,
            cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def port_model(cfg: Dict[str, Any], port, common: Dict[str, Any]):
    f = cfg["moe_intermediate_size"]
    mla = port.MLAConfig(kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=0,
                         qk_nope_head_dim=cfg["qk_nope_head_dim"],
                         qk_rope_head_dim=cfg["qk_rope_head_dim"],
                         v_head_dim=cfg["v_head_dim"])
    attn = port.AttentionConfig(
        kind="mla", num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"],
        rope_theta=float(cfg["rope_theta"]), mla=mla)
    moe = port.MoEConfig(num_experts=cfg["n_routed_experts"],
                         num_shared=cfg["n_shared_experts"],
                         top_k=cfg["num_experts_per_tok"], d_expert=f,
                         d_shared=cfg["n_shared_experts"] * f,
                         first_dense_layers=cfg["first_k_dense_replace"],
                         dense_d_ff=cfg["intermediate_size"],
                         capacity_factor=float(cfg["capacity_factor"]))
    return port.ModelConfig(family="moe", d_ff=f, norm="rmsnorm",
                            norm_eps=float(cfg["rms_norm_eps"]),
                            attention=attn, moe=moe, **common)
