"""Tiny configurations and mixes for the harness's CPU tests: the
published keys of each ``model_type`` at a size the CPU runs in
seconds."""
import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def stablelm(dtype="bfloat16"):
    c = _load("configs", "stablelm-1.6b.json")
    c["torch_dtype"] = dtype
    c.update(name="tiny-stablelm", hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, vocab_size=512,
             serve={"rows": 4, "page_size": 16, "max_len": 256})
    return c


def deepseek():
    c = _load("configs", "deepseek-v2-lite-16b.json")
    c.update(name="tiny-deepseek", hidden_size=64, intermediate_size=96,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
             moe_intermediate_size=32, vocab_size=512,
             serve={"rows": 4, "page_size": 16, "max_len": 256})
    return c


def mix():
    t = copy.deepcopy(_load("traffic", "decode-long.json"))
    t.update(prompt_len={"dist": "loguniform", "lo": 20, "hi": 60},
             output_len={"dist": "loguniform", "lo": 4, "hi": 12},
             requests_per_client=400, check_requests=3)
    return t


def train_mix():
    t = copy.deepcopy(_load("traffic", "hfl-train.json"))
    t.update(batch=2, seq_len=24)
    return t

