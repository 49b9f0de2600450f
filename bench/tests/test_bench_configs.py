"""Each configuration finds its architecture's module by ``model_type``;
an unknown type is refused, and so is a published value the module does
not run unless the file names it under ``departures``."""
import copy
import json

import pytest

import configs
import tiny
from benchkit.spec import ROOT

with open(ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
PARTS = ("RUNS_AS", "leaves", "hidden", "matmul_params", "attention",
         "port_model")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_its_module(name):
    file = next(c["file"] for c in BENCH["configs"] if c["name"] == name)
    with open(ROOT / file) as f:
        cfg = json.load(f)
    module = configs.arch(cfg)
    assert module.__name__ == f"configs.{cfg['model_type']}"
    assert all(hasattr(module, p) for p in PARTS)
    # every departure is one of the module's, and the file keeps the
    # published value beside it
    for key in cfg.get("departures", {}):
        assert key in module.RUNS_AS and key in cfg, key


def test_unknown_architecture_is_refused():
    cfg = copy.deepcopy(tiny.stablelm())
    cfg["model_type"] = "hybrid_mamba"
    with pytest.raises(ValueError, match="no module configs/hybrid_mamba.py"):
        configs.arch(cfg)


@pytest.mark.parametrize("make,key,value", [
    (tiny.stablelm, "qk_layernorm", True),
    (tiny.stablelm, "tie_word_embeddings", True),
    (tiny.deepseek, "norm_topk_prob", True),
    (tiny.deepseek, "q_lora_rank", 1536)])
def test_a_value_not_run_needs_a_departure(make, key, value):
    cfg = copy.deepcopy(make())
    cfg[key] = value
    with pytest.raises(ValueError, match=key):
        configs.arch(cfg)
    cfg["departures"][key] = "run at the module's value"
    configs.arch(cfg)


@pytest.mark.parametrize("make", [tiny.stablelm, tiny.deepseek],
                         ids=["stablelm", "deepseek"])
def test_leaves_match_the_ports_parameters(make):
    """The leaves drawn for an architecture are the port's parameter tree,
    path for path and shape for shape."""
    import torch
    from benchkit import program, weights
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    cfg = make()
    params = make_model(program.arch_config(cfg)).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    port = {"/".join(p): tuple(x.shape)
            for p, x in flatten_with_path(params)}
    ours = {path: shape for path, shape, _, _ in weights.leaves(cfg)}
    assert ours == port
