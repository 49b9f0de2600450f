"""The port's dry run (``repro_torch.launch.dryrun``), the counterpart of
``tests/test_dryrun_lowering.py``: programs traced over a fake process
group on fake CPU tensors, each in a subprocess (a process has one
default group).

- xlstm-125m at full width, train, on a fake (pod 2, data 2, model 2)
  mesh at batch 8 and sequence 16, cut to its first 4 layers (three
  mLSTM blocks and the sLSTM block at layer 3) for the time budget (the
  12 layers take about a minute here); the sLSTM loop traced for 8 of
  its 16 steps and counted as 16, in the forward and again in the
  backward's recomputation of its checkpointed block; a reduced
  stablelm-1.6b prefill and decode and a reduced qwen2-moe decode on the
  same mesh, the last also under ``EXPERT_PARALLEL_RULES`` (its 4
  experts 2 a rank over model: no all-to-all) and under the override
  ``expert=("data",)`` (the dispatch an all-to-all over data);
- one combo through the tool's own path (``run_in_subprocess``, the
  production mesh of 256 ranks): gemma3-1b long_500k;
- on the card (``cuda``): reduced deepseek-v2-lite's MoE layer under
  ``EXPERT_PARALLEL_RULES`` on two gloo ranks sharing it, the router's
  kernel against its plain version.

Each record has flops and collectives, a dominant term, and the
reference's record keys (less ``lower_s`` / ``compile_s``, with
``trace_s``)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMINANT = {"compute", "memory", "collective"}
#: the reference's record (repro/launch/dryrun.py), less lower_s and
#: compile_s, plus trace_s and what was traced
KEYS = {"arch", "shape", "mesh", "n_chips", "trace_s", "traced", "memory",
        "roofline", "analytic", "ok"}
MEMORY = {"argument_bytes", "activation_peak_bytes_analytic", "fits_hbm",
          "hbm_fraction"}
ROOFLINE = {"flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_bytes_by_kind",
            "collective_counts", "cross_pod_bytes", "compute_s", "memory_s",
            "collective_s", "dominant", "model_flops", "useful_flops_ratio"}
ANALYTIC = {"flops", "hbm_bytes", "ici_bytes", "dci_bytes", "compute_s",
            "memory_s", "collective_s", "dominant", "mfu_upper_bound"}

SMALL = textwrap.dedent("""
    import dataclasses
    import json
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, shardings as sh
    from repro_torch.launch.mesh import init_fake_world, make_test_mesh
    init_fake_world(8)
    mesh = make_test_mesh("cpu", (2, 2, 2), ("pod", "data", "model"))
    decode = InputShape("decode", 32, 8, "decode")
    ep = tuple(sh.EXPERT_PARALLEL_RULES.items())
    cases = [("xlstm-125m", False, InputShape("train", 16, 8, "train"), ()),
             ("stablelm-1.6b", True, InputShape("prefill", 32, 8, "prefill"),
              ()),
             ("stablelm-1.6b", True, decode, ()),
             ("qwen2-moe-a2.7b", True, decode, ()),
             ("qwen2-moe-a2.7b", True, decode, ep),
             ("qwen2-moe-a2.7b", True, decode, (("expert", ("data",)),))]
    for arch, reduced, shape, overrides in cases:
        cfg = get_config(arch)
        cfg = cfg.reduced() if reduced else dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_layers=4))
        rec = {"arch": arch, "shape": shape.name}
        rec.update(dryrun.trace_combo(cfg, shape, mesh,
                                      sh.rules_for(cfg, mesh, overrides),
                                      recurrent_steps=8))
        print(json.dumps(rec), flush=True)
""")


@pytest.fixture(scope="module")
def small():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", SMALL], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert len(recs) == 6
    return recs


def _check(rec):
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0
    assert roof["bytes_per_device"] > 0
    assert sum(roof["collective_counts"].values()) > 0
    assert roof["collective_bytes_per_device"] > 0
    assert roof["dominant"] in DOMINANT
    assert rec["analytic"]["dominant"] in DOMINANT
    assert MEMORY <= set(rec["memory"])
    assert ROOFLINE <= set(roof)
    assert ANALYTIC <= set(rec["analytic"])
    assert roof["nvlink_bytes"] + roof["ib_bytes"] \
        + roof["cross_pod_bytes"] == pytest.approx(
            roof["collective_bytes_per_device"])


@pytest.mark.parametrize("case", range(6))
def test_small_mesh_programs_trace(small, case):
    rec = small[case]
    _check(rec)
    assert rec["trace_s"] > 0


def test_train_traces_a_bounded_recurrence_and_scales_it(small):
    rec = small[0]
    assert rec["traced"]["mode"] == "train"
    # the cut's one sLSTM layer: 8 of 16 steps, traced twice: in the
    # forward and again when the backward recomputes its checkpointed
    # block (the config's remat="layer")
    assert rec["traced"]["recurrent_steps_traced"] == 2 * 8
    assert rec["traced"]["recurrent_steps"] == 2 * 16
    assert rec["roofline"]["collective_counts"].get("reduce-scatter", 0) > 0


def test_decode_splits_the_cache_and_merges_the_softmax(small):
    """stablelm's decode cache is split along its slots over model (the
    reference's kv_seq rule): the partial softmaxes are merged."""
    rec = small[2]
    assert rec["traced"]["mode"] == "decode"
    assert rec["roofline"]["collective_counts"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("case,all_to_alls", [(3, False), (4, False),
                                               (5, True)])
def test_moe_decode_exchanges_only_where_experts_share_the_rows_axis(
        small, case, all_to_alls):
    """qwen2-moe's decode under DEFAULT_RULES (experts whole),
    EXPERT_PARALLEL_RULES (experts over model, where the rows are whole)
    and expert=("data",) (experts over data, which splits the rows)."""
    counts = small[case]["roofline"]["collective_counts"]
    assert (counts.get("all-to-all", 0) > 0) == all_to_alls, counts


def test_the_tool_runs_a_production_combo_in_a_subprocess():
    recs = dryrun.run_in_subprocess("single", [("gemma3-1b", "long_500k")],
                                    timeout=300)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == KEYS
    assert rec["mesh"] == "32x8" and rec["n_chips"] == 256
    _check(rec)


def ep_moe_rank(rank, results):
    """One of two gloo ranks sharing the card: reduced deepseek-v2-lite's
    MoE layer (fp32, drawn on the card from a seed) as DTensors under
    EXPERT_PARALLEL_RULES on a (data 1, model 2) mesh, with the router's
    kernel and with its plain version: both outputs whole, the kernel's
    launches and the experts this rank holds."""
    import dataclasses

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import make_model
    from repro_torch.models.common import layer_slice, logical_sharding
    from repro_torch.models.moe import apply_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    m = dataclasses.replace(cfg.model, dtype="float32",
                            param_dtype="float32")
    cfg = dataclasses.replace(cfg, model=m)
    mesh = make_test_mesh("cuda", (1, 2), ("data", "model"))
    rules = sh.rules_for(cfg, mesh, tuple(sh.EXPERT_PARALLEL_RULES.items()))
    params, axes = make_model(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(0), "cuda",
        with_axes=True)
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    p = layer_slice(dparams["layers"], 0)["moe"]
    x = torch.randn((2, 16, m.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    dx = sh.distribute_tree(x, mesh, sh.placements_for(
        mesh, rules, ("batch", "seq", "embed_act"), x.shape))
    out = {"local_experts": p["wo"].to_local().shape[0]}
    kernel = ops.topk_router
    for name in ("kernel", "plain"):
        if name == "plain":
            ops.topk_router = ref.topk_router_ref
        ops.reset_launches()
        try:
            with torch.no_grad(), logical_sharding(mesh, rules), \
                    implicit_replication():
                y, _ = apply_moe(p, m.moe, dx, m.act)
            out[name] = y.full_tensor().cpu()
        finally:
            ops.topk_router = kernel
        out[f"{name}_launches"] = ops.launch_counts()["topk_router"]
    return out


@pytest.fixture
def cuda_device(monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
def test_expert_parallel_moe_on_two_ranks_sharing_the_card(cuda_device):
    """Each rank holds 2 of the 4 experts, launches the router's kernel
    once on its (whole) tokens and gives the plain version's output
    within fp32 3e-5."""
    import torch

    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(ep_moe_rank, 2, backend="gloo", device="cuda:0",
                      timeout=300)
    for r in ranks:
        assert r["local_experts"] == 2
        assert (r["kernel_launches"], r["plain_launches"]) == (1, 0)
        torch.testing.assert_close(r["kernel"], r["plain"], atol=3e-5,
                                   rtol=3e-5)
    assert torch.equal(ranks[0]["kernel"], ranks[1]["kernel"])
