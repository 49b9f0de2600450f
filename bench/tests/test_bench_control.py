"""The control at a size a test run holds: the reference in float8 in
the program's place is not correct by the cells' limits.  The served
requests are the reference's own greedy tokens (a program that matches
it exactly reads 0); the control's mean gap over the same positions must
pass the limit.  On the chip at each cell's size: ``bench/control.py``
(readings in PERF.md)."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny
from benchkit import check, weights
from benchkit.spec import BENCH_DIR
from reference import transformer as ref


def _greedy(params, cfg, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits = ref.logits(params, cfg, torch.as_tensor(toks), len(toks) - 1)
        toks.append(int(logits[-1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("make,cell", [
    (tiny.deepseek, "deepseek-v2-lite-16b.decode-long")], ids=["deepseek"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(make, cell, seed):
    with open(BENCH_DIR / "limits" / f"{cell}.json") as f:
        limit = json.load(f)["mean_gap"]
    cfg = make()
    params = weights.make_params(cfg, seed, "cpu")
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(4):
        prompt = rng.integers(1, 512, 40)
        reqs.append(SimpleNamespace(prompt=prompt,
                                    tokens=_greedy(params, cfg, prompt, 40)))
    out = check.gaps(params, cfg, reqs, "cpu", control="fp8")
    assert out["mean_gap"] == 0.0 and out["tokens_checked"] == 160
    assert out["control_mean_gap"] > limit, out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_is_not_correct(seed):
    """The reference trained in float8 in the program's place fails the
    training cell's limits on the same weights and batches."""
    from benchkit import cell_train
    with open(BENCH_DIR / "limits" / "stablelm-1.6b.hfl-train.json") as f:
        limits = json.load(f)
    cfg, t = tiny.stablelm("float32"), tiny.train_mix()
    params = weights.make_params(cfg, seed, "cpu")
    stream = cell_train.make_batches(t, 512, seed, "cpu")
    batches = [next(stream) for _ in range(t["check_rounds"])]
    want = cell_train.reference_readings(params, cfg, batches,
                                         t["optimizer"], t["global_every"],
                                         "fp32")
    low = cell_train.reference_readings(params, cfg, batches, t["optimizer"],
                                        t["global_every"], "fp8")
    got = cell_train.compare(low, want)
    assert any(got[k] > limits[k] for k in limits), got
