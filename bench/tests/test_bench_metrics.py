"""The metric readers and the trace reduction: a synthetic trace read by
hand, and every reader on a tiny run of each driver on the CPU (the
device metrics have nothing to read there and return None)."""
import json
import time

import pytest

import tiny
from benchkit import cell_serve, cell_train, devtrace, spec
from benchkit.spec import ROOT, Cell

with open(ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)


def test_union_and_idle_by_hand():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 14, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 36, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpy", "ts": 37,
         "dur": 8},
    ]
    s = devtrace.summarize(ev, window_s=100e-6)
    # busy: [0, 15] + [30, 35] + [50, 60] = 30 us (overlap counted once)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.kernel_seconds(["k_a"]) == (pytest.approx(20e-6), 2)
    # gaps: 15..30 (mid 22.5 under aten::mm), 35..50 (mid 42.5 under the
    # innermost op there, cudaMemcpy)
    assert s.idle_by_host_op == {"aten::mm": pytest.approx(15e-6),
                                 "cudaMemcpy": pytest.approx(15e-6)}
    b = s.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert devtrace.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def _cell(make, mix, name):
    return Cell(name=name, config=make(), traffic=mix(),
                limits={"mean_gap": 1e9, "loss_gap": 1e9,
                        "grad_norm_gap": 1e9, "change_gap": 1e9},
                chips=1, end_to_end=[], per_layer=[])


RUNS = {
    "deepseek-v2-lite-16b.decode-long": lambda t: cell_serve.run(
        _cell(tiny.deepseek, tiny.mix, "x"), 3, 3.0, t, "cpu",
        time.perf_counter()),
    "stablelm-1.6b.hfl-train": lambda t: cell_train.run(
        _cell(tiny.stablelm, tiny.train_mix, "x"), 3, 2.0, t, "cpu",
        time.perf_counter()),
}
HOST = {"setup_s", "serve_tokens_per_s", "train_tokens_per_s",
        "sched.occupancy", "engine.decode_step_ms", "train.local_step_ms",
        "fl.sync_ms", "mfu.serve", "mfu.train"}


@pytest.mark.parametrize("cell", sorted(RUNS))
def test_readers_on_a_tiny_run(cell):
    run = RUNS[cell](False)["run"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
             if cell in m.get("workloads", [cell])]
    for name in names:
        value = spec.metric_reader(name)(run)
        if name in HOST:
            assert value is not None and value > 0, name
        else:
            assert value is None, name               # no device trace here
