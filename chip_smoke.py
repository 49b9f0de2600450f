#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
paper's GRU replica-serving path at full width (2 layers, hidden 128):
flat, cluster and global FedAvg over 20 client replicas, a three-tier
``ReplicaPool`` serving request batches (with one failover) from the
global model, and the latency model calibrated from the pool's timings.
Every result is held against the same functions run on the CPU, where
the wrappers take the kernels' plain versions.

Each phase prints one JSON line.  The line before the last lists every
kernel with its launches on the main path, its error against its plain
version and its times beside the card's bound; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero, with no result,
without CUDA, outside a checkout of the repo, or when a phase fails.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
#: NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
#: cores (both kernels do their arithmetic in fp32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: tolerances of tests/test_kernels.py (GRU 2e-5; fp32 3e-5, bf16 3e-2)
GRU_TOL = 2e-5
FEDAVG_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: end to end, the card and the CPU sum matrix products in other orders;
#: two stacked layers and the head compound that
PRED_TOL = 1e-4
#: the slice: 20 clients in cluster ids 0, 1 and 3 (id 2 has no members)
CLUSTER_IDS = np.array([0] * 8 + [1] * 7 + [3] * 5)
TIER_BATCH = {"device": 1, "edge": 4, "cloud": 16}
HISTORY = 12
BATCHES_PER_TIER = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def call_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` as a caller sees it, host work
    included: CUDA events around ``iters`` eager calls, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the card alone: ``iters`` calls
    captured in one CUDA graph and replayed between CUDA events, so the
    host's per-call work is not in it.  Inputs stay in L2 between calls,
    as for a replica that serves one request batch after another."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timings(torch, kernel, plain, library, iters: int, plain_iters: int):
    return {"ms": device_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, plain_iters),
            "library_ms": device_ms(torch, library, iters),
            "call_ms": call_ms(torch, kernel, iters),
            "plain_call_ms": call_ms(torch, plain, plain_iters),
            "library_call_ms": call_ms(torch, library, iters)}


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds, "library": str(build.build())})
    print(build.build_log(), file=sys.stderr, flush=True)


def check_gru_seq(torch, rng, B, T, h):
    from repro_torch.kernels import gru_cell, ref
    dev = torch.device(DEVICE)
    xw = torch.as_tensor(rng.normal(size=(B, T, 3 * h)), dtype=torch.float32,
                         device=dev)
    h0 = torch.as_tensor(rng.normal(size=(B, h)), dtype=torch.float32,
                         device=dev)
    w_h = torch.as_tensor(rng.normal(size=(h, 3 * h)) * 0.1,
                          dtype=torch.float32, device=dev)
    out = gru_cell.gru_seq(xw, h0, w_h)
    plain = ref.gru_seq_ref(xw, h0, w_h)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    ok = bool(torch.allclose(out, plain, atol=GRU_TOL, rtol=GRU_TOL))
    # library yardstick: cuDNN's GRU computes the same recurrence when its
    # input weights are the identity (so its input is xw itself), its
    # recurrent weights are w_h^T, and both biases are zero
    lib = torch.nn.GRU(3 * h, h, batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(3 * h, device=dev))
        lib.weight_hh_l0.copy_(w_h.T)
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()

        def library():
            return lib(xw, h0[None])[0]

        lib_err = (library() - plain).abs().max().item()
        nbytes = 4 * (B * T * 3 * h + B * h + h * 3 * h + B * T * h)
        bound_ms, bound_by = bound(nbytes, 2 * B * T * h * 3 * h)
        row = {"kernel": "gru_seq", "shape": [B, T, h], "dtype": "float32",
               "max_abs_err": err, "tol": GRU_TOL, "ok": ok,
               **timings(torch, lambda: gru_cell.gru_seq(xw, h0, w_h),
                         lambda: ref.gru_seq_ref(xw, h0, w_h), library,
                         200, 20),
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel_check", **row})
    return row


def check_fedavg_reduce(torch, rng, C, N, dtype_name):
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ref
    dev = torch.device(DEVICE)
    dtype = getattr(torch, dtype_name)
    x = torch.as_tensor(rng.normal(size=(C, N)), dtype=torch.float32,
                        device=dev).to(dtype)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, C), dtype=torch.float32,
                        device=dev)
    out = fr.fedavg_reduce(x, w)
    plain = ref.fedavg_reduce_ref(x, w)
    torch.cuda.synchronize()
    tol = FEDAVG_TOL[dtype_name]
    err = (out.float() - plain.float()).abs().max().item()
    ok = bool(out.dtype == dtype and torch.allclose(
        out.float(), plain.float(), atol=tol, rtol=tol))
    wn = (w / w.sum()).to(dtype)
    it = x.element_size()
    bound_ms, bound_by = bound(C * N * it + C * 4 + N * it, 2 * C * N)
    row = {"kernel": "fedavg_reduce", "shape": [C, N], "dtype": dtype_name,
           "max_abs_err": err, "tol": tol, "ok": ok,
           **timings(torch, lambda: fr.fedavg_reduce(x, w),
                     lambda: ref.fedavg_reduce_ref(x, w),
                     lambda: torch.matmul(wn, x), 200, 50),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel_check", **row})
    return row


def phase_kernels(torch, n_params):
    rng = np.random.default_rng(SEED)
    gru_rows = [check_gru_seq(torch, rng, B, HISTORY, 128)
                for B in TIER_BATCH.values()]
    # the tests/test_kernels.py sweep shape T=24, h=64, at B=6, which that
    # test's batch block bb=4 does not divide
    gru_rows.append(check_gru_seq(torch, rng, 6, 24, 64))
    shapes = [(len(CLUSTER_IDS), n_params, "float32"),
              (len(CLUSTER_IDS), n_params, "bfloat16")]
    shapes += [(int(c), n_params, "float32")
               for c in np.bincount(CLUSTER_IDS) if c]
    shapes += [(int((np.bincount(CLUSTER_IDS) > 0).sum()), n_params,
                "float32"), (4, 513, "float32"), (4, 513, "bfloat16")]
    fed_rows = [check_fedavg_reduce(torch, rng, *s) for s in shapes]
    bad = [r for r in gru_rows + fed_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return gru_rows, fed_rows


def numpy_clients(rng, m, clients: int):
    """Stacked client replicas of the GRU in the JAX package's layout:
    fan-in-normal weights, small random biases (replicas that trained
    apart)."""
    h = m.rnn_hidden

    def draw(shape, std):
        return (rng.normal(size=(clients,) + shape) * std).astype(np.float32)

    gru = {}
    for i in range(m.rnn_layers):
        din = 1 if i == 0 else h
        gru[str(i)] = {"w_x": draw((din, 3 * h), din ** -0.5),
                       "w_h": draw((h, 3 * h), h ** -0.5),
                       "b": draw((3 * h,), 0.01)}
    return {"gru": gru, "head": {"w": draw((h, 1), h ** -0.5),
                                 "b": draw((1,), 0.01)}}


def param_count(tree) -> int:
    from repro_torch.params import flatten_with_path
    return sum(int(np.prod(x.shape)) for _, x in flatten_with_path(tree))


def max_tree_err(a, b) -> float:
    from repro_torch.params import flatten_with_path
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for (_, x), (_, y) in zip(flatten_with_path(a),
                                         flatten_with_path(b)))


def all_finite(tree) -> bool:
    from repro_torch.params import flatten_with_path
    return all(bool(x.isfinite().all()) for _, x in flatten_with_path(tree))


def phase_slice(torch):
    """The main path, through the entry points a user calls."""
    from repro_torch.configs import get_config
    from repro_torch.fl import cluster_fedavg, fedavg, global_fedavg
    from repro_torch.kernels import ops
    from repro_torch.params import from_numpy_tree, tree_map
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, TierSpec

    m = get_config("gru-traffic").model
    rng = np.random.default_rng(SEED + 1)
    clients = numpy_clients(rng, m, len(CLUSTER_IDS))
    sizes = rng.integers(50, 500, len(CLUSTER_IDS))    # client data sizes
    stacked = from_numpy_tree(clients, DEVICE)
    stacked_cpu = from_numpy_tree(clients, "cpu")
    specs = [TierSpec(t, batch_size=b, reduced=False)
             for t, b in TIER_BATCH.items()]
    windows = {t: [rng.normal(size=(b, HISTORY, 1))
                   for _ in range(BATCHES_PER_TIER)]
               for t, b in TIER_BATCH.items()}

    ops.reset_launches()
    t0 = time.perf_counter()
    flat = fedavg(stacked, sizes)
    local = cluster_fedavg(stacked, CLUSTER_IDS, sizes)
    glob = global_fedavg(stacked, CLUSTER_IDS, sizes)
    model = tree_map(lambda x: x[0], glob)
    pool = ReplicaPool(specs, shared_params=model, device=DEVICE)
    preds = {t: [pool.dispatch(t, w) for w in ws]
             for t, ws in windows.items()}
    pool.mark_down("edge")
    before = pool.failovers
    failover_pred = pool.dispatch("edge", windows["edge"][0])
    failovers = pool.failovers - before
    pool.mark_up("edge")
    measured = pool.measure()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()

    # the plain path: the same entry points on CPU tensors
    cpu_model = tree_map(lambda x: x[0],
                         global_fedavg(stacked_cpu, CLUSTER_IDS, sizes))
    cpu_pool = ReplicaPool(specs, shared_params=cpu_model, device="cpu")
    agg_err = max(max_tree_err(flat, fedavg(stacked_cpu, sizes)),
                  max_tree_err(local, cluster_fedavg(stacked_cpu, CLUSTER_IDS,
                                                     sizes)),
                  max_tree_err(model, cpu_model))
    pred_err = max((p - cpu_pool.dispatch(t, w).to(p.device)).abs().max()
                   .item() for t in windows
                   for p, w in zip(preds[t], windows[t]))
    failover_err = (failover_pred.cpu()
                    - cpu_pool.dispatch("cloud", windows["edge"][0])
                    ).abs().max().item()
    lat = LatencyModel.from_measurements(measured)

    rep = pool.replica("cloud")
    n_dispatch = BATCHES_PER_TIER * len(TIER_BATCH) + 1
    # per forward: one gru_seq launch per layer; measure() makes one
    # warm-up and 8 timed forwards per tier
    want = {"gru_seq": m.rnn_layers * (n_dispatch + 9 * len(TIER_BATCH)),
            "fedavg_reduce": 1 + 2 * len(np.unique(CLUSTER_IDS)) + 1}
    checks = {
        "full_width": (rep.cfg.model.rnn_hidden == 128
                       and tuple(rep.params["gru"]["1"]["w_h"].shape)
                       == (128, 384)),
        "finite": all_finite(glob) and all(
            bool(p.isfinite().all()) for ps in preds.values() for p in ps),
        "shapes": all(tuple(p.shape) == (TIER_BATCH[t], 1)
                      for t, ps in preds.items() for p in ps),
        "aggregation_matches_plain": agg_err <= FEDAVG_TOL["float32"],
        "predictions_match_plain": pred_err <= PRED_TOL,
        "failover_to_cloud": failovers == 1 and failover_err <= PRED_TOL,
        "launches": launches == want,
    }
    emit({"phase": "slice", "params": param_count(model),
          "seconds": seconds, "launches": launches,
          "expected_launches": want, "aggregation_max_abs_err": agg_err,
          "prediction_max_abs_err": pred_err,
          "failover_max_abs_err": failover_err,
          "tier_ms": {t: mm.prefill_ms for t, mm in measured.items()},
          "calibrated_infer_ms": {t: lat.infer_ms(t) for t in TIER_BATCH},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, pool, measured


def phase_profile(torch, pool, measured, batches: int = 20):
    """Where a request batch's time goes on the card: device time by
    kernel from ``torch.profiler`` over ``batches`` dispatches per tier,
    beside the tier's measured time per batch; the rest is the device
    waiting for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for tier, b in TIER_BATCH.items():
        w = torch.as_tensor(rng.normal(size=(b, HISTORY, 1)),
                            dtype=torch.float32, device=DEVICE)
        pool.dispatch(tier, w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                pool.dispatch(tier, w)
            torch.cuda.synchronize()
        # device-side events only: a CPU op's device time repeats its
        # kernels' time
        kernels = {e.key[:80]: e.self_device_time_total / 1e3 / batches
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        device_ms = sum(kernels.values())
        tier_ms = measured[tier].prefill_ms
        out[tier] = {
            "tier_ms": tier_ms, "device_ms": device_ms or None,
            "device_idle_share": (1.0 - device_ms / tier_ms
                                  if device_ms else None),
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:6])}
    emit({"phase": "profile", "per_request_batch": out})


def kernel_entry(name, source, replaces, launches, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"], "shape": row["shape"],
            "dtype": row["dtype"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch
    except ImportError:
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 1
    if not os.path.abspath(repro_torch.__file__).startswith(ROOT + os.sep):
        print("chip_smoke: repro_torch was imported from outside this "
              "checkout", file=sys.stderr)
        return 1

    phase = "device"
    try:
        smi = phase_device(torch)
        phase = "build"
        phase_build()
        from repro_torch.configs import get_config
        one = numpy_clients(np.random.default_rng(SEED),
                            get_config("gru-traffic").model, 1)
        n_params = param_count(one)
        phase = "kernels"
        gru_rows, fed_rows = phase_kernels(torch, n_params)
        phase = "slice"
        launches, pool, measured = phase_slice(torch)
        phase = "profile"
        phase_profile(torch, pool, measured)
    except Exception:  # report which phase failed, then fail the run
        traceback.print_exc()
        emit({"phase": phase, "ok": False})
        return 1

    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("gru_seq", "src/repro_torch/kernels/csrc/gru_seq.cu",
                     "src/repro/kernels/gru_cell.py:41",
                     launches["gru_seq"], gru_rows[2]),
        kernel_entry("fedavg_reduce",
                     "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
                     "src/repro/kernels/fedavg_reduce.py:26",
                     launches["fedavg_reduce"], fed_rows[0]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
