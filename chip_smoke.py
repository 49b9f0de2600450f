#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout,
reports what the attention kernels, the SSD scan, the router and the
GRU's cluster kernel compiled to (tensor-core, 16-byte load,
warp-reduction and cluster-barrier instructions, registers, spills),
holds each kernel against its plain PyTorch version on the card (the
router beside an empty kernel's launch floor, the GRU beside a kernel
that only exchanges its state), differentiates the reduced GRU's loss
on the card through ``gru_seq`` against the CPU, then drives these paths
through the entry points a user calls:

- the paper's GRU replica-serving path at full width (2 layers, hidden
  128): flat, cluster and global FedAvg over 20 client replicas, a
  three-tier ``ReplicaPool`` serving request batches (with one failover)
  from the global model, and the latency model calibrated from the
  pool's timings, every result held against the same functions on the
  CPU, where the wrappers take the kernels' plain versions;
- the paper's training pipeline at full width (the quickstart's steps
  on Fig. 6's 20 clients): HFLOP clustering, one local and one global
  round of continual hierarchical FedAvg, every
  minibatch and validation forward in ``gru_seq`` and every aggregation
  in ``fedavg_reduce``, held against the same run on the CPU from the
  same numpy model and minibatch orders; a profile of one training step;
  the routing simulator with its default latencies and calibrated from
  the deployment's replica pool;
- LM replica serving of stablelm-1.6b at its published width (24
  layers, d 2048, bf16, random weights from a seed): the dense tiers
  (``lm_tiers``) and the paged tiers (``paged_lm_tiers``) on one shared
  weight tree, request batches at every tier, one failover, the
  measured occupancy sweep into the latency model; then the same
  entry points at full width but 2 layers in fp32 on the card and on the
  CPU, held against each other;
- MoE + MLA replica serving of deepseek-v2-lite-16b at its published
  width (27 layers, d 2048, MLA with kv_lora 512, 64 routed experts top-6
  and 2 shared, bf16, 15.7 B random weights drawn on the card from a
  seed), through the same entry points and checks, and its own 2-layer
  fp32 cut (the lead dense layer and one MoE layer) on the card and on
  the CPU;
- the zamba2-1.2b hybrid at its published width (38 Mamba2 layers, d
  2048, 64 SSD heads, one shared attention block after every 6 layers,
  bf16, 1.1 B random weights drawn on the card from a seed): its
  full-sequence forward and loss on a (2, 1024) token batch, whose
  Mamba2 scans run in ``mamba_chunk_scan``, and dense-tier serving, whose
  prompts are fed token by token through the decode step; then a 6-layer
  fp32 cut (one shared block) on the card and on the CPU.

Each phase prints one JSON line.  The line before the last lists every
kernel with its launches on the main path, its error against its plain
version and its times beside the card's bound; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero, with no result,
without CUDA, outside a checkout of the repo, or when a phase fails.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
#: NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
#: cores, dense bf16 tensor-core rate (the bound of the bf16 attention
#: rows; the kernels' arithmetic is fp32 either way)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
#: tolerances of tests/test_kernels.py (GRU 2e-5; fp32 3e-5, bf16 3e-2)
GRU_TOL = 2e-5
FEDAVG_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: end to end, the card and the CPU sum matrix products in other orders;
#: two stacked layers and the head compound that
PRED_TOL = 1e-4
#: the loss gradients of the reduced GRU, card against CPU: the forward's
#: recurrence is the kernel's on the card, the backward the plain
#: version's on both, so they differ as the predictions do
GRAD_TOL = 1e-4
#: the slice: 20 clients in cluster ids 0, 1 and 3 (id 2 has no members)
CLUSTER_IDS = np.array([0] * 8 + [1] * 7 + [3] * 5)
TIER_BATCH = {"device": 1, "edge": 4, "cloud": 16}
HISTORY = 12
BATCHES_PER_TIER = 3
#: the HFL slice: the paper's Fig. 6 setup (20 clients, 5 a geographic
#: cluster, 5 local epochs, batch 16, lr 1e-4, l = 2) for one local and
#: one global round of hierarchical FedAvg; each epoch cut to 4
#: minibatches, the validation week to 128 windows a client.  Card
#: against CPU: val MSE within 1e-4 relative, parameters within 1e-4
#: absolute
HFL_PER_CLUSTER = 5
HFL_RUN = dict(rounds=2, local_epochs=5, batch_size=16, lr=1e-4,
               max_batches=4, max_val_windows=128)
HFL_TOL = 1e-4
HFL_SIM_S = 60
HFL_PROFILE_STEPS = 20
#: attention kernels against their plain versions: tests/test_kernels.py
ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: the LM slice: stablelm-1.6b at full width, 8 tokens per request, two
#: request batches per tier (B = the tier's rows).  Prompts of 56 tokens
#: (prefill bucket 64): a paged tier's page budget is what its dense
#: counterpart reserves, 64 tokens a row at its full row count, so a
#: 64-token prompt plus 8 decoded tokens (5 pages) would not fit 32 rows
#: in the cloud's 128 pages.
LM_ARCH = "stablelm-1.6b"
LM_PROMPT = 56
LM_STEPS = 8
LM_BATCHES_PER_TIER = 2
LM_MEASURE = dict(prompt_len=64, decode_steps=16, occupancy_levels=(1, 4, 8))
#: the CPU-parity run: full width, 2 layers (a depth cut only), fp32;
#: prefill logits on the card against the CPU (fp32 sums in other
#: orders through 2 layers and a 2048-wide head)
PARITY_LAYERS = 2
PARITY_LOGIT_TOL = 1e-3
#: the MoE slice: deepseek-v2-lite-16b at full width, with the LM slice's
#: requests, measurement and parity cut (its 2 layers: the lead dense
#: layer and one MoE layer)
MOE_ARCH = "deepseek-v2-lite-16b"
#: topk_router against its plain version: tests/test_kernels.py's weight
#: tolerance, and indices identical
ROUTER_TOL = 1e-6
#: the hybrid slice: zamba2-1.2b at full width.  Its weight count is
#: the JAX tree's (``param_count()`` is coarse for the hybrid); the
#: forward scores 2 sequences of 1024 tokens (8 chunks of 128 a layer)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PARAMS = 1_104_937_856
HYBRID_BATCH = (2, 1024)
#: mamba_chunk_scan against its plain version: tests/test_kernels.py's
#: 5e-4 for fp32 and bf16's 3e-2 for y.  The fp32 state takes 5e-4 from
#: bf16 inputs too: kernel and plain version read the same bf16 values
#: and do fp32 arithmetic, so only the order of fp32 sums differs.
SCAN_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
SCAN_STATE_TOL = 5e-4
#: the hybrid's parity cut: full width, 6 layers (one complete segment,
#: so the shared block runs once), fp32, a (2, 256) batch (2 chunks);
#: stepwise decode against the forward within
#: tests/test_decode_consistency.py's 2e-3, and the card's forward
#: against the CPU's within the same 2e-3, not the LM cuts' 1e-3: the
#: phase also reports each side's distance from an fp64 forward of the
#: same code, and on an H100 the card's fp32 logits lie about 1.1e-3 from
#: it (the plain scan in place of the kernel does no better), the CPU's
#: about 4e-4, so fp32 on the card does not reach 1e-3 on this cut
HYBRID_PARITY_LAYERS = 6
HYBRID_PARITY_SEQ = 256
HYBRID_PARITY_LOGIT_TOL = 2e-3
DECODE_TOL = 2e-3
#: the hybrid admits a prompt token by token, one ~40-layer decode step
#: each, so its measure() probes with 16-token prompts and its profile
#: admits 8-token prompts (a step's cost does not depend on the prompt)
HYBRID_MEASURE = dict(prompt_len=16, decode_steps=8,
                      occupancy_levels=(1, 4, 8))
HYBRID_PROFILE_PROMPT = 8
#: served trees at full width: leaf -> shape
FULL_WIDTH = {
    LM_ARCH: {("layers", "attn", "wq"): (24, 2048, 32, 64)},
    MOE_ARCH: {("lead", "0", "attn", "wq"): (2048, 16, 192),
               ("lead", "0", "mlp", "wi_gate"): (2048, 10944),
               ("layers", "attn", "wq"): (26, 2048, 16, 192),
               ("layers", "attn", "w_uk"): (26, 512, 16, 128),
               ("layers", "moe", "router"): (26, 2048, 64),
               ("layers", "moe", "wi_gate"): (26, 64, 2048, 1408),
               ("layers", "moe", "shared", "wi_gate"): (26, 2048, 2816)},
    HYBRID_ARCH: {("mamba_layers", "mamba", "in_proj"): (38, 2048, 8384),
                  ("mamba_layers", "mamba", "conv_w"): (38, 4, 4224),
                  ("mamba_layers", "mamba", "A_log"): (38, 64),
                  ("mamba_layers", "mamba", "out_proj"): (38, 4096, 2048),
                  ("shared", "attn", "wq"): (2048, 32, 64),
                  ("shared", "mlp", "wi_gate"): (2048, 8192)},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
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


def kernel_split_ms(torch, fn, iters: int = 20) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches: ``iters``
    calls under ``torch.profiler``, device activity only."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.device_time_total > 0}


def timings(torch, kernel, plain, library, iters: int, plain_iters: int):
    """Kernel, plain version and (where one exists, else None) the one
    PyTorch call that computes the same function."""
    return {"ms": device_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, plain_iters),
            "library_ms": (device_ms(torch, library, iters)
                           if library else None),
            "call_ms": call_ms(torch, kernel, iters),
            "plain_call_ms": call_ms(torch, plain, plain_iters),
            "library_call_ms": (call_ms(torch, library, iters)
                                if library else None)}


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


#: kernel functions whose compiled code the sass phase reports: the two
#: GQA decode kernels (dense and paged), flash's bf16 (tensor-core) and
#: fp32 (CUDA-core) kernels, the MLA decode's bf16 tensor-core kernel,
#: the SSD scan's three kernels (every instance), the router's register
#: kernel and the GRU's cluster kernel (every instance)
SASS_KERNELS = ("decode_attention_kernel", "paged_decode_attention_kernel",
                "flash_attention_wgmma_kernel", "flash_attention_kernel",
                "paged_mla_decode_mma_kernel", "mamba_chunk_local_kernel",
                "mamba_chunk_pass_kernel", "mamba_chunk_outputs_kernel",
                "topk_router_kernel", "gru_seq_cluster_kernel")
#: opcodes the sass phase counts (``LDG.E.128``: 16-byte global loads;
#: ``REDUX``: warp reductions in one instruction; ``UCGABAR_ARV``: the
#: arrival at a cluster barrier, what ``barrier.cluster.arrive``
#: compiles to on sm_90a)
SASS_OPCODES = ("HGMMA", "HMMA", "LDG.E.128", "REDUX", "UCGABAR_ARV")


def ptxas_report(log: str) -> dict:
    """Per kernel function, what ``ptxas -v`` said in a build ``log``:
    registers a thread and bytes of spill stores and loads."""
    report, fn = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            fn = found.group(1)
            report[fn] = {}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        regs = re.search(r"Used (\d+) registers", line)
        if fn and spill:
            report[fn].update(spill_stores=int(spill.group(1)),
                              spill_loads=int(spill.group(2)))
        if fn and regs:
            report[fn]["registers"] = int(regs.group(1))
    return report


def sass_counts(text: str, opcodes=SASS_OPCODES) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing, how many
    instructions have an opcode that is or starts with each of
    ``opcodes``."""
    counts, fn = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
            continue
        if fn is None or not line.startswith("/*") or "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        for op in opcodes:
            if words[0] == op or words[0].startswith(op + "."):
                counts[fn][op] += 1
    return counts


def is_kernel(fn: str, name: str) -> bool:
    """Whether the mangled function ``fn`` is kernel ``name`` itself (and
    not another whose name ends in it: ``paged_decode_attention_kernel``
    is not ``decode_attention_kernel``)."""
    return re.search(rf"\d{name}[IE]", fn) is not None


def phase_sass():
    """What the compiled attention kernels contain: per function (one per
    template instance) the tensor-core and 16-byte-load instructions that
    ``cuobjdump -sass`` lists, and registers and spills from ``ptxas
    -v``.  Fails unless every bf16 flash instance, the bf16 MLA decode
    kernel and the two product kernels of every bf16 tensor-core instance
    of the SSD scan have tensor-core instructions, the vector instances of both GQA
    decode kernels load K/V in 16 bytes, every instance of the
    router's register kernel selects with REDUX, and every instance of
    the GRU's cluster kernel has its cluster barrier and spills
    nothing."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    listing = subprocess.run([str(cuobjdump), "-sass", str(build.build())],
                             capture_output=True, text=True,
                             check=True).stdout
    sass, regs = sass_counts(listing), ptxas_report(build.build_log())
    rows = {fn: {**sass[fn], **regs.get(fn, {})} for fn in sass
            if any(k in fn for k in SASS_KERNELS)}
    tc = [r for fn, r in rows.items() if "flash_attention_wgmma_kernel" in fn]
    mla = [r for fn, r in rows.items()
           if is_kernel(fn, "paged_mla_decode_mma_kernel")]
    # template <typename T, bool kVec, ...>: the vector instances are Lb1E
    vec = {name: [r for fn, r in rows.items()
                  if is_kernel(fn, name) and "Lb1E" in fn]
           for name in ("decode_attention_kernel",
                        "paged_decode_attention_kernel")}
    # template <typename T, bool kTC, int NTP>: bf16 tensor-core instances
    scan = [r for fn, r in rows.items()
            if (is_kernel(fn, "mamba_chunk_local_kernel")
                or is_kernel(fn, "mamba_chunk_outputs_kernel"))
            and "13__nv_bfloat16Lb1E" in fn]
    router = [r for fn, r in rows.items()
              if is_kernel(fn, "topk_router_kernel")]
    gru = [r for fn, r in rows.items()
           if is_kernel(fn, "gru_seq_cluster_kernel")]
    checks = {"flash_bf16_on_tensor_cores": bool(tc) and all(
                  r["HGMMA"] > 0 for r in tc),
              "decode_16_byte_loads": bool(vec["decode_attention_kernel"])
              and all(r["LDG.E.128"] > 0
                      for r in vec["decode_attention_kernel"]),
              "paged_decode_16_byte_loads": bool(
                  vec["paged_decode_attention_kernel"]) and all(
                  r["LDG.E.128"] > 0
                  for r in vec["paged_decode_attention_kernel"]),
              "paged_mla_bf16_on_tensor_cores": bool(mla) and all(
                  r["HMMA"] > 0 for r in mla),
              # two kernels x two widths of P
              "mamba_scan_bf16_on_tensor_cores": len(scan) == 4 and all(
                  r["HMMA"] > 0 for r in scan),
              "topk_router_selects_with_redux": bool(router) and all(
                  r["REDUX"] > 0 for r in router),
              "gru_seq_cluster_barrier": bool(gru) and all(
                  r["UCGABAR_ARV"] > 0 for r in gru),
              "gru_seq_cluster_no_spills": bool(gru) and all(
                  r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in gru)}
    emit({"phase": "sass", "functions": rows, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"sass checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def check_gru_seq(torch, rng, B, T, h):
    """gru_seq at (B, T, h); at a width the cluster instance runs,
    ``floor_ms`` times its exchange-only kernel on the same grid and
    cluster shape (the state's stores through distributed shared memory
    and the waits for them, T steps, no gate math), timed as the kernel
    is: the least time any body of the recurrence can take there."""
    from repro_torch.kernels import build, gru_cell, ref
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
               "instance": gru_cell.instance(h),
               "max_abs_err": err, "tol": GRU_TOL, "ok": ok,
               **timings(torch, lambda: gru_cell.gru_seq(xw, h0, w_h),
                         lambda: ref.gru_seq_ref(xw, h0, w_h), library,
                         200, 20),
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by}
    if row["instance"] == "cluster":
        S, bb = gru_cell.cluster_shape(B, h)
        scratch = torch.empty_like(out)

        def floor():
            build.launch("gru_seq_floor", scratch.data_ptr(), B, T, h, S, bb,
                         torch.cuda.current_stream().cuda_stream)

        row.update(cluster=[S, bb], floor_ms=device_ms(torch, floor, 200))
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
    # test's batch block bb=4 does not divide; the reduced tiers' width;
    # a width past the cluster instance's, in the general instance
    gru_rows.append(check_gru_seq(torch, rng, 6, 24, 64))
    gru_rows.append(check_gru_seq(torch, rng, 8, HISTORY, 32))
    gru_rows.append(check_gru_seq(torch, rng, 3, 5, 1024))
    # the HFL slice's validation forwards: one a client, max_val_windows
    # rows (128 in the slice, 512 by default)
    gru_rows += [check_gru_seq(torch, rng, B, HISTORY, 128)
                 for B in (128, 512)]
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


def phase_autograd(torch):
    """A loss on the card differentiates through the kernels: the reduced
    GRU's loss (its recurrence in ``gru_seq``) on the card and on the CPU,
    on the same numpy weights and windows, ``torch.autograd.grad`` of
    every leaf: each nonzero and within GRAD_TOL of the CPU's, with the
    forward launched through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import (flatten_with_path, from_numpy_tree,
                                    tree_map)
    cfg = get_config("gru-traffic").reduced()
    api = make_model(cfg)
    rng = np.random.default_rng(SEED + 3)
    tree = numpy_clients(rng, cfg.model, 1)
    rows = {}
    for B in (1, 4):
        batch = {"windows": rng.normal(size=(B, HISTORY, 1)),
                 "targets": rng.normal(size=(B, 1))}
        grads, launches = {}, 0
        for dev in (DEVICE, "cpu"):
            params = tree_map(lambda x: x[0].clone().requires_grad_(),
                              from_numpy_tree(tree, dev))
            leaves = flatten_with_path(params)
            b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
            ops.reset_launches()
            loss = api.loss(params, b)
            if dev == DEVICE:
                launches = ops.launch_counts()["gru_seq"]
            got = torch.autograd.grad(loss, [x for _, x in leaves])
            grads[dev] = {"/".join(k): g.cpu() for (k, _), g in
                          zip(leaves, got)}
        errs = {k: (g - grads["cpu"][k]).abs().max().item()
                for k, g in grads[DEVICE].items()}
        rows[B] = {"gru_seq_launches": launches,
                   "max_abs_err": max(errs.values()),
                   "zero_leaves": [k for k, g in grads[DEVICE].items()
                                   if not bool(g.abs().max() > 0)],
                   "err_by_leaf": errs}
    checks = {
        "forward_through_kernel": all(
            r["gru_seq_launches"] == cfg.model.rnn_layers
            for r in rows.values()),
        "every_leaf_nonzero": all(not r["zero_leaves"] for r in rows.values()),
        "gradients_match_cpu": all(r["max_abs_err"] <= GRAD_TOL
                                   for r in rows.values())}
    emit({"phase": "autograd", "arch": "gru-traffic (reduced)",
          "tol": GRAD_TOL, "by_batch": rows, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"autograd checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def check_attention(torch, kernel, shape, dtype_name, call, plain,
                    library, nbytes, flops):
    """One attention kernel at one shape: error against its plain
    version, times, and the bound of the work its inputs need."""
    out = call()
    want = plain()
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype_name]
    err = (out.float() - want.float()).abs().max().item()
    ok = bool(out.dtype == want.dtype and torch.allclose(
        out.float(), want.float(), atol=tol, rtol=tol))
    rate = BF16_FLOP_PER_S if dtype_name == "bfloat16" else FP32_FLOP_PER_S
    bound_ms, bound_by = bound(nbytes, flops, rate)
    row = {"kernel": kernel, "shape": list(shape), "dtype": dtype_name,
           "max_abs_err": err, "tol": tol, "ok": ok,
           **timings(torch, call, plain, library, 200, 20),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "flops": flops}
    emit({"phase": "kernel_check", **row})
    return row


def _randn(torch, rng, shape, dtype):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=DEVICE).to(dtype)


def check_flash(torch, rng, BH, BHkv, T, D, window, dtype_name, Dv=None):
    """``Dv`` (default D) is the value dim: MLA prefill scores over 192
    dims and returns 128."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    Dv = D if Dv is None else Dv
    q = _randn(torch, rng, (BH, T, D), dtype)
    k = _randn(torch, rng, (BHkv, T, D), dtype)
    v = _randn(torch, rng, (BHkv, T, Dv), dtype)
    # the yardstick takes every head's kv; repeat them outside its timing
    kx, vx = (x.repeat_interleave(BH // BHkv, 0) for x in (k, v))
    dist = np.arange(T)[:, None] - np.arange(T)[None, :]
    allowed = (dist >= 0) & ((dist < window) if window > 0 else True)
    mask = torch.as_tensor(allowed, device=DEVICE)
    pairs = BH * int(allowed.sum())
    it = q.element_size()

    # (1, BH, T, D) views: SDPA's fused backends take 4-d inputs only, and
    # 3-d ones fall to its unfused math path
    q4, k4, v4 = q[None], kx[None], vx[None]

    def library():
        if window > 0:
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask)[0]
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0]

    shape = (BH, BHkv, T, D, window) + ((Dv,) if Dv != D else ())
    return check_attention(
        torch, "flash_attention", shape, dtype_name,
        lambda: fa.flash_attention(q, k, v, causal=True, window=window),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, window=window),
        library, it * (BH * T * (D + Dv) + BHkv * T * (D + Dv)),
        pairs * 2 * (D + Dv))


def check_decode(torch, rng, B, H, Hkv, C, D, n_valid, dtype_name,
                 valid=None):
    """``n_valid`` (B,) leading valid slots per row, as a ring cache
    holds them before it wraps; None: 80% of the slots at random; or
    ``valid``, a (B, C) bool mask as it is.  The bound counts each row's
    valid slots (K and V, scores and P.V), and for a row with none only
    the V of all C slots and its mean (every score is -1e30, so the
    output does not depend on K)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    q = _randn(torch, rng, (B, H, D), dtype)
    k, v = (_randn(torch, rng, (B, C, Hkv, D), dtype) for _ in range(2))
    if valid is not None:
        valid = np.asarray(valid, bool)
    elif n_valid is None:
        valid = rng.uniform(size=(B, C)) < 0.8
        valid[:, 0] = True
    else:
        valid = np.arange(C)[None, :] < np.asarray(n_valid)[:, None]
    keys = int(valid.sum())   # rows with a valid slot: K and V read
    mean_rows = int((~valid.any(1)).sum())   # rows with none: V read
    valid_t = torch.as_tensor(valid, device=DEVICE)
    it = q.element_size()

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid_t[:, None, None, :], enable_gqa=H != Hkv)

    return check_attention(
        torch, "decode_attention", (B, H, Hkv, C, D), dtype_name,
        lambda: da.decode_attention(q, k, v, valid_t),
        lambda: ref.decode_attention_ref(q, k, v, valid_t), library,
        it * (2 * B * H * D + (2 * keys + mean_rows * C) * Hkv * D) + B * C,
        (keys * 4 + mean_rows * C * 2) * H * D)


def paged_tables(rng, lengths, ps, Pseq, num_pages):
    """Block tables of rows holding ``lengths`` tokens: each row's pages
    are distinct ids of a shuffled pool; entries past a row's last page
    (every entry of a row with no token) point at the scratch page
    ``num_pages``."""
    used = -(-np.asarray(lengths) // ps)
    ids = rng.permutation(num_pages)
    bt = np.full((len(used), Pseq), num_pages, np.int32)
    start = 0
    for b, u in enumerate(used):
        bt[b, :u] = ids[start:start + u]
        start += u
    return bt


def paged_work(lengths, ps, Pseq, window=None):
    """What a paged decode call must read, from this call's lengths:
    per row the counted tokens (K and V, scores and P.V) and the table
    entries of their pages; a row with none (length 0) reads instead the
    V (latents) of all Pseq * ps slots and every table entry, and sums
    them into a uniform mean.  Returns (counted tokens, mean slots,
    table entries)."""
    lengths = np.asarray(lengths, np.int64)
    hi = np.minimum(lengths, Pseq * ps)
    lo = np.maximum(0, lengths - window) if window else np.zeros_like(hi)
    counted = hi > lo
    tokens = int(np.where(counted, hi - lo, 0).sum())
    pages = np.where(counted, -(-hi // ps) - lo // ps, Pseq)
    return tokens, int((~counted).sum()) * Pseq * ps, int(pages.sum())


def check_paged(torch, rng, B, H, Hkv, ps, Pseq, D, lengths, num_pages,
                soft_cap, window, dtype_name):
    """paged_decode_attention on rows of ``lengths`` tokens (see
    ``paged_tables``).  The yardstick (no soft cap) is two calls: a
    gather of each row's pages, then SDPA with the row's mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    lengths = np.asarray(lengths, np.int32)
    bt = paged_tables(rng, lengths, ps, Pseq, num_pages)
    q = _randn(torch, rng, (B, H, D), dtype)
    kp, vp = (_randn(torch, rng, (num_pages + 1, ps, Hkv, D), dtype)
              for _ in range(2))
    bt_t, ln_t = (torch.as_tensor(a, device=DEVICE) for a in (bt, lengths))
    tokens, mean_slots, pages = paged_work(lengths, ps, Pseq, window)
    it = q.element_size()
    kw = dict(soft_cap=soft_cap, window=window)
    t = np.arange(Pseq * ps)[None, :]
    allowed = t < lengths[:, None]
    if window:
        allowed &= lengths[:, None] - 1 - t < window
    mask = torch.as_tensor(allowed, device=DEVICE)[:, None, None, :]
    bt_l = bt_t.long()

    def library():
        k = kp[bt_l].flatten(1, 2).transpose(1, 2)
        v = vp[bt_l].flatten(1, 2).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=H != Hkv)[:, :, 0]

    return check_attention(
        torch, "paged_decode_attention", (B, H, Hkv, ps, Pseq, D),
        dtype_name, lambda: pda.paged_decode_attention(q, kp, vp, bt_t, ln_t,
                                                       **kw),
        lambda: ref.paged_decode_attention_ref(q, kp, vp, bt_t, ln_t, **kw),
        None if soft_cap else library,
        it * (2 * B * H * D + (2 * tokens + mean_slots) * Hkv * D)
        + 4 * (pages + B), (tokens * 4 + mean_slots * 2) * H * D)


def phase_attention_kernels(torch):
    """The LM path's shapes in bf16 (full-width stablelm: 32 heads,
    head_dim 64, prompts in the 64-token bucket; decode at 57 to 64
    cached tokens, the paged tiers' pages filled to their budget), then
    the sweep shapes of tests/test_kernels.py in fp32 and bf16."""
    rng = np.random.default_rng(SEED + 4)
    lens = lambda B: LM_PROMPT + 1 + np.arange(B) % LM_STEPS  # noqa: E731
    main = {"flash_attention": check_flash(torch, rng, 32, 32, 64, 64, 0,
                                           "bfloat16")}
    rows = [main["flash_attention"]]
    for B in (1, 4, 8):
        rows.append(check_decode(torch, rng, B, 32, 32, 256, 64, lens(B),
                                 "bfloat16"))
    main["decode_attention"] = rows[-1]
    # every slot valid: masked slots are not read, so this row's time is
    # the one to set beside the 57-64-valid row's
    rows.append(check_decode(torch, rng, 8, 32, 32, 256, 64, [256] * 8,
                             "bfloat16"))
    for B, pages in ((4, 16), (16, 64), (32, 128)):
        rows.append(check_paged(torch, rng, B, 32, 32, 16, 16, 64, lens(B),
                                pages, 0.0, None, "bfloat16"))
    main["paged_decode_attention"] = rows[-1]
    for dt in ("float32", "bfloat16"):
        for BH, BHkv, T, D in ((2, 2, 128, 64), (2, 2, 256, 32),
                               (2, 2, 256, 128), (2, 2, 100, 64),
                               (8, 4, 77, 32)):
            for window in (0, 64):
                rows.append(check_flash(torch, rng, BH, BHkv, T, D, window,
                                        dt))
        for H, Hkv, C in ((8, 2, 256), (4, 4, 128), (16, 2, 512)):
            rows.append(check_decode(torch, rng, 2, H, Hkv, C, 64, None, dt))
        # a row with no valid slot (the mean of every slot's V) and a row
        # whose only valid slot is the last
        edge = np.zeros((2, 256), bool)
        edge[1, -1] = True
        for H, Hkv in ((8, 2), (32, 32)):
            rows.append(check_decode(torch, rng, 2, H, Hkv, 256, 64, None, dt,
                                     valid=edge))
        # head dims that are no multiple of 16 (zero-padded on the tensor
        # cores in bf16)
        for window in (0, 64):
            rows.append(check_flash(torch, rng, 2, 2, 100, 40, window, dt))
        for H, Hkv, ps, Pseq in ((8, 2, 16, 4), (4, 4, 8, 6)):
            for cap, window in ((0.0, None), (30.0, None), (0.0, 20)):
                rows.append(check_paged(
                    torch, rng, 2, H, Hkv, ps, Pseq, 64,
                    rng.integers(1, Pseq * ps + 1, 2), 2 * Pseq + 3, cap,
                    window, dt))
                # a row with no token (the mean of every slot's V) beside
                # one whose last page is partly filled
                rows.append(check_paged(
                    torch, rng, 2, H, Hkv, ps, Pseq, 64,
                    [0, Pseq * ps - ps // 2 - 1], 2 * Pseq + 3, cap,
                    window, dt))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"attention kernels disagree with their plain "
                             f"versions: {bad}")
    return main


def check_router(torch, rng, T, E, k, tie=False, rounding_tie=False):
    """topk_router at (T, E, k); with ``tie`` the first row's logits are
    all equal, so every probability ties and the picks are 0..k-1; with
    ``rounding_tie`` the first row's top two logits (experts 1 and 0)
    have different exponentials but one probability (the rows of
    tests/test_torch_moe_kernels.py's ``rounding_tie_logits``), so the
    picks start 0, 1.  ``floor_ms``: an empty kernel on the router's
    grid, timed as the router is, the time no kernel body can remove."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_router as tr
    x = rng.normal(size=(T, E)).astype(np.float32)
    if tie:
        x[0] = 0.5
    if rounding_tie:
        x[0] = -200.0
        x[0, :2] = -2.0 ** -24, 0.0
        x[0, 2:11] = np.float32(-3 * np.log(2))
    logits = torch.as_tensor(x, device=DEVICE)
    w, i = tr.topk_router(logits, k)
    wr, ir = ref.topk_router_ref(logits, k)
    torch.cuda.synchronize()
    err = (w - wr).abs().max().item()
    same_idx = bool(torch.equal(i, ir))
    if tie:
        same_idx &= i[0].tolist() == list(range(k))
    if rounding_tie:
        same_idx &= i[0, :2].tolist() == [0, 1]

    def library():
        return torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)

    # logits in, weights and indices out; softmax (max, exp, sum, divide)
    # and k scans over every logit
    nbytes, ops_ = 4 * T * E + 8 * T * k, T * E * (4 + k)
    bound_ms, bound_by = bound(nbytes, ops_)
    def floor():
        build.launch("topk_router_floor", T,
                     torch.cuda.current_stream().cuda_stream)

    row = {"kernel": "topk_router", "shape": [T, E, k], "dtype": "float32",
           "tie_row": tie, "rounding_tie_row": rounding_tie,
           "max_abs_err": err, "tol": ROUTER_TOL, "indices_equal": same_idx,
           "ok": bool(err <= ROUTER_TOL and same_idx),
           **timings(torch, lambda: tr.topk_router(logits, k),
                     lambda: ref.topk_router_ref(logits, k), library, 200,
                     20),
           "floor_ms": device_ms(torch, floor, 200),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": ops_}
    emit({"phase": "kernel_check", **row})
    return row


def check_paged_mla(torch, rng, B, H, R, Dr, ps, Pseq, lengths, num_pages,
                    dtype_name):
    """paged_mla_decode_attention on rows of ``lengths`` tokens (see
    ``paged_tables``).  The yardstick is two calls: a gather of each
    row's pages of [c_kv | k_rope] latents (one pool, made outside the
    timing), then SDPA with the row's mask, every head sharing the one
    latent "kv head"."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    lengths = np.asarray(lengths, np.int32)
    bt = paged_tables(rng, lengths, ps, Pseq, num_pages)
    qc, qr = (_randn(torch, rng, (B, H, w), dtype) for w in (R, Dr))
    ckv, kr = (_randn(torch, rng, (num_pages + 1, ps, w), dtype)
               for w in (R, Dr))
    bt_t, ln_t = (torch.as_tensor(a, device=DEVICE) for a in (bt, lengths))
    scale = 1.0 / np.sqrt(128 + Dr)      # deepseek's nope 128 + rope
    tokens, mean_slots, pages = paged_work(lengths, ps, Pseq)
    it = qc.element_size()
    q_cat = torch.cat([qc, qr], -1)[:, :, None]
    latents = torch.cat([ckv, kr], -1)
    allowed = np.arange(Pseq * ps)[None, :] < lengths[:, None]
    mask = torch.as_tensor(allowed, device=DEVICE)[:, None, None, :]
    bt_l = bt_t.long()

    def library():
        lat = latents[bt_l].flatten(1, 2)[:, None]
        return F.scaled_dot_product_attention(
            q_cat, lat, lat[..., :R], attn_mask=mask, scale=scale,
            enable_gqa=True)[:, :, 0]

    return check_attention(
        torch, "paged_mla_decode_attention", (B, H, R, Dr, ps, Pseq),
        dtype_name,
        lambda: pda.paged_mla_decode_attention(qc, qr, ckv, kr, bt_t, ln_t,
                                               scale=scale),
        lambda: ref.paged_mla_decode_attention_ref(qc, qr, ckv, kr, bt_t,
                                                   ln_t, scale=scale),
        library, it * (B * H * (2 * R + Dr) + tokens * (R + Dr)
                       + mean_slots * R) + 4 * (pages + B),
        (tokens * (2 * R + Dr) + mean_slots * R) * H * 2)


def phase_moe_kernels(torch):
    """The MoE slice's kernels at its shapes (full-width deepseek-v2-lite:
    router over 64 experts top-6 at the 64-token prefill bucket and at 32
    and 1 decode rows; absorbed-MLA paged decode at 16 heads, R 512, Dr
    64, 16-token pages, 57 to 64 cached tokens a row; flash at score dim
    192 and value dim 128), then the sweep shapes of tests/test_kernels.py
    in fp32 and bf16, and tie rows for the router (equal logits; a
    rounding tie)."""
    rng = np.random.default_rng(SEED + 7)
    lens = lambda B: LM_PROMPT + 1 + np.arange(B) % LM_STEPS  # noqa: E731
    main = {}
    rows = [check_router(torch, rng, T, 64, 6) for T in (64, 32, 1)]
    main["topk_router"] = rows[0]
    rows += [check_router(torch, rng, T, E, k, tie)
             for T, E, k in ((64, 16, 4), (128, 60, 4), (32, 64, 6),
                             (1, 60, 4), (33, 60, 4), (7, 200, 8))
             for tie in (False, True)]
    rows += [check_router(torch, rng, T, E, k, rounding_tie=True)
             for T, E, k in ((64, 64, 6), (1, 60, 4), (33, 60, 4))]
    for B, pages in ((1, 16), (4, 16), (32, 128)):
        rows.append(check_paged_mla(torch, rng, B, 16, 512, 64, 16, 16,
                                    lens(B), pages, "bfloat16"))
    main["paged_mla_decode_attention"] = rows[-1]
    rows.append(check_flash(torch, rng, 16, 16, 64, 192, 0, "bfloat16",
                            Dv=128))
    main["flash_attention"] = rows[-1]
    for dt in ("float32", "bfloat16"):
        for H, R, Dr, ps, Pseq in ((8, 64, 16, 16, 4), (4, 128, 32, 8, 3)):
            rows.append(check_paged_mla(
                torch, rng, 2, H, R, Dr, ps, Pseq,
                rng.integers(1, Pseq * ps + 1, 2), 2 * Pseq + 2, dt))
            # a row with no token (the mean of every slot's latent) beside
            # one whose last page is partly filled
            rows.append(check_paged_mla(
                torch, rng, 2, H, R, Dr, ps, Pseq,
                [0, Pseq * ps - ps // 2 - 1], 2 * Pseq + 2, dt))
        # deepseek's widths: a row with no token among full-width rows
        rows.append(check_paged_mla(torch, rng, 3, 16, 512, 64, 16, 16,
                                    [0, 61, 9], 20, dt))
        rows.append(check_flash(torch, rng, 2, 2, 100, 192, 0, dt, Dv=128))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"MoE slice kernels disagree with their plain "
                             f"versions: {bad}")
    return main


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
            "fedavg_reduce": 1 + 2 * len(np.unique(CLUSTER_IDS)) + 1,
            "flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_mla_decode_attention": 0,
            "topk_router": 0, "mamba_chunk_scan": 0}
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
            # the forward's two recurrences (one a layer)
            "gru_seq_ms": sum(v for k, v in kernels.items()
                              if "gru_seq" in k),
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:6])}
    emit({"phase": "profile", "per_request_batch": out})


def hfl_deployment(data, orch, serving, device):
    """The quickstart's inventory over the slice's 20 sensors, clustered by
    HFLOP (l = 2), with one full-width GRU replica per tier on
    ``device``."""
    ds = data.generate(num_days=30, seed=SEED)
    sensors = data.select_fl_sensors(ds, per_cluster=HFL_PER_CLUSTER,
                                     seed=SEED)
    lam = np.random.default_rng(SEED).uniform(2.0, 6.0, len(sensors))
    devices = [orch.DeviceNode(i, lam=float(lam[i]),
                               lan_edge=int(ds.cluster_of[sensors[i]]))
               for i in range(len(sensors))]
    edges = [orch.EdgeNode(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]
    tiers = [serving.TierSpec(t, batch_size=b, reduced=False)
             for t, b in TIER_BATCH.items()]
    controller = orch.LearningController(
        orch.Inventory(devices, edges), l=2, serving_tiers=tiers,
        device=device)
    return ds, sensors, controller, controller.deploy()


def numpy_permutations(torch, seed):
    """A ``permutations`` callable drawing with numpy from ``seed``, one
    draw per round however often the round is asked for, so that two
    runs in turn train on the same minibatch orders.  ``draw.drawn``
    holds the draws by round."""
    rng = np.random.default_rng(seed)

    def draw(t, C, epochs, N):
        if t not in draw.drawn:
            draw.drawn[t] = np.stack([[rng.permutation(N)
                                       for _ in range(epochs)]
                                      for _ in range(C)])
        return torch.from_numpy(draw.drawn[t])

    draw.drawn = {}
    return draw


def phase_hfl(torch):
    """The paper's training pipeline through the entry points a user
    calls: HFLOP clustering, continual hierarchical FedAvg of the
    full-width GRU (every forward in ``gru_seq``, every aggregation in
    ``fedavg_reduce``) on the card and on the CPU from the same numpy
    model and minibatch orders; ``fedavg_reduce`` held against its plain
    version at every shape the run gave it; a profile of one training
    step; the routing simulator with its default latencies and
    calibrated from the deployment's replicas."""
    from repro_torch import data, orchestration, serving
    from repro_torch.configs import get_config
    from repro_torch.fl import client
    from repro_torch.fl.hierarchy import ContinualHFL, HFLRunConfig
    from repro_torch.kernels import ops
    from repro_torch.params import tree_map
    from repro_torch.routing import LatencyModel, SimConfig, compare_methods

    t_phase = time.perf_counter()
    cfg = get_config("gru-traffic")
    m = cfg.model
    ds, sensors, controller, deployment = hfl_deployment(
        data, orchestration, serving, DEVICE)
    topo = deployment.topology
    params0 = tree_map(lambda x: x[0], numpy_clients(
        np.random.default_rng(SEED + 4), m, 1))
    run = HFLRunConfig(**HFL_RUN)
    perms = numpy_permutations(torch, SEED + 5)

    def train(device):
        hfl = ContinualHFL(cfg, ds, sensors, topo, run, mode="hier",
                           params0=params0, permutations=perms,
                           device=device)
        t0 = time.perf_counter()
        res = hfl.run_rounds()
        if device == DEVICE:
            torch.cuda.synchronize()
        return hfl, res, (time.perf_counter() - t0) / run.rounds

    ops.reset_launches()
    hfl, card, card_s = train(DEVICE)
    launches = ops.launch_counts()
    hfl_cpu, cpu, cpu_s = train("cpu")

    C = len(sensors)
    N = perms.drawn[0].shape[-1]                    # windows per client
    n_batches = min(N // run.batch_size, run.max_batches)
    K = len(np.unique(hfl.cluster_ids))
    want = {k: 0 for k in launches}
    want["gru_seq"] = (m.rnn_layers * run.rounds * C
                       * (run.local_epochs * n_batches + 1))
    want["fedavg_reduce"] = K + (K + 1)         # a local and a global round
    # the run's reductions: each cluster's clients, then the K cluster
    # models in the global round, over every parameter of the model
    n_params = param_count(tree_map(lambda x: x[0], hfl.params))
    fed_shapes = sorted({int(c) for c in np.bincount(hfl.cluster_ids)
                         if c} | {K}, reverse=True)
    fed_rows = [check_fedavg_reduce(torch, np.random.default_rng(SEED + 6),
                                    c, n_params, "float32")
                for c in fed_shapes]
    errs = {"mse_max_rel_err": float(np.max(np.abs(card.mse - cpu.mse)
                                            / np.abs(cpu.mse))),
            "train_loss_max_rel_err": float(np.max(
                np.abs(card.train_loss - cpu.train_loss)
                / np.abs(cpu.train_loss))),
            "params_max_abs_err": max_tree_err(hfl.params, hfl_cpu.params)}

    # one training step of one client at the slice's batch, profiled
    rng = np.random.default_rng(SEED + 7)
    p = tree_map(lambda x: x[0].detach().clone().requires_grad_(),
                 hfl.params)
    X, y = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=DEVICE)
            for s in ((run.batch_size, HISTORY, 1), (run.batch_size, 1)))

    def step():
        return client.sgd_step(p, m, X, y, run.lr)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HFL_PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / HFL_PROFILE_STEPS
    step_profile = profile_once(torch, step, HFL_PROFILE_STEPS, top=None)
    step_profile["gru_seq_ms"] = sum(
        v for k, v in step_profile["kernels_ms"].items() if "gru_seq" in k)
    step_profile["kernels_ms"] = dict(
        list(step_profile["kernels_ms"].items())[:8])

    # the routing simulator, default and calibrated from the replicas
    ops.reset_launches()
    calibrated = deployment.calibrated_latency()
    torch.cuda.synchronize()
    calib_launches = ops.launch_counts()
    inst = controller.inventory.to_instance(l=2)
    assigns = {"flat": None, "hflop": topo.assign}
    sims = {}
    for name, lat in (("default", LatencyModel()),
                      ("calibrated", calibrated)):
        logs = compare_methods(inst, assigns, SimConfig(
            duration_s=HFL_SIM_S, seed=SEED, latency=lat))
        sims[name] = {k: {"mean_ms": log.mean_latency(),
                          "std_ms": log.std_latency(),
                          "tier_fractions": log.tier_fractions()}
                      for k, log in logs.items()}
    calib_want = {k: 0 for k in calib_launches}
    # measure(): one warm-up and 8 timed forwards per tier
    calib_want["gru_seq"] = m.rnn_layers * 9 * len(TIER_BATCH)

    checks = {
        "full_width": tuple(hfl.params["gru"]["1"]["w_h"].shape)
        == (C, 128, 384),
        "val_mse_matches_cpu": errs["mse_max_rel_err"] <= HFL_TOL,
        "params_match_cpu": errs["params_max_abs_err"] <= HFL_TOL,
        "finite": all(np.isfinite(r.mse).all()
                      and np.isfinite(r.train_loss).all()
                      for r in (card, cpu)) and all_finite(hfl.params),
        "shapes": card.mse.shape == card.train_loss.shape == (run.rounds, C),
        "launches": launches == want,
        "fedavg_reduce_matches_plain": all(r["ok"] for r in fed_rows),
        "calibration_launches": calib_launches == calib_want,
        "calibrated_latencies_finite": all(
            np.isfinite(v["mean_ms"]) and np.isfinite(v["std_ms"])
            for sim in sims.values() for v in sim.values()),
    }
    emit({"phase": "hfl_slice", "seconds": time.perf_counter() - t_phase,
          "clients": C, "clusters": K,
          "assign": topo.assign.tolist(), "windows_per_client": N,
          "minibatches_per_epoch": n_batches, **HFL_RUN,
          "seconds_per_round": {"card": card_s, "cpu": cpu_s},
          "val_mse": card.mse.mean(axis=1).tolist(),
          "errors": errs, "launches": launches,
          "expected_launches": want,
          "fedavg_reduce_shapes": [r["shape"] for r in fed_rows],
          "calibration_launches": calib_launches,
          "train_step": {"batch": run.batch_size, "step_ms": step_ms,
                         **step_profile},
          "infer_ms": {t: {"default": LatencyModel().infer_ms(t),
                           "calibrated": calibrated.infer_ms(t)}
                       for t in TIER_BATCH},
          "latency": sims, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hfl_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def count_calls(engine, counts) -> None:
    """Count the engine's admissions and decode steps as the main path
    makes them (``generate`` and ``measure`` call both through the
    instance), independently of the kernels' launch counters; with a
    ``prompt_tokens`` key, also the admitted prompts' tokens."""
    for name in ("admit", "decode"):
        def counted(*args, _fn=getattr(engine, name), _name=name, **kw):
            counts[_name] += 1
            if _name == "admit" and "prompt_tokens" in counts:
                counts["prompt_tokens"] += len(args[0])
            return _fn(*args, **kw)
        setattr(engine, name, counted)


def full_width_tiers(specs):
    return [dataclasses.replace(s, reduced=False) for s in specs]


def norm_params(m) -> int:
    """Weights ``ModelConfig.param_count()`` leaves out: the norms' scales
    (and LayerNorm biases), and each MLA layer's ``kv_norm``."""
    n = (2 * m.num_layers + 1) * m.d_model * (2 if m.norm == "layernorm"
                                              else 1)
    if m.attention.kind == "mla":
        n += m.num_layers * m.attention.mla.kv_lora_rank
    return n


def expected_lm_launches(m, calls):
    """Kernel launches of the LM engines' calls: one attention launch per
    layer per admission (flash) and per decode step (the dense or paged
    decode kernel of the attention kind; MLA's dense decode has none),
    one router launch per MoE layer per admission and per step."""
    L = m.num_layers
    moe_layers = L - m.moe.first_dense_layers if m.moe else 0
    mla = m.attention.kind == "mla"
    admits = calls["dense"]["admit"] + calls["paged"]["admit"]
    dense, paged = calls["dense"]["decode"], calls["paged"]["decode"]
    return {"gru_seq": 0, "fedavg_reduce": 0,
            "flash_attention": L * admits,
            "decode_attention": 0 if mla else L * dense,
            "paged_decode_attention": 0 if mla else L * paged,
            "paged_mla_decode_attention": L * paged if mla else 0,
            "topk_router": moe_layers * (admits + dense + paged),
            "mamba_chunk_scan": 0}


def phase_lm(torch, arch, phase):
    """An LM main path: ``arch`` at full width in bf16, weights drawn on
    the card from a seed, one weight tree shared by a dense and a paged
    pool, through the entry points a user calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, lm_tiers, paged_lm_tiers

    cfg = get_config(arch)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    dense = ReplicaPool(full_width_tiers(lm_tiers(arch)),
                        shared_params=params, device=DEVICE)
    paged = ReplicaPool(full_width_tiers(paged_lm_tiers(arch)),
                        shared_params=params, device=DEVICE)
    counts = {kind: {t: {"admit": 0, "decode": 0} for t in dense.tiers}
              for kind in ("dense", "paged")}
    for kind, pool in (("dense", dense), ("paged", paged)):
        for tier in pool.tiers:
            count_calls(pool.engine(tier), counts[kind][tier])
    rng = np.random.default_rng(SEED + 5)
    batches = {t: [rng.integers(0, m.vocab_size,
                                (paged.specs[t].batch_size, LM_PROMPT))
                   for _ in range(LM_BATCHES_PER_TIER)] for t in dense.tiers}

    ops.reset_launches()
    t0 = time.perf_counter()
    outs = {"dense": {t: [] for t in dense.tiers},
            "paged": {t: [] for t in paged.tiers}}
    for tier, bs in batches.items():
        rows = dense.specs[tier].batch_size
        for b in bs:
            outs["dense"][tier].append(dense.dispatch(tier, b[:rows],
                                                      steps=LM_STEPS))
            outs["paged"][tier].append(paged.dispatch(tier, b,
                                                      steps=LM_STEPS))
    dense.mark_down("edge")
    before = (dense.failovers, counts["dense"]["edge"]["admit"],
              counts["dense"]["cloud"]["admit"])
    fo_batch = batches["edge"][0][:dense.specs["edge"].batch_size]
    failover_out = dense.dispatch("edge", fo_batch, steps=LM_STEPS)
    failovers = dense.failovers - before[0]
    served_by_cloud = (counts["dense"]["edge"]["admit"] == before[1]
                       and counts["dense"]["cloud"]["admit"] - before[2]
                       == len(fo_batch))
    dense.mark_up("edge")
    measured = {"dense": dense.measure(**LM_MEASURE),
                "paged": paged.measure(**LM_MEASURE)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()

    lat = {k: LatencyModel.from_measurements(v, decode_tokens=LM_STEPS)
           for k, v in measured.items()}
    # logits of the served model through the model API (after the counted
    # run): one prompt's prefill and one decode step
    prompt = torch.as_tensor(batches["cloud"][0][:1], device=DEVICE)
    cache = api.init_cache(1, 256, device=DEVICE)
    logits, cache = api.prefill(params, prompt, cache, length=LM_PROMPT)
    step, _ = api.decode_step(params, prompt[:, -1:],
                              torch.tensor([LM_PROMPT], device=DEVICE), cache)
    calls = {k: {c: sum(v[t][c] for t in v) for c in ("admit", "decode")}
             for k, v in counts.items()}
    want = expected_lm_launches(m, calls)
    all_out = [o for k in outs for t in outs[k] for o in outs[k][t]]
    first_same = all(
        torch.equal(d[:, 0], p[:d.shape[0], 0])
        for t in dense.tiers
        for d, p in zip(outs["dense"][t], outs["paged"][t]))
    later = [(d[:, 1:] == p[:d.shape[0], 1:]).float().mean().item()
             for t in dense.tiers
             for d, p in zip(outs["dense"][t], outs["paged"][t])]
    routers_fp32 = all(x.dtype == torch.float32 for path, x in leaves.items()
                       if path[-1] == "router")
    checks = {
        "full_width": (m.d_model == 2048
                       and all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[arch].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and routers_fp32
                       and n_params == m.param_count() + norm_params(m)),
        "finite_logits": bool(logits.isfinite().all()
                              and step.isfinite().all()),
        "shapes": all(
            tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
            for k, pool in (("dense", dense), ("paged", paged))
            for t in pool.tiers for o in outs[k][t]),
        "token_ids": all(bool(((o >= 0) & (o < m.vocab_size)).all())
                         for o in all_out),
        "dense_paged_first_tokens_equal": first_same,
        "failover_to_cloud": (failovers == 1 and served_by_cloud
                              and torch.equal(failover_out[:, 0],
                                              outs["dense"]["edge"][0][:, 0])),
        "latency_model": all(np.isfinite(lat[k].infer_ms(t)) and
                             lat[k].infer_ms(t) > 0
                             for k in lat for t in dense.tiers),
        "launches": launches == want and all(
            launches[k] > 0 for k, v in want.items() if v),
    }
    emit({"phase": phase, "arch": arch, "params": n_params,
          "config_param_count": m.param_count(), "norm_params": norm_params(m),
          "layers": m.num_layers, "d_model": m.d_model,
          "init_seconds": init_s, "seconds": seconds,
          "engine_calls": counts, "launches": launches,
          "expected_launches": want,
          "later_tokens_dense_paged_agree": float(np.mean(later)),
          "measured": {k: {t: dataclasses.asdict(mm) for t, mm in v.items()}
                       for k, v in measured.items()},
          "calibrated_infer_ms": {k: {t: lat[k].infer_ms(t)
                                      for t in dense.tiers} for k in lat},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, dense, paged, batches


def profile_once(torch, fn, n: int = 1, top=8):
    """``n`` calls of ``fn`` under ``torch.profiler``, per call: the wall
    time, the device time by kernel (the ``top`` largest; all when
    ``top`` is None), the kernel launches and the share of the wall time
    the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    kernels = {}
    for e in events:
        key = e.key[:80]
        kernels[key] = (kernels.get(key, 0.0)
                        + e.self_device_time_total / 1e3 / n)
    dev_ms = sum(kernels.values())
    return {"wall_ms": wall_ms, "device_ms": dev_ms or None,
            "device_idle_share": (1.0 - dev_ms / wall_ms
                                  if dev_ms else None),
            "device_launches": sum(e.count for e in events) / n,
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:top])}


def profile_decode_steps(torch, pools, batches):
    """One decode step per LM tier with every row admitted: device time
    by kernel (``torch.profiler``) against the step's wall time."""
    out = {}
    for kind, pool in pools.items():
        for tier in pool.tiers:
            eng = pool.engine(tier)
            for prompt in batches[tier][0][:eng.batch_size]:
                eng.admit(prompt, slot=eng.acquire_slot(),
                          reserve_tokens=LM_STEPS)
            eng.decode()
            out[f"{kind}/{tier}"] = {"rows": eng.batch_size,
                                     **profile_once(torch, eng.decode)}
            eng.drain()
    return out


def phase_lm_profile(torch, dense, paged, batches, phase):
    emit({"phase": phase, "per_decode_step": profile_decode_steps(
        torch, {"dense": dense, "paged": paged}, batches)})


def numpy_lm_params(rng, m):
    """stablelm weights in the JAX package's tree and statistics
    (``ParamBuilder``: embedding normal 0.02, fan-in normal elsewhere,
    norm scales 1 and biases 0), drawn with numpy."""
    a, L, d, f = m.attention, m.num_layers, m.d_model, m.d_ff
    H, Hkv, hd, V = a.num_heads, a.num_kv_heads, a.head_dim, m.padded_vocab

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def norm(*lead):
        return {"scale": np.ones(lead + (d,), np.float32),
                "bias": np.zeros(lead + (d,), np.float32)}

    return {"embed": {"table": draw((V, d), 0.02)},
            "lm_head": {"w": draw((d, V), d ** -0.5)},
            "final_norm": norm(),
            "layers": {
                "ln1": norm(L), "ln2": norm(L),
                "attn": {"wq": draw((L, d, H, hd), H ** -0.5),
                         "wk": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wv": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wo": draw((L, H, hd, d), hd ** -0.5)},
                "mlp": {"wi_gate": draw((L, d, f), d ** -0.5),
                        "wi_up": draw((L, d, f), d ** -0.5),
                        "wo": draw((L, f, d), f ** -0.5)}}}


def numpy_moe_params(rng, m):
    """deepseek-v2-lite weights cut to one lead dense layer and
    ``m.num_layers - 1`` stacked MoE layers, in the JAX package's tree and
    statistics (``ParamBuilder``: embedding normal 0.02, fan-in normal
    elsewhere, RMS norm scales 1, fp32 routers), drawn with numpy."""
    a, mo, d, V = m.attention, m.moe, m.d_model, m.padded_vocab
    ml, H, E = a.mla, a.num_heads, mo.num_experts
    L = m.num_layers - mo.first_dense_layers

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ones(*shape):
        return np.ones(shape, np.float32)

    def mlp(f, *lead):
        return {"wi_gate": draw(lead + (d, f), d ** -0.5),
                "wi_up": draw(lead + (d, f), d ** -0.5),
                "wo": draw(lead + (f, d), f ** -0.5)}

    def layer(*lead):
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        R = ml.kv_lora_rank
        return {"ln1": {"scale": ones(*lead, d)},
                "ln2": {"scale": ones(*lead, d)},
                "attn": {"wq": draw(lead + (d, H, qk), H ** -0.5),
                         "w_dkv": draw(lead + (d, R), d ** -0.5),
                         "w_krope": draw(lead + (d, ml.qk_rope_head_dim),
                                         d ** -0.5),
                         "kv_norm": ones(*lead, R),
                         "w_uk": draw(lead + (R, H, ml.qk_nope_head_dim),
                                      H ** -0.5),
                         "w_uv": draw(lead + (R, H, ml.v_head_dim),
                                      H ** -0.5),
                         "wo": draw(lead + (H, ml.v_head_dim, d),
                                    ml.v_head_dim ** -0.5)}}

    moe = {"router": draw((L, d, E), d ** -0.5),
           "wi_gate": draw((L, E, d, mo.d_expert), d ** -0.5),
           "wi_up": draw((L, E, d, mo.d_expert), d ** -0.5),
           "wo": draw((L, E, mo.d_expert, d), mo.d_expert ** -0.5),
           "shared": mlp(mo.d_shared, L)}
    return {"embed": {"table": draw((V, d), 0.02)},
            "lm_head": {"w": draw((d, V), d ** -0.5)},
            "final_norm": {"scale": ones(d)},
            "lead": {str(i): {**layer(), "mlp": mlp(mo.dense_d_ff)}
                     for i in range(mo.first_dense_layers)},
            "layers": {**layer(L), "moe": moe}}


def phase_lm_parity(torch, arch, phase, numpy_params):
    """Full-width ``arch`` cut to 2 layers, fp32, weights from a numpy
    seed (``numpy_params``): the same entry points on the card (kernels)
    and on the CPU (plain versions), for both engines."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import from_numpy_tree
    from repro_torch.serving import PagedServeEngine, ServeEngine

    cfg = get_config(arch)
    m = dataclasses.replace(cfg.model, num_layers=PARITY_LAYERS,
                            dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    rng = np.random.default_rng(SEED + 6)
    tree = numpy_params(rng, m)
    prompts = rng.integers(0, m.vocab_size, (2, LM_PROMPT))
    api = make_model(pcfg)
    logits, tokens = {}, {}
    for dev in (DEVICE, "cpu"):
        params = from_numpy_tree(tree, dev)
        padded = torch.zeros((2, 64), dtype=torch.long, device=dev)
        padded[:, :LM_PROMPT] = torch.as_tensor(prompts)
        lg, _ = api.prefill(params, padded, api.init_cache(2, 256, device=dev),
                            length=LM_PROMPT)
        logits[dev] = lg[:, :LM_PROMPT].float().cpu()
        for name, eng in (
                ("dense", ServeEngine(pcfg, params, batch_size=2,
                                      max_len=256, device=dev)),
                ("paged", PagedServeEngine(pcfg, params, max_seqs=2,
                                           max_len=256, device=dev))):
            tokens[(name, dev)] = eng.generate(prompts, LM_STEPS).cpu()
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    checks = {"prefill_logits_match_cpu": err <= PARITY_LOGIT_TOL,
              "dense_tokens_match_cpu": torch.equal(tokens[("dense", DEVICE)],
                                                    tokens[("dense", "cpu")]),
              "paged_tokens_match_cpu": torch.equal(tokens[("paged", DEVICE)],
                                                    tokens[("paged", "cpu")])}
    emit({"phase": phase, "arch": arch, "layers": m.num_layers,
          "d_model": m.d_model,
          "dtype": m.dtype, "prefill_logits_max_abs_err": err,
          "tol": PARITY_LOGIT_TOL,
          "tokens": {f"{k}/{d}": v.tolist() for (k, d), v in tokens.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def check_mamba_scan(torch, rng, B, L, H, P, N, Q, dtype_name):
    """mamba_chunk_scan at one shape: sweep-style inputs (normal x, B,
    C; dt uniform in [0.01, 0.2); A in -[0.5, 2)), error of y and of the
    final state against the plain version, times, and the bound of the
    work: C.B^T once per batch and chunk (causal, Q(Q+1)/2 pairs), and
    per head the causal scores . u, C . S and the B (x) u update."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    x = _randn(torch, rng, (B, L, H, P), dtype)
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32, device=DEVICE)
    A = torch.as_tensor(-rng.uniform(0.5, 2.0, H), dtype=torch.float32,
                        device=DEVICE)
    Bm, Cm = (_randn(torch, rng, (B, L, N), dtype) for _ in range(2))
    y, st = ms.mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=Q)
    yr, sr = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype_name]
    err = (y.float() - yr.float()).abs().max().item()
    state_err = (st - sr).abs().max().item()
    ok = bool(y.dtype == dtype and st.dtype == torch.float32
              and torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol)
              and torch.allclose(st, sr, atol=SCAN_STATE_TOL,
                                 rtol=SCAN_STATE_TOL))
    it = x.element_size()
    nbytes = it * (2 * B * L * H * P + 2 * B * L * N) \
        + 4 * (B * L * H + H + B * H * N * P)
    pairs = Q * (Q + 1)          # 2 x the causal pairs of a chunk
    flops = B * (L // Q) * (pairs * N + H * (pairs * P + 4 * Q * N * P))
    # the bf16 instance on the tensor cores (chunk and N multiples of 16,
    # P of 8; csrc/mamba_chunk_scan.cu) is bound at their bf16 rate
    tc = (dtype_name == "bfloat16" and ms.kernel_chunk(Q) % 16 == 0
          and N % 16 == 0 and P % 8 == 0)
    bound_ms, bound_by = bound(nbytes, flops,
                               BF16_FLOP_PER_S if tc else FP32_FLOP_PER_S)
    row = {"kernel": "mamba_chunk_scan", "shape": [B, L, H, P, N, Q],
           "dtype": dtype_name, "tensor_cores": tc,
           "max_abs_err": err, "tol": tol,
           "state_max_abs_err": state_err, "state_tol": SCAN_STATE_TOL,
           "ok": ok,
           **timings(torch, lambda: ms.mamba_chunk_scan(x, dt, A, Bm, Cm,
                                                        chunk=Q),
                     lambda: ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, Q),
                     None, 50, 10),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops,
           # device ms a call of each of the kernel's three launches (local
           # states, state pass, outputs)
           "kernels_ms": kernel_split_ms(
               torch, lambda: ms.mamba_chunk_scan(x, dt, A, Bm, Cm,
                                                  chunk=Q))}
    emit({"phase": "kernel_check", **row})
    return row


def phase_ssm_kernels(torch):
    """mamba_chunk_scan at the zamba2-1.2b forward's shape in bf16 (B 2,
    L 1024, 64 heads of P 64, N 64, chunk 128), then the sweep shapes
    of tests/test_kernels.py in fp32 and a few edge shapes; then
    flash_attention at the forward's shape (BH 64, T 1024, D 64,
    bf16)."""
    rng = np.random.default_rng(SEED + 9)
    B, L = HYBRID_BATCH
    rows = [check_mamba_scan(torch, rng, B, L, 64, 64, 64, 128, "bfloat16")]
    rows += [check_mamba_scan(torch, rng, 2, *shape, "float32")
             for shape in ((128, 4, 16, 8, 32), (64, 2, 32, 16, 64),
                           (96, 8, 8, 8, 32))]
    # the forward's shape at B 1, one chunk, H off the kernel's 4-head
    # tile, P 40 on the tensor cores and N 8 off them; fp32 at the
    # forward's widths (the parity cut's instance)
    rows += [check_mamba_scan(torch, rng, *shape, dt)
             for shape, dt in (((1, L, 64, 64, 64, 128), "bfloat16"),
                               ((2, 128, 6, 64, 64, 128), "bfloat16"),
                               ((2, 256, 3, 40, 32, 128), "bfloat16"),
                               ((2, 128, 4, 16, 8, 32), "bfloat16"),
                               ((2, 256, 64, 64, 64, 128), "float32"))]
    # the forward's shared attention: 2 x 32 heads of 64 over 1024 tokens
    # (window 4096 > T, so none)
    flash = check_flash(torch, rng, B * 32, B * 32, L, 64, 0, "bfloat16")
    bad = [r for r in rows + [flash] if not r["ok"]]
    if bad:
        raise AssertionError(f"hybrid forward kernels disagree with their "
                             f"plain versions: {bad}")
    return rows[0], flash


def expected_hybrid_launches(m, forwards, prompt_tokens, steps):
    """Per forward one mamba_chunk_scan per Mamba2 layer and one
    flash_attention per complete segment; serving one decode_attention
    per complete segment per prompt token (the recurrent prefill runs
    the decode step) and per decode step, and no other kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models.hybrid import _segments
    shared = sum(complete for _, _, complete in _segments(m))
    zero = {k: 0 for k in ops.launch_counts()}
    return ({**zero, "mamba_chunk_scan": m.num_layers * forwards,
             "flash_attention": shared * forwards},
            {**zero, "decode_attention": shared * (prompt_tokens + steps)})


def phase_hybrid(torch):
    """The hybrid's main paths: zamba2-1.2b at full width in bf16,
    weights drawn on the card from a seed, (a) forward and loss on a
    (2, 1024) batch, (b) the dense tiers of ``lm_tiers`` serving request
    batches, one failover and ``measure()``.  Launches are counted from
    0 before (a) and read after (a) and after (b)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, lm_tiers

    cfg = get_config(HYBRID_ARCH)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    pool = ReplicaPool(full_width_tiers(lm_tiers(HYBRID_ARCH)),
                       shared_params=params, device=DEVICE)
    counts = {t: {"admit": 0, "decode": 0, "prompt_tokens": 0}
              for t in pool.tiers}
    for tier in pool.tiers:
        count_calls(pool.engine(tier), counts[tier])
    rng = np.random.default_rng(SEED + 10)
    toks = torch.as_tensor(rng.integers(0, m.vocab_size, HYBRID_BATCH),
                           device=DEVICE)
    labels = torch.as_tensor(rng.integers(0, m.vocab_size, HYBRID_BATCH),
                             device=DEVICE)
    batches = {t: [rng.integers(0, m.vocab_size,
                                (pool.specs[t].batch_size, LM_PROMPT))
                   for _ in range(LM_BATCHES_PER_TIER)] for t in pool.tiers}

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = api.forward(params, {"tokens": toks})
        loss = api.loss(params, {"tokens": toks, "labels": labels})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    after_forward = ops.launch_counts()
    t0 = time.perf_counter()
    outs = {t: [pool.dispatch(t, b, steps=LM_STEPS) for b in bs]
            for t, bs in batches.items()}
    pool.mark_down("edge")
    before = (pool.failovers, counts["edge"]["admit"],
              counts["cloud"]["admit"])
    failover_out = pool.dispatch("edge", batches["edge"][0], steps=LM_STEPS)
    failovers = pool.failovers - before[0]
    served_by_cloud = (counts["edge"]["admit"] == before[1]
                       and counts["cloud"]["admit"] - before[2]
                       == len(batches["edge"][0]))
    pool.mark_up("edge")
    measured = pool.measure(**HYBRID_MEASURE)
    torch.cuda.synchronize()
    serving_s = time.perf_counter() - t0
    total = ops.launch_counts()
    serving = {k: total[k] - after_forward[k] for k in total}

    lat = LatencyModel.from_measurements(measured, decode_tokens=LM_STEPS)
    calls = {c: sum(v[c] for v in counts.values())
             for c in ("admit", "decode", "prompt_tokens")}
    want_forward, want_serving = expected_hybrid_launches(
        m, 2, calls["prompt_tokens"], calls["decode"])
    all_out = [o for os_ in outs.values() for o in os_]
    fp32_leaves = {k[-1] for k, x in leaves.items()
                   if x.dtype == torch.float32}
    checks = {
        "full_width": (m.d_model == 2048 and m.num_layers == 38
                       and all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[HYBRID_ARCH].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and fp32_leaves == {"A_log", "D", "dt_bias"}
                       and n_params == HYBRID_PARAMS),
        "forward_finite": bool(logits.isfinite().all()
                               and loss.isfinite().all()),
        "forward_shape": (tuple(logits.shape) == HYBRID_BATCH
                          + (m.padded_vocab,)
                          and logits.dtype == torch.bfloat16
                          and float(aux) == 0.0),
        "shapes": all(tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
                      for t, os_ in outs.items() for o in os_),
        "token_ids": all(bool(((o >= 0) & (o < m.vocab_size)).all())
                         for o in all_out + [failover_out]),
        "failover_to_cloud": (failovers == 1 and served_by_cloud
                              and torch.equal(failover_out[:, 0],
                                              outs["edge"][0][:, 0])),
        "latency_model": all(np.isfinite(lat.infer_ms(t))
                             and lat.infer_ms(t) > 0 for t in pool.tiers),
        "forward_launches": after_forward == want_forward,
        "serving_launches": serving == want_serving
        and serving["decode_attention"] > 0,
    }
    emit({"phase": "hybrid_slice", "arch": HYBRID_ARCH, "params": n_params,
          "config_param_count": m.param_count(), "layers": m.num_layers,
          "d_model": m.d_model, "init_seconds": init_s,
          "forward_seconds": forward_s, "serving_seconds": serving_s,
          "loss": float(loss), "engine_calls": counts,
          "launches": total, "forward_launches": after_forward,
          "expected_forward_launches": want_forward,
          "serving_launches": serving,
          "expected_serving_launches": want_serving,
          "measured": {t: dataclasses.asdict(mm)
                       for t, mm in measured.items()},
          "calibrated_infer_ms": {t: lat.infer_ms(t) for t in pool.tiers},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hybrid_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return total, pool, batches, params, toks


def phase_hybrid_profile(torch, pool, batches, params, toks):
    """One decode step per dense tier with every row admitted (8-token
    prompts), and one forward of the (2, 1024) batch: device ms by kernel
    and idle share."""
    from repro_torch.models import make_model
    api = make_model(pool.engine("device").cfg)

    def forward():
        with torch.no_grad():
            api.forward(params, {"tokens": toks})

    forward()
    short = {t: [b[:, :HYBRID_PROFILE_PROMPT] for b in bs]
             for t, bs in batches.items()}
    emit({"phase": "hybrid_profile",
          "per_decode_step": profile_decode_steps(torch, {"dense": pool},
                                                  short),
          "forward": {"batch": list(HYBRID_BATCH),
                      **profile_once(torch, forward)}})


def numpy_hybrid_params(rng, m):
    """zamba2 weights in the JAX package's tree and statistics
    (``ParamBuilder``: embedding normal 0.02, fan-in normal elsewhere,
    RMS norm scales 1, conv bias 0), drawn with numpy; A_log, dt_bias
    and D are drawn away from their 0 / 0 / 1 init so every head's decay
    and skip differ."""
    a, s, L, d, f, V = (m.attention, m.ssm, m.num_layers, m.d_model,
                        m.d_ff, m.padded_vocab)
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    d_in = d * s.expand
    Hs = d_in // s.head_dim
    ch = d_in + 2 * s.ngroups * s.state_dim
    e = 2 * d_in + 2 * s.ngroups * s.state_dim + Hs

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ones(*shape):
        return np.ones(shape, np.float32)

    return {"embed": {"table": draw((V, d), 0.02)},
            "final_norm": {"scale": ones(d)},
            "mamba_layers": {
                "ln": {"scale": ones(L, d)},
                "mamba": {"in_proj": draw((L, d, e), d ** -0.5),
                          "conv_w": draw((L, s.conv_width, ch),
                                         s.conv_width ** -0.5),
                          "conv_b": np.zeros((L, ch), np.float32),
                          "A_log": draw((L, Hs), 0.5),
                          "D": 1.0 + draw((L, Hs), 0.2),
                          "dt_bias": draw((L, Hs), 0.5),
                          "norm_scale": ones(L, d_in),
                          "out_proj": draw((L, d_in, d), d_in ** -0.5)}},
            "shared": {"ln1": {"scale": ones(d)}, "ln2": {"scale": ones(d)},
                       "attn": {"wq": draw((d, H, hd), H ** -0.5),
                                "wk": draw((d, Hkv, hd), Hkv ** -0.5),
                                "wv": draw((d, Hkv, hd), Hkv ** -0.5),
                                "wo": draw((H, hd, d), hd ** -0.5)},
                       "mlp": {"wi_gate": draw((d, f), d ** -0.5),
                               "wi_up": draw((d, f), d ** -0.5),
                               "wo": draw((f, d), f ** -0.5)}}}


@contextlib.contextmanager
def fp64_upcasts(torch):
    """The port takes norms, activations and the SSD scan in fp32 through
    ``Tensor.float()``; inside this block that returns fp64, so fp64
    weights on the CPU run the same code in fp64: the reference the
    parity phase measures both fp32 forwards against."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def phase_hybrid_parity(torch):
    """Full-width zamba2 cut to 6 layers (one complete segment), fp32,
    numpy weights: the forward on the card (kernels) against the CPU
    (plain versions), stepwise decode on the card against the card's
    forward, and the dense engine's greedy tokens on both; each forward's
    distance from an fp64 forward of the same code is reported."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import from_numpy_tree, tree_map
    from repro_torch.serving import ServeEngine

    cfg = get_config(HYBRID_ARCH)
    m = dataclasses.replace(cfg.model, num_layers=HYBRID_PARITY_LAYERS,
                            dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    rng = np.random.default_rng(SEED + 11)
    tree = numpy_hybrid_params(rng, m)
    toks = rng.integers(0, m.vocab_size, (2, HYBRID_PARITY_SEQ))
    prompts = rng.integers(0, m.vocab_size, (2, LM_PROMPT))
    api = make_model(pcfg)
    logits, tokens = {}, {}
    with torch.no_grad():
        for dev in (DEVICE, "cpu"):
            params = from_numpy_tree(tree, dev)
            logits[dev] = api.forward(params, {"tokens": torch.as_tensor(
                toks, device=dev)})[0].cpu()
            tokens[dev] = ServeEngine(pcfg, params, batch_size=2,
                                      max_len=256,
                                      device=dev).generate(prompts,
                                                           LM_STEPS).cpu()
            if dev == DEVICE:
                cache = api.init_cache(2, HYBRID_PARITY_SEQ, device=dev)
                t_dev = torch.as_tensor(toks, device=dev)
                steps = []
                for t in range(HYBRID_PARITY_SEQ):
                    lg, cache = api.decode_step(params, t_dev[:, t:t + 1],
                                                torch.tensor(t, device=dev),
                                                cache)
                    steps.append(lg[:, 0].cpu())
                stepwise = torch.stack(steps, 1)
            del params
        p64 = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float64),
                       tree)
        with fp64_upcasts(torch):
            exact = api.forward(p64, {"tokens": torch.as_tensor(toks)})[0]
        del p64
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    decode_err = (stepwise - logits[DEVICE]).abs().max().item()
    checks = {"forward_logits_match_cpu": err <= HYBRID_PARITY_LOGIT_TOL,
              "decode_matches_forward": bool(torch.allclose(
                  stepwise, logits[DEVICE], atol=DECODE_TOL,
                  rtol=DECODE_TOL)),
              "tokens_match_cpu": torch.equal(tokens[DEVICE],
                                              tokens["cpu"])}
    emit({"phase": "hybrid_parity", "arch": HYBRID_ARCH,
          "layers": m.num_layers, "d_model": m.d_model, "dtype": m.dtype,
          "seq": HYBRID_PARITY_SEQ, "forward_logits_max_abs_err": err,
          "fp64_max_abs_err": {d: (v.double() - exact).abs().max().item()
                               for d, v in logits.items()},
          "tol": HYBRID_PARITY_LOGIT_TOL, "decode_max_abs_err": decode_err,
          "decode_tol": DECODE_TOL,
          "tokens": {d: v.tolist() for d, v in tokens.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hybrid_parity checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def kernel_entry(name, source, replaces, launches, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"], "shape": row["shape"],
            "dtype": row["dtype"],
            **({"floor_ms": row["floor_ms"]} if "floor_ms" in row else {})}


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
    t_start = time.perf_counter()
    try:
        smi = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "sass"
        phase_sass()
        from repro_torch.configs import get_config
        one = numpy_clients(np.random.default_rng(SEED),
                            get_config("gru-traffic").model, 1)
        n_params = param_count(one)
        phase = "kernels"
        gru_rows, fed_rows = phase_kernels(torch, n_params)
        phase = "autograd"
        phase_autograd(torch)
        phase = "attention_kernels"
        attn_rows = phase_attention_kernels(torch)
        phase = "slice"
        launches, pool, measured = phase_slice(torch)
        phase = "profile"
        phase_profile(torch, pool, measured)
        del pool
        phase = "hfl_slice"
        hfl_launches = phase_hfl(torch)
        phase = "lm_slice"
        lm_launches, dense, paged, batches = phase_lm(torch, LM_ARCH, phase)
        phase = "lm_profile"
        phase_lm_profile(torch, dense, paged, batches, phase)
        del dense, paged
        torch.cuda.empty_cache()
        phase = "lm_parity"
        phase_lm_parity(torch, LM_ARCH, phase, numpy_lm_params)
        phase = "moe_kernels"
        moe_rows = phase_moe_kernels(torch)
        phase = "moe_slice"
        moe_launches, dense, paged, batches = phase_lm(torch, MOE_ARCH,
                                                       phase)
        phase = "moe_profile"
        phase_lm_profile(torch, dense, paged, batches, phase)
        del dense, paged
        torch.cuda.empty_cache()
        phase = "moe_parity"
        phase_lm_parity(torch, MOE_ARCH, phase, numpy_moe_params)
        phase = "ssm_kernels"
        ssm_row, hybrid_flash_row = phase_ssm_kernels(torch)
        phase = "hybrid_slice"
        hybrid_launches, pool, batches, params, toks = phase_hybrid(torch)
        phase = "hybrid_profile"
        phase_hybrid_profile(torch, pool, batches, params, toks)
        del pool, params, toks
        torch.cuda.empty_cache()
        phase = "hybrid_parity"
        phase_hybrid_parity(torch)
    except Exception:  # report which phase failed, then fail the run
        traceback.print_exc()
        emit({"phase": phase, "ok": False})
        return 1

    # each main path's launches, counted from 0 just before it ran
    paths = {"slice": launches, "hfl_slice": hfl_launches,
             "lm_slice": lm_launches,
             "moe_slice": moe_launches, "hybrid_slice": hybrid_launches}
    total = {k: sum(p[k] for p in paths.values()) for k in launches}
    csrc = "src/repro_torch/kernels/csrc"
    emit({"phase": "launches", "by_path": paths, "total": total,
          "seconds": time.perf_counter() - t_start,
          "flash_attention_mla": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              moe_launches["flash_attention"], moe_rows["flash_attention"]),
          "flash_attention_hybrid": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              hybrid_launches["flash_attention"], hybrid_flash_row)})
    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("gru_seq", f"{csrc}/gru_seq.cu",
                     "src/repro/kernels/gru_cell.py:41",
                     total["gru_seq"], gru_rows[2]),
        kernel_entry("fedavg_reduce", f"{csrc}/fedavg_reduce.cu",
                     "src/repro/kernels/fedavg_reduce.py:26",
                     total["fedavg_reduce"], fed_rows[0]),
        *(kernel_entry(name, f"{csrc}/{name}.cu",
                       f"src/repro/kernels/{name}.py:{line}",
                       total[name], attn_rows[name])
          for name, line in (("flash_attention", 70),
                             ("decode_attention", 57),
                             ("paged_decode_attention", 89))),
        kernel_entry("paged_mla_decode_attention",
                     f"{csrc}/paged_mla_decode_attention.cu",
                     "src/repro/kernels/paged_decode_attention.py:183",
                     total["paged_mla_decode_attention"],
                     moe_rows["paged_mla_decode_attention"]),
        kernel_entry("topk_router", f"{csrc}/topk_router.cu",
                     "src/repro/kernels/topk_router.py:32",
                     total["topk_router"], moe_rows["topk_router"]),
        kernel_entry("mamba_chunk_scan", f"{csrc}/mamba_chunk_scan.cu",
                     "src/repro/kernels/mamba_scan.py:66",
                     total["mamba_chunk_scan"], ssm_row),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
