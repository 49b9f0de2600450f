#!/usr/bin/env python3
"""Time every cluster shape of the port's ``gru_seq`` kernel on one GPU.

For each batch B (1, 4, 16: the serving tiers) and hidden size h (32,
64, 128), at T 12, launches the cluster instance of
``src/repro_torch/kernels/csrc/gru_seq.cu`` with every cluster size S
and rows per cluster bb it takes, holds each against the plain version
(``ref.gru_seq_ref``, 2e-5), and times it, its exchange-only floor
kernel and the general instance (one block per sequence) in the same
process, as ``chip_smoke.py`` times a kernel (CUDA-graph replay between
CUDA events, inputs warm in L2).  Prints the card's ``nvidia-smi`` name
and power limit, one JSON line per shape, and per (B, h) the fastest
shape beside what ``gru_cell.cluster_shape`` picks; the lines also go to
``results/gru_seq_sweep.jsonl``.

    python3 scripts/torch_gru_seq_sweep.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 4, 16)
HIDDEN = (32, 64, 128)
T = 12
CLUSTER_SIZES = (1, 2, 4, 8)
ROWS = (1, 2, 4, 8)
TOL = 2e-5
ITERS = 200


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gru_seq sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import device_ms
    from repro_torch.kernels import build, gru_cell, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.load()
    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    log = open(os.path.join(ROOT, "results", "gru_seq_sweep.jsonl"), "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    rng = np.random.default_rng(0)
    best, failed = {}, 0
    for h in HIDDEN:
        for B in BATCHES:
            xw = torch.as_tensor(rng.normal(size=(B, T, 3 * h)),
                                 dtype=torch.float32, device="cuda")
            h0 = torch.as_tensor(rng.normal(size=(B, h)),
                                 dtype=torch.float32, device="cuda")
            w_h = torch.as_tensor(rng.normal(size=(h, 3 * h)) * 0.1,
                                  dtype=torch.float32, device="cuda")
            want = ref.gru_seq_ref(xw, h0, w_h)
            out = torch.empty_like(want)

            def general():
                build.launch("gru_seq_f32", xw.data_ptr(), h0.data_ptr(),
                             w_h.data_ptr(), out.data_ptr(), B, T, h,
                             torch.cuda.current_stream().cuda_stream)

            general()
            err = (out - want).abs().max().item()
            general_ms = device_ms(torch, general, ITERS)
            emit({"instance": "general", "B": B, "T": T, "h": h,
                  "max_abs_err": err, "ms": general_ms})
            failed += err > TOL
            rows = []
            for S in CLUSTER_SIZES:
                for bb in ROWS:
                    if bb > 1 and bb // 2 >= B:
                        continue        # a cluster would hold no row past B

                    def kernel(S=S, bb=bb):
                        build.launch("gru_seq_cluster_f32", xw.data_ptr(),
                                     h0.data_ptr(), w_h.data_ptr(),
                                     out.data_ptr(), B, T, h, S, bb,
                                     torch.cuda.current_stream().cuda_stream)

                    def floor(S=S, bb=bb):
                        build.launch("gru_seq_floor", out.data_ptr(), B, T,
                                     h, S, bb,
                                     torch.cuda.current_stream().cuda_stream)

                    out.fill_(float("nan"))
                    try:
                        kernel()
                    except RuntimeError as e:   # a shape it does not take
                        emit({"instance": "cluster", "B": B, "h": h, "S": S,
                              "bb": bb, "refused": str(e)})
                        continue
                    torch.cuda.synchronize()
                    err = (out - want).abs().max().item()
                    ok = bool(torch.allclose(out, want, atol=TOL, rtol=TOL))
                    failed += not ok
                    row = {"instance": "cluster", "B": B, "T": T, "h": h,
                           "S": S, "bb": bb, "max_abs_err": err, "ok": ok,
                           "ms": device_ms(torch, kernel, ITERS),
                           "floor_ms": device_ms(torch, floor, ITERS),
                           "general_ms": general_ms}
                    emit(row)
                    rows.append(row)
            fastest = min(rows, key=lambda r: r["ms"])
            chosen = gru_cell.cluster_shape(B, h)
            picked = [r for r in rows if (r["S"], r["bb"]) == chosen]
            best[f"B{B}_h{h}"] = {
                "fastest": [fastest["S"], fastest["bb"], fastest["ms"]],
                "rule": [*chosen, picked[0]["ms"] if picked else None],
                "general_ms": general_ms}
    emit({"summary": best, "nvidia_smi": smi, "failed": failed})
    log.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
