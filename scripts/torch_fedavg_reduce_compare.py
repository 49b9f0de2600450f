#!/usr/bin/env python3
"""Time the port's ``fedavg_reduce`` beside another checkout's on one GPU,
and check that the two give the same bits.

``--against DIR`` names the root of another checkout of the repo (a
parent commit unpacked by ``git archive <commit> --prefix=_parent/ | tar
-x`` into the gitignored ``_parent/``).  Its ``repro_torch`` package is
imported apart from this one's, so each side goes through its own wrapper
``fedavg_reduce(stacked, weights)`` and builds its own kernels with its
own ``build.load``: the tool works against any commit whose wrapper has
that signature.  At every ``fedavg_reduce`` shape ``chip_smoke.py`` gives
the kernel (the GRU's replicas, the HFL rounds, the ragged and
misaligned rows, the LM syncs' C 2, N 792,797,824) it runs both on the
same inputs, checks ``torch.equal``, and times them in turns (other,
this, this, other) as ``chip_smoke.py`` times a kernel (CUDA-graph replay
between CUDA events), beside an empty kernel on this kernel's grid
(``floor_ms``) and cuBLAS's ``w @ x``.  The LM shapes are timed as
graphs of 5 and of 20 calls.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line a
shape; the lines also go to ``--out``.  Exits 1 if any shape's bits
differ.

    python3 scripts/torch_fedavg_reduce_compare.py --against _parent \\
        [--out results/fedavg_reduce_compare.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from _compare import import_other

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_N, LM_N = 148_737, 792_797_824
#: (C, N, dtype, storage offset in elements): chip_smoke.py's fedavg rows
SHAPES = [(20, GRU_N, "float32", 0), (20, GRU_N, "bfloat16", 0),
          (8, GRU_N, "float32", 0), (7, GRU_N, "float32", 0),
          (5, GRU_N, "float32", 0), (4, GRU_N, "float32", 0),
          (3, GRU_N, "float32", 0), (4, 513, "float32", 0),
          (4, 513, "bfloat16", 0),
          (2, 1_048_584, "bfloat16", 0), (3, 1_048_580, "float32", 0),
          (37, 1_048_584, "bfloat16", 0), (37, 1_048_580, "float32", 0),
          (5, 1_048_584, "bfloat16", 1), (5, 1_048_580, "float32", 1),
          (2, LM_N, "bfloat16", 0), (2, LM_N, "float32", 0)]
#: calls a timed graph holds, as chip_smoke.py's kernel rows
ITERS = 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "fedavg_reduce_compare.jsonl"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fedavg_reduce compare: no CUDA device", file=sys.stderr)
        return 1
    other = import_other(args.against, ["fedavg_reduce"])["fedavg_reduce"]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import device_ms
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fedavg_reduce as fr
    assert other.fedavg_reduce is not fr.fedavg_reduce

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    log = open(args.out, "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    emit({"smi": smi, "against": args.against})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for C, N, dtype_name, offset in SHAPES:
        dtype = getattr(torch, dtype_name)
        flat = torch.randn(C * N + offset, generator=gen, device=dev,
                           dtype=dtype)
        x = flat[offset:].view(C, N)
        w = torch.rand((C,), generator=gen, device=dev) * 1.5 + 0.5
        out = fr.fedavg_reduce(x, w)
        old = other.fedavg_reduce(x, w)
        torch.cuda.synchronize()
        inst = fr.instance(C, N, dtype, x.data_ptr(), out.data_ptr())
        shape = (inst == "vector", x.element_size(), C, N, fr.sms(0))
        row = {"shape": [C, N], "dtype": dtype_name, "offset": offset,
               "instance": inst,
               "blocks": build.load().fedavg_reduce_blocks(*shape),
               "bit_equal": bool(torch.equal(out, old)),
               "max_abs_err_plain": (out.float() - ref.fedavg_reduce_ref(
                   x, w).float()).abs().max().item()}
        failed += not row["bit_equal"]
        del old

        def this():
            return fr.fedavg_reduce(x, w)

        def parent():
            return other.fedavg_reduce(x, w)

        def floor():
            build.launch("fedavg_reduce_floor", *shape,
                         torch.cuda.current_stream().cuda_stream)

        for iters in ((5, 20) if N == LM_N else (ITERS,)):
            turns = [device_ms(torch, f, iters)
                     for f in (parent, this, this, parent)]
            row[f"graph_of_{iters}"] = {
                "ms": (turns[1] + turns[2]) / 2,
                "other_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns}
        wn = (w / w.sum()).to(dtype)
        row.update(floor_ms=device_ms(torch, floor, ITERS),
                   library_ms=device_ms(torch, lambda: wn @ x,
                                        20 if N == LM_N else ITERS))
        it = x.element_size()
        row["bound_ms"] = (C * N * it + 4 * C + N * it) / 3.35e12 * 1e3
        emit(row)
        del x, flat, out
        torch.cuda.empty_cache()
    log.close()
    if failed:
        print(f"{failed} shapes differ from the other checkout",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
