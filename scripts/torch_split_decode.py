#!/usr/bin/env python3
"""The reference's production decode layout on the card, apart from the
rest of ``chip_smoke.py``: a decode cache split along its slots over two
ranks (``kv_seq`` over ``model``), each rank's share through the dense
decode kernel's partial instance, merged across the ranks.

With no option, on one card: builds the kernels, holds
``decode_attention_partial`` against its plain version at the split
decode's shapes, then runs ``chip_smoke.py``'s split_decode phase (two
ranks sharing the card over gloo; stablelm-1.6b and gemma3-1b at full
width, 32,768-slot caches, 4 decode steps, against the unsharded
``decode_step``; and their fp32 cuts).

With ``--nccl``, on two cards or more: one card a rank over NCCL, the
split decode and then the distributed HFL run of ``chip_smoke.py``'s
dist_slice (gemma3-1b, one FL cluster a rank, after the single-process
train_slice it is held against), with the sync and step times of each.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line
a phase; the lines also go to ``--out``.  Exits 1 if a phase fails.

    python3 scripts/torch_split_decode.py [--nccl] \\
        [--out results/split_decode.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nccl", action="store_true",
                    help="one card a rank over NCCL (needs two cards)")
    ap.add_argument("--out", default="",
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_split_decode: no CUDA device", file=sys.stderr)
        return 1
    if args.nccl and torch.cuda.device_count() < 2:
        print("torch_split_decode: --nccl needs two cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    lines = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            lines.write(text)
            return sys.__stdout__.write(text)

        def flush(self):
            sys.__stdout__.flush()

    phase = "device"
    try:
        with contextlib.redirect_stdout(Tee()):
            cs.phase_device(torch)
            phase = "build"
            cs.phase_build()
            if not args.nccl:
                phase = "split_kernels"
                cs.phase_split_kernels(torch)
                phase = "split_decode"
                cs.phase_split_decode(torch)
            else:
                phase = "split_decode_nccl"
                cs.phase_split_decode(torch, backend="nccl", devices=None,
                                      phase=phase)
                phase = "train_slice"
                losses = cs.phase_train(torch)[3]
                torch.cuda.empty_cache()
                phase = "dist_slice_nccl"
                cs.phase_dist(torch, losses, backend="nccl", devices=None,
                              phase=phase)
    except Exception:
        traceback.print_exc()
        print(f'{{"phase": "{phase}", "ok": false}}', flush=True)
        return 1
    finally:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.write(lines.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
