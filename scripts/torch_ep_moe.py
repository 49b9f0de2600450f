#!/usr/bin/env python3
"""Expert-parallel MoE on the card, apart from the rest of
``chip_smoke.py``: deepseek-v2-lite-16b's routed experts split over two
ranks under the reference's EXPERT_PARALLEL_RULES.

With no option, on one card: builds the kernels, holds the router, flash
and the paged MLA kernel against their plain versions at the phase's
shapes (``chip_smoke.py``'s ep_kernels), then runs its ep_moe phase (two
ranks sharing the card over gloo, each holding 32 of the 64 experts:
a forward and loss on (2, 256) tokens and two paged decode steps at full
width in bf16 against the unsharded port, every MoE layer's routed block
replayed on the same input, and the fp32 cuts: EXPERT_PARALLEL_RULES on
(data 1, model 2) and the override expert=("data",) on (data 2, model
1), whose dispatch is an all-to-all).

With ``--nccl``, on two cards or more: the same phase with one card a
rank over NCCL, the all-to-all's time beside gloo's.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line
a phase; the lines also go to ``--out``.  Exits 1 if a phase fails.

    python3 scripts/torch_ep_moe.py [--nccl] [--out results/ep_moe.jsonl]
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
        print("torch_ep_moe: no CUDA device", file=sys.stderr)
        return 1
    if args.nccl and torch.cuda.device_count() < 2:
        print("torch_ep_moe: --nccl needs two cards, found "
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
                phase = "ep_kernels"
                cs.phase_ep_kernels(torch)
                phase = "ep_moe"
                cs.phase_ep_moe(torch)
            else:
                phase = "ep_moe_nccl"
                cs.phase_ep_moe(torch, backend="nccl", devices=None,
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
