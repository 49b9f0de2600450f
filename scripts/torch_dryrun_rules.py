#!/usr/bin/env python3
"""The port's dry run of the MoE models under the reference's rule sets,
side by side: deepseek-v2-lite-16b and qwen2-moe-a2.7b, train_4k and
decode_32k, on the 256- and 512-rank production meshes, under
``DEFAULT_RULES`` and under ``EXPERT_PARALLEL_RULES`` (reached through
``run_combo``'s ``rules_overrides``, as in the reference), and
deepseek's decode_32k on 256 ranks under the override
``expert=("data",)``, whose dispatch is an all-to-all.  Host CPU only:
each mesh size and rule set traces in a subprocess of its own over a
fake world (``launch/dryrun.py``).

Prints one line a combo: a rank's argument bytes, the trace roofline's
compute, memory and collective seconds, and the collectives by kind;
the records go to ``--out`` as JSON lines.

    PYTHONPATH=src python scripts/torch_dryrun_rules.py \\
        [--out results/dryrun_rules.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.shardings import EXPERT_PARALLEL_RULES  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
SHAPES = ("train_4k", "decode_32k")
RULES = {"default": (),
         "expert_parallel": tuple(EXPERT_PARALLEL_RULES.items()),
         "expert_over_data": (("expert", ("data",)),)}
#: (rule set, meshes, combos)
RUNS = [(name, mesh, [(a, s) for a in ARCHS for s in SHAPES])
        for name in ("default", "expert_parallel")
        for mesh in ("single", "multi")]
RUNS.append(("expert_over_data", "single",
             [("deepseek-v2-lite-16b", "decode_32k")]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="also write the records to this file")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a subprocess may take")
    args = ap.parse_args()
    recs = []
    for name, mesh, todo in RUNS:
        for rec in dryrun.run_in_subprocess(mesh, todo, args.timeout,
                                            RULES[name]):
            rec["rules"] = name
            recs.append(rec)
            roof = rec.get("roofline", {})
            print(f"{rec['arch']:22s} {rec['shape']:10s} {rec['mesh']:7s} "
                  f"{name:16s} ok={rec.get('ok')} "
                  f"args={rec.get('memory', {}).get('argument_bytes', 0):.4g}"
                  f" compute={roof.get('compute_s', 0):.4g}s "
                  f"memory={roof.get('memory_s', 0):.4g}s "
                  f"collective={roof.get('collective_s', 0):.4g}s "
                  f"{roof.get('collective_counts')}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    failed = [r for r in recs if not r.get("ok")]
    for r in failed:
        print(f"FAILED {r['arch']} {r['shape']} {r['mesh']} {r['rules']}: "
              f"{r.get('error')}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
