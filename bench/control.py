"""Reads a cell's check on the chip for its control and its faults: for
each seed, one run of the cell as ``run.py`` makes it (set-up, the
window, the check), then the reference in float8 (e4m3) in the
program's place on the same inputs; with ``--faults`` (training cells)
also each planted fault's readings, from the same weights and batches.
Prints one JSON line a seed: the program's numbers, the control's, the
faults'.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds 1 2 3 [--faults]

The limits of ``bench/limits/<cell>.json`` lie between the largest
program reading over a dozen seeds or more and the smallest reading of
the control or a fault that fails the number.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

READ_ON_CHIP = ("unchanged_state", "half_batch", "no_exchange")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from run import DRIVERS
    from benchkit import faults, spec
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    kind = cell.traffic["kind"]
    driver = importlib.import_module(DRIVERS[kind])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = driver.run(cell, seed, args.seconds, False, "cuda", t0,
                         control="fp8")
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "control": out["control"],
                "limits": {k: v["limit"] for k, v in out["checks"].items()},
                "correct": out["correct"], "setup_s": out["run"].setup_s}
        if "widest_gap" in out:
            line["program"]["widest_gap"] = out["widest_gap"]
        if args.faults and kind == "hfl-train":
            want = out["readings"]["reference"]
            line["faults"] = {}
            for name in READ_ON_CHIP:
                with faults.planted(faults.TRAINING[name]):
                    got = driver.fault_readings(cell, seed, "cuda")
                line["faults"][name] = driver.compare(got, want)
                torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
