"""Runs one cell of the port's benchmark and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for.  Set-up (kernel library, weights from the seed, engine, warm-up) is
timed as ``setup_s`` from the process's start; then the window runs for
``--seconds``; then the check.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRIVERS = {"serve-closed": "benchkit.cell_serve",
           "hfl-train": "benchkit.cell_train"}


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one (compared
    whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(torch, peak: int, summary) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from benchkit import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(DRIVERS[cell.traffic["kind"]])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_PROCESS)
    run = out["run"]
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": _device_info(torch, out["memory_peak_bytes"],
                                     run.summary if args.trace else None)}
    if args.trace and run.summary is not None:
        result["breakdown"] = run.summary.breakdown()
    result["checks"] = out["checks"]
    print(f"card: {_power_limit()}", file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for key in ("tokens_checked", "widest_gap"):
        if key in out:
            print(f"{key} (not compared): {out[key]}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
