"""Trace one reactive co-simulation run end to end on the PyTorch/CUDA
port, the steps of ``examples/trace_reactive_run.py``: drift onset ->
retraining burst -> latency recluster, with every control-plane span,
metric, and orchestration decision captured by the telemetry layer.

Runs the combined churn scenario under the budget-capped reactive
policy with a ``Telemetry`` sink attached, then dumps:

  trace_reactive.json    Chrome/Perfetto trace (open in ui.perfetto.dev:
                         rounds / epochs / aggregation windows on the
                         sim-time track, deployment swaps on tid 50,
                         drift / failure instants as markers)
  trace_reactive.jsonl   the same spans as JSONL, one record per line
  audit_reactive.jsonl   the decision audit: one record per
                         orchestration action with trigger, evidence,
                         budget charge, and outcome

and prints the audit table plus the headline registry metrics.  The
run itself is bit-identical to an uninstrumented one — telemetry never
draws RNG or schedules events.  The co-simulation and the telemetry
layer are numpy on the host (copies of the reference's); ``--device``
only names where a deployment's replicas would run.

  PYTHONPATH=src python examples/trace_reactive_run_torch.py
  PYTHONPATH=src python examples/trace_reactive_run_torch.py --out results \
      --duration 180 --device cpu
"""
import argparse
import os

from repro_torch.device import resolve_device
from repro_torch.sim.scenarios import SCENARIOS, run_scenario
from repro_torch.telemetry import Telemetry


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=".",
                    help="directory for trace/audit artifacts")
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--scenario", default="churn",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--policy", default="budgeted",
                    choices=("reactive", "budgeted"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    tel = Telemetry()
    res = run_scenario(SCENARIOS[args.scenario](), args.policy,
                       seed=args.seed, duration_s=args.duration,
                       telemetry=tel)

    trace = os.path.join(args.out, "trace_reactive.json")
    tel.write_trace(trace)
    tel.write_trace_jsonl(os.path.join(args.out, "trace_reactive.jsonl"))
    tel.audit.write_jsonl(os.path.join(args.out, "audit_reactive.jsonl"))

    print(f"=== {args.scenario} / {args.policy}: p95 {res.p95:.2f} ms, "
          f"{res.rounds_completed} rounds, {res.reclusters} reclusters, "
          f"{res.n_requests} requests ===")
    print(f"\nwrote {trace} ({len(tel.tracer.spans)} spans, "
          f"{len(tel.tracer.instants)} instants) — open in "
          f"ui.perfetto.dev")

    print("\ndecision audit (trigger -> outcome):")
    print(f"  {'t':>7s}  {'action':18s} {'trigger':24s} "
          f"{'outcome':9s} {'cost':>6s}  evidence")
    for rec in tel.audit.records:
        ev = ";".join(f"{k}={v:g}" if isinstance(v, float)
                      else f"{k}={v}" for k, v in rec.evidence.items())
        print(f"  {rec.t:7.1f}  {rec.action:18s} {rec.trigger:24s} "
              f"{rec.outcome:9s} {rec.cost:6.1f}  {ev}")
    counts = tel.audit.counts()
    print("  totals: " + "  ".join(f"{k}={v}" for k, v in counts.items()
                                   if v))

    m = tel.metrics
    print("\nregistry headline:")
    for name in ("requests.total", "training.rounds_completed",
                 "training.epochs_completed", "reconfig.swaps",
                 "reconfig.cost_spent", "alarms.latency",
                 "alarms.accuracy", "events.drift_onset"):
        print(f"  {name:28s} {m.value(name):g}")
    h = m.get("request.latency_ms")
    if h is not None:
        print(f"  request.latency_ms           p50={h.quantile(50):.2f} "
              f"p95={h.quantile(95):.2f} (n={h.count})")
    return {"result": res, "telemetry": tel, "trace": trace}


if __name__ == "__main__":
    main()
