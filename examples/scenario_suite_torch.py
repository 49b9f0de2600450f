"""Scenario suite walkthrough on the PyTorch/CUDA port, the steps of
``examples/scenario_suite.py``: the co-simulation as a scenario engine.

Runs the perturbation scenarios (stragglers, device mobility,
multi-tenant edges, combined churn) under three policies — static,
unconstrained reactive, and budget-capped reactive — and narrates what
the reactive loop did in each: which devices got dropped at the round
deadline, which handovers triggered re-clusters, and where the
reconfiguration budget said no.  The co-simulation is numpy on the
host (``repro_torch.sim``, a copy of the reference's); ``--device``
only names where a deployment's replicas would run.

Run:  PYTHONPATH=src python examples/scenario_suite_torch.py
      PYTHONPATH=src python examples/scenario_suite_torch.py --device cpu \\
          --duration 30
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.sim.scenarios import (SCENARIOS, default_budget_total,
                                       run_scenario)

SEED = 0


def show(res, budget=False):
    b = (f"  budget {res.budget_spent:.0f}/{res.budget_total:.0f} spent"
         f" ({res.budget_vetoes} vetoed)" if budget else "")
    print(f"    {res.policy:9s} p95 {res.p95:7.2f} ms   "
          f"rounds {res.rounds_completed}   reclusters {res.reclusters}{b}")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--duration", type=float, default=120.0)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    duration = args.duration

    budget_total = default_budget_total()        # two full migrations
    results = {}
    for name in ("straggler", "mobility", "multi_tenant", "churn"):
        scenario = SCENARIOS[name]()
        print(f"\n=== {name}: {scenario.description} ===")
        static = show(run_scenario(scenario, "static", seed=SEED,
                                   duration_s=duration))
        reactive = show(run_scenario(scenario, "reactive", seed=SEED,
                                     duration_s=duration))
        budgeted = show(run_scenario(scenario, "budgeted", seed=SEED,
                                     duration_s=duration,
                                     budget_total=budget_total),
                        budget=True)
        results[name] = (static, reactive, budgeted)
        gain = static.p95 - reactive.p95
        if gain > 0:
            frac = (static.p95 - budgeted.p95) / gain
            print(f"    -> budgeted recovers {frac:.0%} of the "
                  f"unconstrained p95 gain ({gain:.1f} ms) for "
                  f"{budgeted.budget_spent:.0f} budget units")
        print("    reactive-loop decisions (budgeted run):")
        for t, action in budgeted.actions:
            print(f"      t={t:6.1f}s  {action}")

    print("\n=== p95 timeline under churn (20 s windows, budgeted) ===")
    res = run_scenario(SCENARIOS["churn"](), "budgeted", seed=SEED,
                       duration_s=duration, budget_total=budget_total)
    for lo, p95 in res.log.windowed_percentile(20.0, 95):
        bar = "" if np.isnan(p95) else "#" * int(min(p95, 120) / 2)
        marks = [a for ta, a in res.actions if lo <= ta < lo + 20.0]
        note = f"   <- {marks[0]}" if marks else ""
        print(f"  {lo:5.0f}s  {p95:7.2f} ms  {bar}{note}")
    return results


if __name__ == "__main__":
    main()
