"""End-to-end driver on the PyTorch/CUDA port (paper use case, Fig. 6
scale), the steps of ``examples/continual_hfl_traffic.py``: continual
hierarchical FL of the traffic GRU over 20 clients / 4 edge
aggregators, with HFLOP clustering, periodic global rounds, inference
serving in the loop, and accuracy-triggered re-training via the
inference controller.  Every forward runs in ``gru_seq`` and every
aggregation in ``fedavg_reduce``.

Run:  PYTHONPATH=src python examples/continual_hfl_traffic_torch.py --rounds 20
      (--rounds 100 reproduces the paper's full Fig. 6 horizon)
      PYTHONPATH=src python examples/continual_hfl_traffic_torch.py \\
          --device cpu --reduced --rounds 2 --max-batches 2

``--device cpu`` runs the kernels' plain versions on the CPU; ``--reduced``
trains the reduced GRU (hidden 32).
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import HFLOPInstance, solve_heuristic
from repro_torch.core.topology import ClusterTopology
from repro_torch.data.traffic import generate, select_fl_sensors
from repro_torch.fl.hierarchy import ContinualHFL, HFLRunConfig
from repro_torch.routing import SimConfig, simulate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--max-batches", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced GRU (hidden 32) instead of 128")
    args = ap.parse_args(argv)

    need_days = 22 + 7 + (args.rounds * 36) // 288 + 2
    ds = generate(num_days=need_days, seed=args.seed)
    sensors = select_fl_sensors(ds, per_cluster=5, seed=args.seed)
    n, m = len(sensors), 4
    rng = np.random.default_rng(args.seed)
    lam = rng.uniform(2.0, 6.0, n)
    loc = ds.cluster_of[sensors]
    c_d = np.ones((n, m))
    c_d[np.arange(n), loc] = 0.0
    inst = HFLOPInstance(c_d, np.ones(m), lam,
                         np.full(m, lam.sum() / m * 1.3), l=2)
    sol = solve_heuristic(inst)
    topo = ClusterTopology.from_solution(inst, sol)
    print(topo.describe())

    cfg = get_config("gru-traffic")
    if args.reduced:
        cfg = cfg.reduced()
    run = HFLRunConfig(rounds=args.rounds, max_batches=args.max_batches,
                       seed=args.seed)
    hfl = ContinualHFL(cfg, ds, sensors, topo, run, mode="hier",
                       device=args.device)

    alarm_threshold = 0.30
    mses, alarms = [], 0
    for t in range(args.rounds):
        res = hfl.run_rounds(rounds=1)
        mse = float(res.mse.mean())
        mses.append(mse)
        kind = "GLOBAL" if (t + 1) % topo.l == 0 else "local"
        line = f"round {t:3d} [{kind:6s}] val MSE {mse:.5f}"
        # inference controller: serve this round's requests, watch accuracy
        log = simulate(topo, SimConfig(duration_s=10, seed=t))
        line += (f" | served {len(log.t):4d} reqs, "
                 f"p50 {np.percentile(log.latency_ms, 50):.1f} ms")
        if mse > alarm_threshold and t > 5:
            line += "  << accuracy alarm: would trigger new HFL task"
            alarms += 1
        print(line)
    return {"topology": topo, "mse": mses, "alarms": alarms,
            "device": hfl.device}


if __name__ == "__main__":
    main()
