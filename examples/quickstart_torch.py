"""Quickstart on the PyTorch/CUDA port: the paper's pipeline on the GPU.

  1. describe the infrastructure (devices with inference rates, edge
     hosts with serving capacities)
  2. solve HFLOP -> inference-load-aware cluster topology
  3. train the paper's GRU (2 layers, hidden 128) continually with
     hierarchical FedAvg on traffic data: every forward runs in the
     ``gru_seq`` kernel, every aggregation in ``fedavg_reduce``
  4. serve inference requests with R1-R3 routing, compare latencies
  4b. calibrate the routing simulator from the deployment's replica pool
     (``ReplicaPool.measure()``) and compare again
  5. account communication costs vs flat FL

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu --reduced

``--device cpu`` runs the kernels' plain versions on the CPU; ``--reduced``
trains and serves the reduced GRU (hidden 32).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import flat_fl_cost, hfl_cost
from repro_torch.data.traffic import generate, select_fl_sensors
from repro_torch.fl.hierarchy import ContinualHFL, HFLRunConfig
from repro_torch.orchestration import (DeviceNode, EdgeNode, Inventory,
                                       LearningController)
from repro_torch.routing import LatencyModel, SimConfig, compare_methods
from repro_torch.serving import TierSpec

TIER_BATCH = {"device": 1, "edge": 4, "cloud": 16}


def _print_latencies(logs, label):
    for name, log in logs.items():
        print(f"latency[{name}, {label}] = {log.mean_latency():.2f} "
              f"+- {log.std_latency():.2f} ms  "
              f"(cloud fraction {log.tier_fractions()['cloud']:.2f})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced GRU (hidden 32) instead of 128")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--max-batches", type=int, default=15)
    args = ap.parse_args(argv)

    # 1. infrastructure -----------------------------------------------------
    ds = generate(num_days=30, seed=0)
    sensors = select_fl_sensors(ds, per_cluster=2, seed=0)   # 8 FL clients
    rng = np.random.default_rng(0)
    lam = rng.uniform(2.0, 6.0, len(sensors))                # req/s per device
    devices = [DeviceNode(i, lam=float(lam[i]),
                          lan_edge=int(ds.cluster_of[sensors[i]]))
               for i in range(len(sensors))]
    edges = [EdgeNode(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]

    # 2. inference-aware clustering (HFLOP, paper §IV), with one model
    #    replica per tier on the port's device ------------------------------
    tiers = [TierSpec(t, batch_size=b, reduced=args.reduced)
             for t, b in TIER_BATCH.items()]
    controller = LearningController(Inventory(devices, edges), l=2,
                                    serving_tiers=tiers, device=args.device)
    deployment = controller.deploy()
    print(deployment.topology.describe())

    # 3. continual hierarchical FL (paper §V-B) -----------------------------
    cfg = get_config("gru-traffic")
    if args.reduced:
        cfg = cfg.reduced()
    run = HFLRunConfig(rounds=args.rounds, max_batches=args.max_batches,
                       max_val_windows=128)
    hfl = ContinualHFL(cfg, ds, sensors, deployment.topology, run,
                       mode="hier", device=args.device)
    t0 = time.perf_counter()
    result = hfl.run_rounds(progress=True)
    seconds = time.perf_counter() - t0
    print(f"val MSE: round0={result.mse.mean(1)[0]:.4f} -> "
          f"round{len(result.mse) - 1}={result.mse.mean(1)[-1]:.4f}  "
          f"({seconds / args.rounds:.2f} s per round on {hfl.device})")

    # 4. inference serving with R1-R3 routing (paper §V-C) ------------------
    inst = controller.inventory.to_instance(l=2)
    assigns = {"flat": None, "hflop": deployment.topology.assign}
    logs = compare_methods(inst, assigns, SimConfig(duration_s=60, seed=0))
    _print_latencies(logs, "default")

    # 4b. the simulator calibrated from the deployment's own replicas -------
    default, calibrated = LatencyModel(), deployment.calibrated_latency()
    for t in TIER_BATCH:
        print(f"infer_ms[{t}]: default {default.infer_ms(t):.3f}, "
              f"measured {calibrated.infer_ms(t):.3f}")
    cal_logs = compare_methods(inst, assigns, SimConfig(
        duration_s=60, seed=0, latency=calibrated))
    _print_latencies(cal_logs, "calibrated")

    # 5. communication-cost accounting (paper §V-D) -------------------------
    flat = flat_fl_cost(inst.n, total_rounds=100)
    hier = hfl_cost(inst, deployment.topology.assign, total_rounds=100)
    print(f"comm volume to convergence: flat={flat.gigabytes:.2f} GB, "
          f"HFLOP={hier.gigabytes:.2f} GB "
          f"({100 * (1 - hier.metered_bytes / flat.metered_bytes):.0f}% "
          f"saved)")
    return {"topology": deployment.topology, "result": result,
            "seconds_per_round": seconds / args.rounds, "logs": logs,
            "calibrated_logs": cal_logs, "calibrated": calibrated,
            "costs": (flat, hier)}


if __name__ == "__main__":
    main()
