"""The closed reactive loop, end to end, on the PyTorch/CUDA port (paper
§III + co-sim subsystem), the steps of
``examples/reactive_orchestration.py``:

  1. train the paper's GRU with continual HFL on synthetic traffic data,
     on the card: every forward in ``gru_seq``, every aggregation in
     ``fedavg_reduce``
  2. inject concept drift (``data.traffic.inject_drift``) — the trained
     model's validation MSE rises on the drifted regime
  3. co-simulate serving + training on one event timeline: the drift
     fires the accuracy alarm, the controller launches a retraining
     burst, the burst's compute steals serving capacity (interference
     spike), the latency monitor catches the spike, and HFLOP
     re-clustering recovers most of it

Run:  PYTHONPATH=src python examples/reactive_orchestration_torch.py
      PYTHONPATH=src python examples/reactive_orchestration_torch.py \\
          --device cpu --duration 120

``--device cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import ClusterTopology
from repro_torch.data import generate, inject_drift, select_fl_sensors
from repro_torch.data.traffic import STEPS_PER_DAY, windows_for_sensor
from repro_torch.fl import ContinualHFL, HFLRunConfig
from repro_torch.fl.client import ClientBatch, eval_clients
from repro_torch.orchestration import Inventory, LearningController
from repro_torch.orchestration.controller import Deployment
from repro_torch.sim import (AccuracyModel, CoSim, CoSimConfig, ReactiveLoop,
                             ReactivePolicy)


def trained_mse_before_after_drift(seed=0, device=None):
    """Train briefly pre-drift, then measure val MSE on clean vs
    drifted data — the real numbers that parameterize the co-sim's
    accuracy telemetry."""
    cfg = get_config("gru-traffic").reduced()
    ds = generate(num_days=40, n_sensors=32, seed=seed)
    sensors = select_fl_sensors(ds, per_cluster=3, seed=seed)
    n = len(sensors)
    topo = ClusterTopology(assign=np.arange(n) % 4, n_devices=n, n_edges=4,
                           lam=np.ones(n), r=np.full(4, 10.0), l=2)
    run = HFLRunConfig(rounds=2, local_epochs=2, max_batches=10,
                       train_days=14, val_days=3, seed=seed)
    hfl = ContinualHFL(cfg, ds, sensors, topo, run, mode="hier",
                       device=device)
    res = hfl.run_rounds(progress=False)
    base_mse = float(res.mse[-1].mean())

    # drift sets in right at the validation window
    drift_start = 14 * STEPS_PER_DAY
    drifted = inject_drift(ds, drift_start, severity=0.35)
    Xs, ys = [], []
    for s in sensors:
        X, y = windows_for_sensor(drifted, int(s), drift_start,
                                  drift_start + 3 * STEPS_PER_DAY,
                                  run.history)
        Xs.append(X[:256])
        ys.append(y[:256])
    val = ClientBatch(X=torch.as_tensor(np.stack(Xs), device=hfl.device),
                      y=torch.as_tensor(np.stack(ys), device=hfl.device))
    drift_mse = float(eval_clients(hfl.params, val, cfg=cfg).mean())
    return base_mse, drift_mse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--duration", type=float, default=300.0,
                    help="co-simulated seconds (the drift fires at 60)")
    args = ap.parse_args(argv)

    print("=== 1. continual HFL training + drift impact on accuracy ===")
    base_mse, drift_mse = trained_mse_before_after_drift(device=args.device)
    print(f"val MSE clean {base_mse:.4f} -> drifted {drift_mse:.4f} "
          f"({drift_mse / base_mse:.1f}x)")

    print("\n=== 2. co-simulation: drift -> alarm -> burst -> recovery ===")
    rng = np.random.default_rng(0)
    n, m = 20, 4
    loc = np.repeat(np.arange(m), n // m)
    lam = rng.uniform(2.0, 4.0, n)
    lam[loc == 0] *= 3.0                     # hot zone
    r = np.full(m, lam.sum() / m * 1.35)
    topo = ClusterTopology(assign=loc, n_devices=n, n_edges=m,
                           lam=lam, r=r, l=2)

    ctl = LearningController(
        inventory=Inventory.from_arrays(lam, r, lan_edge=loc), l=2,
        accuracy_threshold=(base_mse + drift_mse) / 2)
    ctl.deployment = Deployment.from_topology(topo)  # static initial deploy
    loop = ReactiveLoop(
        ctl,
        accuracy=AccuracyModel(base_mse=base_mse, drift_mse=drift_mse,
                               ramp_s=40.0, recovery_per_round=0.5),
        policy=ReactivePolicy(p95_threshold_ms=20.0, burst_rounds=6))

    cfg = CoSimConfig(duration_s=args.duration, seed=0)
    cosim = CoSim(topo, cfg, reactive=loop)   # no background training
    cosim.schedule_drift(t=60.0)
    res = cosim.run()

    print(f"requests served: {len(res.log.t)}, "
          f"training rounds completed: {res.rounds_completed}, "
          f"reclusterings: {ctl.recluster_count}")
    print("\nreactive-loop decisions:")
    for t, action in res.actions:
        print(f"  t={t:6.1f}s  {action}")

    print("\np95 latency timeline (20 s windows):")
    for t0, p95 in res.log.windowed_percentile(20.0, 95):
        bar = "" if np.isnan(p95) else "#" * int(min(p95, 120) / 2)
        print(f"  {t0:5.0f}s  {p95:7.2f} ms  {bar}")

    print("\nmodeled val MSE timeline (every 30 s):")
    for t, mse in res.mse_series[::15]:
        print(f"  {t:5.0f}s  {mse:.4f}"
              + ("  <- above alarm threshold"
                 if mse > ctl.accuracy_threshold else ""))

    pre = res.log.latency_ms[res.log.t < 60.0]
    win = res.log.windowed_percentile(20.0, 95)
    filled = win[~np.isnan(win[:, 1])]           # empty windows are NaN rows
    print(f"\npre-drift p95 {np.percentile(pre, 95):.2f} ms; "
          f"peak window p95 {filled[:, 1].max():.2f} ms; "
          f"final window p95 {filled[-1, 1]:.2f} ms")
    return {"base_mse": base_mse, "drift_mse": drift_mse, "result": res,
            "reclusters": ctl.recluster_count}


if __name__ == "__main__":
    main()
