"""Tiered serving end to end on the PyTorch/CUDA port: the serving <->
simulation loop closed, the three steps of ``examples/tiered_serving.py``.

  1. cluster + deploy with a tiered replica pool (the paper's
     "replication for free": device / edge / cloud each keep a model copy)
  2. serve real traffic through the continuous-batching scheduler on the
     edge replica of an LM tier layout of xlstm-125m (reduced), as the
     reference does: prompts fed token by token through the decode step,
     slot reuse, TTFT/TPOT accounting
  3. measure the engines and run the routing simulator in CALIBRATED mode
     (per-tier service times from step 2's hardware, not the closed-form
     constant) and compare with the constant paper model

Run:  PYTHONPATH=src python examples/tiered_serving_torch.py
      PYTHONPATH=src python examples/tiered_serving_torch.py --device cpu

``--device cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse

import numpy as np

from repro_torch.orchestration import (DeviceNode, EdgeNode, Inventory,
                                       LearningController)
from repro_torch.routing import SimConfig, compare_methods
from repro_torch.serving import (DEFAULT_TIERS, ContinuousBatchingScheduler,
                                 ReplicaPool, lm_tiers, poisson_requests,
                                 requests_from_events)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # 1. infrastructure + deployment with serving tiers --------------------
    rng = np.random.default_rng(0)
    lam = rng.uniform(2.0, 6.0, 8)
    devices = [DeviceNode(i, lam=float(lam[i]), lan_edge=i % 4)
               for i in range(8)]
    edges = [EdgeNode(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]
    controller = LearningController(Inventory(devices, edges), l=2,
                                    serving_tiers=DEFAULT_TIERS,
                                    device=args.device)
    deployment = controller.deploy()
    pool = deployment.replica_pool
    print("deployed services:",
          [s for s in deployment.inference_services
           if s.startswith("replica")])

    # 2. real traffic through the edge replica's scheduler -----------------
    # (the paper's GRU serves one window per request; an LM tier shows the
    # continuous-batching path)
    lm_pool = ReplicaPool(lm_tiers("xlstm-125m"), device=args.device)
    engine = lm_pool.engine("edge")
    engine.measure(prompt_len=16, decode_steps=4)          # warm-up
    events = poisson_requests(lam, duration_s=1.0, seed=0)
    prompts = rng.integers(0, engine.cfg.model.vocab_size,
                           (len(events), 16))
    stats = ContinuousBatchingScheduler(engine).run(
        requests_from_events(events, prompts, max_new_tokens=8))
    print(f"edge replica served {len(events)} requests: {stats.summary()}")

    # 3. calibrated routing simulation --------------------------------------
    lat = deployment.calibrated_latency()     # GRU pool: one forward/request
    inst = controller.inventory.to_instance(l=2)
    logs = {}
    for name, cfg in (("constant", SimConfig(duration_s=60, seed=0)),
                      ("calibrated", SimConfig(duration_s=60, seed=0,
                                               latency=lat))):
        logs[name] = compare_methods(
            inst, {"flat": None, "hflop": deployment.topology.assign}, cfg)
        line = "  ".join(f"{k}={v.mean_latency():.2f}ms"
                         for k, v in logs[name].items())
        print(f"simulator[{name:10s}]: {line}")
    print("per-tier calibrated service times:",
          {t: f"{lat.infer_ms(t):.3f}ms" for t in pool.tiers})
    return {"stats": stats, "requests": len(events), "logs": logs,
            "latency": lat}


if __name__ == "__main__":
    main()
