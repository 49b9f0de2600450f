"""Serving driver of the port: the continuous-batching scheduler over a
Poisson inference workload, the paper's inference path on the GPU.
Counterpart of ``repro/launch/serve.py``, with its flags and one more,
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --requests 32 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Like the reference, it serves the arch's reduced config (random weights
from seed 0) from one dense engine of ``--slots`` slots, and its default
arch is ``xlstm-125m``.  ``--device cpu`` runs the kernels' plain
versions on the CPU; the default is the card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import make_model
from repro_torch.routing import LatencyModel
from repro_torch.serving import (ContinuousBatchingScheduler, ServeEngine,
                                 poisson_requests, requests_from_events)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous-batching slots (concurrency cap)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    api = make_model(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(cfg, params, batch_size=args.slots, max_len=256,
                         device=dev)

    lam = np.full(args.slots, args.rate / args.slots)
    events = poisson_requests(lam, duration_s=args.requests / args.rate,
                              seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, max(cfg.model.vocab_size, 2),
                           (len(events), args.prompt_len))
    reqs = requests_from_events(events, prompts,
                                max_new_tokens=args.decode_steps)
    print(f"{len(events)} requests over {args.requests / args.rate:.1f}s "
          f"({args.slots} slots, {dev})")

    # warm the kernels and allocator so TTFT reflects serving, not set-up
    meas = engine.measure(prompt_len=args.prompt_len,
                          decode_steps=args.decode_steps)
    print(f"engine: prefill {meas.prefill_ms:.1f}ms, "
          f"decode {meas.decode_ms_per_token:.2f}ms/token "
          f"@ {meas.batch_size} slots")

    sched = ContinuousBatchingScheduler(engine)
    stats = sched.run(reqs)
    print(f"served {len(sched.completed)} requests: {stats.summary()}")

    lat = LatencyModel.from_measurements(
        {"edge": meas}, decode_tokens=args.decode_steps)
    print(f"calibrated edge service time: "
          f"{lat.infer_ms('edge'):.2f}ms/request "
          f"(x{lat.infer_ms('edge', occupancy=2 * args.slots) / max(lat.infer_ms('edge'), 1e-9):.1f} "
          f"at 2x oversubscription)")
    return {"requests": len(events), "completed": len(sched.completed),
            "stats": stats, "measurement": meas, "latency": lat}


if __name__ == "__main__":
    main()
