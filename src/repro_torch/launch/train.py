"""HFL training driver of the port: config -> model -> token pipeline ->
(hierarchical) train step -> aggregation schedule -> checkpoint.
Counterpart of ``repro/launch/train.py``, with its flags and one more,
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 20 --mode hfl --clusters 2 --global-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

As in the reference, ``--reduced`` is a ``store_true`` flag that defaults
to True, so the driver always trains the arch's reduced config (random
weights from seed 0, AdamW at lr 1e-3); ``examples/train_lm_hfl_torch.py
--full-size`` trains at full width.  The default device is the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.fl.collectives import (cluster_divergence, cluster_slice,
                                        stack_for_clusters)
from repro_torch.models import make_model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import (hfl_global_round,
                                             init_hfl_opt_state,
                                             make_hfl_train_step,
                                             make_train_step)


def make_batch(stream, cfg, batch_size, seq_len, clusters=0, device=None):
    """One batch a cluster (stacked) or one batch; the vlm and audio
    families get stub patch or frame embeddings, the same every call
    (``default_rng(0)``), in bf16."""
    m = cfg.model
    n = max(clusters, 1)
    batches = [stream.next_batch() for _ in range(n)]
    out = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    if clusters == 0:
        out = {k: v[0] for k, v in out.items()}
    extra = {}
    rng = np.random.default_rng(0)
    if m.family == "vlm":
        P = m.frontend.num_positions
        shape = ((clusters,) if clusters else ()) + (batch_size, P, m.d_model)
        extra["patches"] = (rng.normal(size=shape) * 0.02).astype(np.float32)
    if m.family == "audio":
        F = m.frontend.num_positions
        shape = ((clusters,) if clusters else ()) + (batch_size, F, m.d_model)
        extra["frames"] = (rng.normal(size=shape) * 0.02).astype(np.float32)
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in out.items()}
    batch.update({k: torch.as_tensor(v, device=dev).to(torch.bfloat16)
                  for k, v in extra.items()})
    return batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", choices=("flat", "hfl"), default="hfl")
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--global-every", type=int, default=2,
                    help="the paper's l: local rounds per global round")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = full.reduced() if args.reduced else full
    api = make_model(cfg)
    m = cfg.model
    print(f"arch={args.arch} (reduced={args.reduced}) params...")
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    opt = AdamW(lr=1e-3, state_dtype=cfg.run.opt_state_dtype)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=max(m.vocab_size, 2), seq_len=args.seq,
        batch_size=args.batch))
    losses = []

    if args.mode == "flat":
        step = make_train_step(api, cfg, opt)
        opt_state = opt.init(params)
        for t in range(args.steps):
            batch = make_batch(stream, cfg, args.batch, args.seq, device=dev)
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            loss = float(loss)
            losses.append([loss])
            print(f"step {t:3d} loss={loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)")
    else:
        C = args.clusters
        stacked = stack_for_clusters(params, C)
        opt_state = init_hfl_opt_state(opt, stacked)
        local = make_hfl_train_step(api, cfg, opt)
        for t in range(args.steps):
            batch = make_batch(stream, cfg, args.batch, args.seq, clusters=C,
                               device=dev)
            t0 = time.perf_counter()
            stacked, opt_state, round_losses = local(stacked, opt_state,
                                                     batch)
            losses.append([float(x) for x in round_losses])
            line = (f"round {t:3d} losses="
                    f"{[round(x, 4) for x in losses[-1]]} "
                    f"({time.perf_counter() - t0:.2f}s)")
            if (t + 1) % args.global_every == 0:
                div = float(cluster_divergence(stacked))
                stacked = hfl_global_round(stacked)
                line += f"  [GLOBAL SYNC, divergence was {div:.2e}]"
            print(line)
        params = cluster_slice(stacked, 0)

    if args.checkpoint:
        save_pytree(args.checkpoint, params)
        print(f"checkpoint -> {args.checkpoint}")
    return {"params": params, "losses": losses}


if __name__ == "__main__":
    main()
