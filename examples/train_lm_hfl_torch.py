"""Hierarchical-FL training of a real LM architecture on the PyTorch/CUDA
port: cluster-replicated parameters, a local step per cluster (no
cross-cluster reduction), and a global sync every l rounds through the
``fedavg_reduce`` kernel, optionally as int8 deltas with error feedback.
The counterpart of ``examples/train_lm_hfl.py``, with one more flag,
``--device``.

Run:  PYTHONPATH=src python examples/train_lm_hfl_torch.py --arch xlstm-125m \\
          --steps 12 --clusters 2 --global-every 2 --compress
      PYTHONPATH=src python examples/train_lm_hfl_torch.py --arch gemma3-1b --full-size
      PYTHONPATH=src python examples/train_lm_hfl_torch.py --device cpu

``--full-size`` trains the published config (gemma3-1b's attention runs
in ``flash_attention`` on the card); without it, the reduced one.
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.fl.collectives import cluster_divergence, stack_for_clusters
from repro_torch.fl.compression import (compressed_global_sync, init_ef_state,
                                        sync_bytes)
from repro_torch.models import make_model
from repro_torch.params import flatten_with_path
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import (hfl_global_round,
                                             init_hfl_opt_state,
                                             make_hfl_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--global-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="train the FULL config (slow on CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    api = make_model(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(x.numel() for _, x in flatten_with_path(params))
    print(f"{args.arch}: {n_params / 1e6:.1f}M params, "
          f"{args.clusters} clusters, global sync every "
          f"{args.global_every} rounds, compress={args.compress}")

    C = args.clusters
    stacked = stack_for_clusters(params, C)
    del params
    opt = AdamW(lr=1e-3)
    opt_state = init_hfl_opt_state(opt, stacked)
    local = make_hfl_train_step(api, cfg, opt)
    ef = init_ef_state(stacked) if args.compress else None
    streams = [TokenStream(TokenStreamConfig(
        vocab_size=max(cfg.model.vocab_size, 2), seq_len=args.seq,
        batch_size=args.batch), shard=c) for c in range(C)]

    losses = []
    for t in range(args.steps):
        batches = [s.next_batch() for s in streams]
        batch = {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                                    device=dev) for k in batches[0]}
        t0 = time.perf_counter()
        stacked, opt_state, round_losses = local(stacked, opt_state, batch)
        losses.append([float(x) for x in round_losses])
        msg = (f"round {t:3d} losses="
               f"{[round(x, 3) for x in losses[-1]]}"
               f" ({time.perf_counter() - t0:.2f}s)")
        if (t + 1) % args.global_every == 0:
            div = float(cluster_divergence(stacked))
            if args.compress:
                stacked, ef = compressed_global_sync(stacked, ef)
                payload = sync_bytes(stacked, compressed=True)
            else:
                stacked = hfl_global_round(stacked)
                payload = sync_bytes(stacked, compressed=False)
            msg += (f" [GLOBAL SYNC: divergence {div:.2e}, "
                    f"payload {payload / 1e6:.1f} MB/cluster]")
        print(msg)
    return {"stacked": stacked, "losses": losses}


if __name__ == "__main__":
    main()
