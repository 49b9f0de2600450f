#!/usr/bin/env python3
"""gemma3-1b's loss and gradients as DTensors across four ranks, each on
its own device, against the unsharded loss on the same device.

Four processes (``run_ranks``) build a (data 2, model 2) mesh and lay
out gemma3-1b's parameters by their logical axes under the production
rules (``DEFAULT_RULES``: embed over data, heads / mlp / vocab over
model); train_slice's batch (4 x 64 tokens of TokenStream shard 0) is
split over data.  Each rank takes the loss and its gradients through
the DTensor path (the attention through ``local_map`` into
``flash_attention`` on a card) and the same with the unsharded tree,
and reports both losses, both gradients' global norms, its kernel
launches over the sharded pass and the wall time of each pass.  On
four cards the backend is NCCL (one card a rank); on the CPU, gloo at
the reduced config.  Prints one JSON line a rank, then the cards'
``nvidia-smi`` name and power limit.

    python3 scripts/torch_sharded_loss_probe.py                 # 4 cards
    python3 scripts/torch_sharded_loss_probe.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402

ARCH = "gemma3-1b"
BATCH, SEQ, SEED = 4, 64, 0


def _norm(grads) -> float:
    from torch.distributed.tensor import DTensor

    from repro_torch.params import flatten_with_path
    sq = sum((g.float() ** 2).sum() for _, g in flatten_with_path(grads))
    return float((sq.full_tensor() if isinstance(sq, DTensor) else sq)
                 ) ** 0.5


def sharded_rank(rank, results, device, reduced):
    """One rank: the sharded and the unsharded loss and gradients."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as sh
    from repro_torch.models import make_model
    from repro_torch.models.common import logical_sharding
    from repro_torch.training.train_step import value_and_grad

    dev = torch.device(device)
    cfg = get_config(ARCH)
    if reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype="float32", param_dtype="float32"))
    api = make_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, axes = api.init_params(gen, dev, with_axes=True)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.model.vocab_size, seq_len=SEQ, batch_size=BATCH),
        shard=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.next_batch().items()}
    mesh = make_test_mesh(dev.type, (2, 2), ("data", "model"))
    rules = sh.DEFAULT_RULES
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    dbatch = sh.distribute_tree(batch, mesh,
                                sh.batch_shardings(batch, mesh, rules))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def sharded():
        with logical_sharding(mesh, rules), implicit_replication():
            return value_and_grad(api.loss, dparams, dbatch)

    sharded()                       # DTensor's propagation warms up
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    loss, grads = sharded()
    sync()
    sharded_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    t0 = time.perf_counter()
    plain, plain_grads = value_and_grad(api.loss, params, batch)
    sync()
    plain_s = time.perf_counter() - t0
    wq = dparams["layers"]["attn"]["wq"]
    return {"rank": rank, "device": str(dev), "loss": float(
        loss.full_tensor()), "plain_loss": float(plain),
        "grad_norm": _norm(grads), "plain_grad_norm": _norm(plain_grads),
        "launches": launches, "sharded_s": sharded_s, "plain_s": plain_s,
        "wq_local": list(wq.to_local().shape),
        "wq_placements": [str(p) for p in wq.placements]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and torch.cuda.device_count() < 4:
        print("needs four cards", file=sys.stderr)
        return 1
    devices = [f"cuda:{i}" for i in range(4)] if cuda else ["cpu"] * 4
    ranks = run_ranks(sharded_rank, 4, backend="nccl" if cuda else "gloo",
                      device=devices, timeout=900,
                      args=(devices[0] if not cuda else "cuda",
                            args.reduced))
    ok = True
    for r in ranks:
        r["loss_gap"] = abs(r["loss"] - r["plain_loss"])
        r["grad_norm_rel_gap"] = abs(r["grad_norm"] - r["plain_grad_norm"]
                                     ) / r["plain_grad_norm"]
        ok &= bool(np.isfinite(r["loss"]))
        print(json.dumps(r), flush=True)
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
