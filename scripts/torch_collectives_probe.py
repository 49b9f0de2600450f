#!/usr/bin/env python3
"""Which collectives two ranks on one card can run, by backend.

Two processes share ``cuda:0`` (``run_ranks``).  First NCCL: one
``all_reduce`` of a small tensor, which NCCL is expected to refuse
(two ranks on one device); its message is printed.  Then gloo: each
collective the distributed syncs use (``all_gather`` of int8, bf16 and
fp32 rows, ``all_reduce`` SUM and MAX), on CUDA tensors and on CPU
tensors, each reported as ok with its result checked, or with the error
the backend raised.  Prints one JSON line per backend, and the card's
``nvidia-smi`` name and power limit.

    python3 scripts/torch_collectives_probe.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import make_hfl_mesh, run_ranks  # noqa: E402


def nccl_rank(rank, results):
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return {"result": x.tolist()}


def gloo_rank(rank, results):
    out = {"device": str(torch.cuda.current_device())}
    mesh = make_hfl_mesh("cuda")
    out["mesh"] = str(mesh)
    group = mesh.get_group("cluster")
    world = dist.get_world_size(group)
    for dev in ("cuda", "cpu"):
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            key = f"all_gather_{str(dtype).split('.')[-1]}_{dev}"
            try:
                x = torch.full((1, 1 << 20), rank + 1, dtype=dtype,
                               device=dev)
                mat = torch.empty((world, 1 << 20), dtype=dtype, device=dev)
                dist.all_gather(list(mat.unbind(0)), x[0], group=group)
                ok = all(bool((mat[r] == r + 1).all()) for r in range(world))
                out[key] = "ok" if ok else "wrong result"
            except Exception as e:  # the finding is the message
                out[key] = f"{type(e).__name__}: {e}"[:300]
        for op in ("SUM", "MAX"):
            key = f"all_reduce_{op}_{dev}"
            try:
                x = torch.full((3,), float(rank + 1), device=dev)
                dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
                want = 3.0 if op == "SUM" else 2.0
                out[key] = "ok" if bool((x == want).all()) else \
                    f"wrong result {x.tolist()}"
            except Exception as e:
                out[key] = f"{type(e).__name__}: {e}"[:300]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "devices": torch.cuda.device_count(),
                      "nccl": dist.is_nccl_available()}), flush=True)
    try:
        res = run_ranks(nccl_rank, 2, backend="nccl", device="cuda:0",
                        timeout=60)
        print(json.dumps({"backend": "nccl", "ok": True, "ranks": res}),
              flush=True)
    except Exception as e:
        print(json.dumps({"backend": "nccl", "ok": False,
                          "error": f"{type(e).__name__}: {e}"[-3000:]}),
              flush=True)
    res = run_ranks(gloo_rank, 2, backend="gloo", device="cuda:0",
                    timeout=120)
    print(json.dumps({"backend": "gloo", "ok": True, "ranks": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
