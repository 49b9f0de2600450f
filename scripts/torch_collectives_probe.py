#!/usr/bin/env python3
"""Which collectives two ranks on one card can run, by backend.

Two processes share ``cuda:0`` (``run_ranks``).  First NCCL: one
``all_reduce`` of a small tensor, which NCCL is expected to refuse
(two ranks on one device); its message is printed.  Then gloo: each
collective the distributed syncs use (``all_gather`` of int8, bf16 and
fp32 rows, ``all_reduce`` SUM and MAX), on CUDA tensors and on CPU
tensors, each reported as ok with its result checked, or with the error
the backend raised.  Then the all-to-all of the expert-parallel MoE's
dispatch over gloo, each form in ranks of its own (a form that kills
its process fails only its own line): c10d's ``all_to_all_single``, the
functional ``all_to_all_single_autograd`` and
``torch.distributed.nn.functional.all_to_all_single``, forward and (the
two autograd forms) backward, on CUDA and CPU tensors.  Prints one JSON
line per backend and per all-to-all form, and the card's
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


#: the all-to-all forms the MoE dispatch could take
A2A_FORMS = ("c10d", "funcol_autograd", "nn_functional")


def a2a_rank(rank, results, form, dev):
    """One all-to-all of ``form`` on ``dev`` tensors over the world: rank
    r sends block j (rows of value 10 r + j) to rank j; the autograd
    forms also run the backward of the received rows weighted by their
    source, whose gradient each rank gets back is its own index."""
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    x = torch.cat([torch.full((2, 3), 10.0 * rank + j) for j in
                   range(world)]).to(dev).requires_grad_(form != "c10d")
    want = torch.cat([torch.full((2, 3), 10.0 * j + rank) for j in
                      range(world)])
    if form == "c10d":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
    elif form == "funcol_autograd":
        import torch.distributed._functional_collectives as funcol
        out = funcol.all_to_all_single_autograd(x, None, None, group)
        out = funcol.wait_tensor(out) if isinstance(
            out, funcol.AsyncCollectiveTensor) else out
    else:
        import torch.distributed.nn.functional as nnf
        out = nnf.all_to_all_single(torch.empty_like(x), x, group=group)
    res = {"forward": bool(torch.equal(out.detach().cpu(), want))}
    if form != "c10d":
        # weight each received block by its source: the gradient sent
        # back to each rank is then that rank's own index
        w = torch.repeat_interleave(torch.arange(world, dtype=x.dtype),
                                    2)[:, None].to(dev)
        (out * w).sum().backward()
        res["backward"] = bool(torch.equal(
            x.grad.cpu(), torch.full_like(x.grad.cpu(), float(rank))))
    if dev == "cuda":
        torch.cuda.synchronize()
    return res


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
    for form in A2A_FORMS:
        for dev in ("cuda", "cpu"):
            line = {"all_to_all": form, "device": dev, "backend": "gloo"}
            try:
                line["ranks"] = run_ranks(a2a_rank, 2, backend="gloo",
                                          device="cuda:0", timeout=120,
                                          args=(form, dev))
                line["ok"] = all(all(r.values()) for r in line["ranks"])
            except Exception as e:
                line.update(ok=False, error=f"{type(e).__name__}: {e}"[-2000:])
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
