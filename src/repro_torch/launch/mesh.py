"""Device meshes over ``torch.distributed`` ranks, the counterpart of
``make_hfl_mesh`` and ``make_test_mesh`` in ``repro/launch/mesh.py``.

In JAX one process drives every device and a mesh is a grid of them.
Here a mesh spans processes: every rank builds the same
``DeviceMesh`` (``init_device_mesh`` with named dimensions) after its
process group is up, and each mesh dimension is a process group.
:func:`run_ranks` starts those processes on one host.

The backend is the caller's choice and is never switched behind its
back: ``nccl`` where each rank has a card of its own, ``gloo`` where
ranks share one card or run on the CPU.  A failed ``init`` raises.

The dry-run layer's part (the reference's TPU constants and
``make_production_mesh``) is here for the H100: the constants of one
NVIDIA H100 80GB HBM3 (SXM) and production meshes of the reference's
256 and 512 ranks laid out for nodes of 8 GPUs, tensor parallelism
inside a node's NVLink and FSDP across nodes.  No TPU figure is carried
over.  :func:`init_fake_world` gives a process a fake world of that
many ranks, so those meshes are built on one host without a card."""
from __future__ import annotations

import faulthandler
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.models.common import mesh_shape

BACKENDS = ("gloo", "nccl")

# ---------------------------------------------------------------------------
# H100 constants (per GPU): the roofline's denominators
# ---------------------------------------------------------------------------

#: the card the constants describe, and its power limit (nvidia-smi on
#: the card the measured ones were read from)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: dense bf16 tensor-core peak, FLOP/s (NVIDIA H100 SXM datasheet)
PEAK_FLOPS_BF16 = 989e12
#: fp32 CUDA-core peak, FLOP/s (NVIDIA H100 SXM datasheet)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bandwidth, bytes/s (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12
#: ``torch.cuda.get_device_properties(0).total_memory`` read on the card
HBM_BYTES = 85_017_493_504
#: NVLink 4 per GPU and direction, bytes/s (900 GB/s bidirectional;
#: NVIDIA H100 SXM datasheet)
NVLINK_BW = 450e9
#: InfiniBand per GPU, bytes/s: one ConnectX-7 NDR 400 Gb/s port
#: (NVIDIA ConnectX-7 datasheet)
IB_BW = 50e9
#: GPUs that share one NVLink domain (an HGX H100 node)
GPUS_PER_NODE = 8
#: ranks of one pod in the production meshes
POD_RANKS = 256


def make_hfl_mesh(device_type: str, *, n_clusters: Optional[int] = None
                  ) -> DeviceMesh:
    """HFL mesh over every rank: a leading ``cluster`` axis of
    ``n_clusters`` (default: one rank a cluster) and a ``data`` axis of
    the ranks inside each cluster."""
    world = dist.get_world_size()
    n = world if n_clusters is None else n_clusters
    if n < 1 or world % n:
        raise ValueError(f"n_clusters {n} must divide the {world} ranks")
    return init_device_mesh(device_type, (n, world // n),
                            mesh_dim_names=("cluster", "data"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The reference's 256 ranks as (data 32, model 8), or 512 as (pod 2,
    data 32, model 8).  The reference's (16, 16) puts a 16-wide
    tensor-parallel axis across two nodes, onto InfiniBand; here the
    ``model`` axis is one node's 8 GPUs, inside NVLink.  Needs a world of
    that many ranks (:func:`init_fake_world` for the dry run)."""
    shape = (2, 32, GPUS_PER_NODE) if multi_pod else (32, GPUS_PER_NODE)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_hfl_shape(*, n_clusters: int = 4, multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Shape and axis names of the production HFL mesh: (cluster,
    32 // n_clusters, 8) on one pod, (cluster 2, data 32, model 8) with
    one cluster a pod."""
    axes = ("cluster", "data", "model")
    if multi_pod:
        return (2, 32, GPUS_PER_NODE), axes
    if n_clusters < 1 or 32 % n_clusters:
        raise ValueError("n_clusters must divide 32")
    return (n_clusters, 32 // n_clusters, GPUS_PER_NODE), axes


def make_production_hfl_mesh(*, n_clusters: int = 4, multi_pod: bool = False,
                             device_type: str = "cpu") -> DeviceMesh:
    """The reference's ``make_hfl_mesh`` at production size, laid out for
    nodes of 8 GPUs (:func:`production_hfl_shape`)."""
    shape, axes = production_hfl_shape(n_clusters=n_clusters,
                                       multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def init_fake_world(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world`` ranks:
    PyTorch's ``"fake"`` backend, whose collectives return at once and
    move nothing, so DTensor programs over production meshes run (on
    fake tensors) in one process.  It is private API
    (``torch.testing._internal.distributed.fake_pg``) and may change
    between releases.  A process has one default group: a world of
    another size needs another process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a world of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) is already up; a fake world of "
                f"{world} needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def make_test_mesh(device_type: str, shape: Sequence[int] = (2, 2, 2),
                   axes: Sequence[str] = ("pod", "data", "model")
                   ) -> DeviceMesh:
    """Small mesh for tests; needs ``prod(shape)`` ranks."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


#: axis name -> size, as ``jax.sharding.Mesh.shape``
mesh_sizes = mesh_shape


_GROUPS: Dict[Tuple[Any, ...], Any] = {}


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of this rank over the mesh axes ``axes`` taken
    together (the ranks that share every other coordinate), as a JAX
    collective over a tuple of axes.  One axis is the mesh's own group;
    several are created once and cached, a collective call that every
    rank of the world makes (the mesh must span it)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    key = (tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()),
           tuple(names), axes)
    if key not in _GROUPS:
        rest = [d for d in range(len(names)) if d not in dims]
        grid = mesh.mesh.permute(rest + dims).reshape(
            -1, int(torch.tensor([mesh.mesh.shape[d] for d in dims]).prod()))
        mine, _ = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in grid])
        _GROUPS[key] = mine
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def host_staged_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors through host
    memory in this process: it takes the tensor to the CPU, gathers there
    and brings the result back.  For ranks that share one card over gloo
    (NCCL refuses two ranks on one device): the functional all-gather,
    which DTensor runs (``Shard._to_replicate_tensor`` calls
    ``funcol.all_gather_tensor`` in torch 2.11) for every redistribution
    from a split to a whole tensor, kills the process in ``wait_tensor``
    (SIGSEGV on an H100), while gloo's other collectives of CUDA tensors
    work.  Idempotent; CPU tensors pass as before."""
    import torch.distributed._functional_collectives as funcol

    gather = funcol.all_gather_tensor
    if getattr(gather, "host_staged", False):
        return

    def staged(self, *args, **kwargs):
        if not self.is_cuda:
            return gather(self, *args, **kwargs)
        out = gather(self.cpu(), *args, **kwargs)
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return out.to(self.device)

    staged.host_staged = True
    funcol.all_gather_tensor = staged


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, store_path: str, results: str,
               timeout: float, args_path: str) -> None:
    """One rank: its device and process group, then ``fn`` on the
    arguments pickled at ``args_path``; its return value goes to
    ``results/rank{rank}.pt``, a failure's traceback to
    ``rank{rank}.err`` and a nonzero exit."""
    # every rank is on this host: gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # a rank killed by a signal leaves its Python stack on stderr
    faulthandler.enable()
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if backend == "gloo":
                host_staged_all_gather()
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=timedelta(seconds=timeout),
            device_id=dev if backend == "nccl" else None)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        try:
            out = fn(rank, results, *args)
            torch.save(out, os.path.join(results, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(results, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(fn: Callable, world: int, *, backend: str,
              device: Any = None, timeout: float = 120.0,
              args: tuple = ()) -> List[Any]:
    """Run ``fn(rank, results_dir, *args)`` in ``world`` processes on this
    host, each in a process group of ``backend`` over a ``FileStore`` in a
    temporary directory (no TCP port to race for), and return their
    return values by rank: each rank writes its own to a file in
    ``results_dir``, a temporary directory that is removed afterwards.

    ``fn`` must be a module-level function: the processes are started
    in *spawn* mode (the caller may hold CUDA), so they import it.
    The arguments go to the ranks through a file in that directory: a
    process's start blocks until the child has read what it is handed
    through its pipe, which it does only after its imports, so large
    arguments handed that way would start the ranks one after another.
    ``device`` is one device for every rank (``"cuda:0"``: ranks that
    share a card; ``"cpu"``) or a sequence of one a rank; by default one
    card a rank, ``cuda:{rank}``, and it raises where CUDA is absent, as
    every entry point of the port does (``resolve_device``).  If a rank
    fails or the ranks have not all finished within ``timeout`` seconds,
    the others are killed and this raises, with the failed rank's
    traceback."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if device is None:
        devices = [str(resolve_device(f"cuda:{r}")) for r in range(world)]
    elif isinstance(device, (str, torch.device)):
        devices = [str(device)] * world
    else:
        devices = [str(d) for d in device]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = os.path.join(tmp, "results")
    os.makedirs(results)
    store_path = os.path.join(tmp, "store")
    args_path = os.path.join(tmp, "args.pkl")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, world, backend, devices[r], store_path,
                               results, timeout, args_path))
             for r in range(world)]
    try:
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                _stop(procs)
                raise RuntimeError(_failure(results, procs))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(
                    f"ranks {[r for r, p in enumerate(procs) if p.exitcode is None]}"
                    f" of {world} still running after {timeout} s")
            time.sleep(0.05)
        return [torch.load(os.path.join(results, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(results: str, procs) -> str:
    """Every stopped rank's exit code and traceback, the ranks that
    raised first (a rank whose peer died fails in its collective)."""
    lines = []
    for r, p in enumerate(procs):
        path = os.path.join(results, f"rank{r}.err")
        text = open(path).read() if os.path.exists(path) else ""
        lines.append(((not text, os.path.getmtime(path) if text else 0.0),
                      f"rank {r} exited with code {p.exitcode}\n{text}"))
    return "\n".join(t for _, t in sorted(lines))
