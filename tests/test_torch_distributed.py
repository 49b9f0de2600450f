"""The port's distributed HFL layer (``repro_torch.fl.collectives`` and
``repro_torch.fl.compression`` over a ``DeviceMesh`` of
``repro_torch.launch.mesh``) against the JAX package's ``shard_map``
functions, on the CPU.

The port's side runs as gloo processes started by ``run_ranks`` (spawn,
a ``FileStore``, a timeout): one spawn of 2 ranks on a (cluster 2) mesh,
one of 4 ranks on a (cluster 2, data 2) and a (pod 2, data 2) mesh.  The
reference runs once in a subprocess with 8 host devices on a (2, 2, 2)
mesh, reading only whole arrays.  Both take the same numpy inputs.

- ``global_sync_shardmap`` on a bf16 + fp32 tree;
- ``compressed_global_sync_shardmap`` and ``compressed_global_sync_manual``
  over 2 rounds with their error-feedback state; the manual variant's
  shards are the matching pieces of the ``shard_map`` variant's result;
- ``make_hfl_local_step_shardmap`` with the reference test's
  least-squares step: each cluster's loss and parameters;
- ``hierarchical_allreduce`` with and without the global step, and
  ``flat_allreduce``.

Against JAX: fp32 3e-5, bf16 3e-2 (``tests/test_kernels.py``).  Against
the port's single-device ``global_sync`` / ``compressed_global_sync``
over the stacked clusters: bit for bit, and every rank's replica equal.
``collective_bytes``: nothing for the local step, the leaves' bytes for
the plain sync, 1 byte a parameter and 4 a leaf for the int8 one.  A
rank that raises, or hangs, makes ``run_ranks`` raise within its
timeout."""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.fl import collectives, compression  # noqa: E402
from repro_torch.launch.mesh import (make_hfl_mesh,  # noqa: E402
                                     make_test_mesh, mesh_sizes, run_ranks)
from repro_torch.params import flatten_with_path, unflatten  # noqa: E402

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
C = 2
ROUNDS = 2
TIMEOUT = 120
#: leaf -> (shape without the cluster dim, dtype); every first dim even,
#: so the manual variant cuts it over a data axis of 2
LEAVES = {("embed", "table"): ((10, 4), "bfloat16"),
          ("gate",): ((8,), "float32"),
          ("layers", "router"): ((6, 3), "float32"),
          ("layers", "w"): ((4, 6), "bfloat16")}


def _bf16(x):
    """Round fp32 values to bf16's (carried as fp32 in the npz)."""
    return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16
                                                      ).float().numpy()


def make_inputs(seed=0):
    """Every input as fp32 numpy; bf16 leaves hold bf16 values."""
    r = np.random.default_rng(seed)
    inp = {}
    for path, (shape, dtype) in LEAVES.items():
        name = "/".join(path)
        base = r.normal(size=shape).astype(np.float32)
        inp[f"start/{name}"] = np.repeat(base[None], C, axis=0)
        # cluster replicas that drifted apart (the plain sync's input)
        inp[f"diverged/{name}"] = (inp[f"start/{name}"] + 0.1 * r.normal(
            size=(C,) + shape)).astype(np.float32)
        for t in range(ROUNDS):
            inp[f"drift{t}/{name}"] = (0.05 * r.normal(size=(C,) + shape)
                                       ).astype(np.float32)
        if dtype == "bfloat16":
            for k in ("start", "diverged"):
                inp[f"{k}/{name}"] = _bf16(inp[f"{k}/{name}"])
    inp["ls/x"] = r.normal(size=(C, 8, 4)).astype(np.float32)
    inp["ls/y"] = r.normal(size=(C, 8)).astype(np.float32)
    inp["allreduce/x"] = r.normal(size=(8, 3)).astype(np.float32)
    return inp


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.fl.collectives import (flat_allreduce, global_sync_shardmap,
                                      hierarchical_allreduce,
                                      make_hfl_local_step_shardmap)
    from repro.fl.compression import (compressed_global_sync_manual,
                                      compressed_global_sync_shardmap,
                                      init_ef_state)
    inp = dict(np.load(sys.argv[1]))
    dtypes = dict(a.split("=") for a in sys.argv[3].split(","))
    rounds = int(sys.argv[4])
    mesh = jax.make_mesh((2, 2, 2), ("cluster", "data", "model"))
    sh = NamedSharding(mesh, P("cluster"))
    out = {}

    def tree(prefix, spec=P("cluster")):
        t = {}
        for name, dt in dtypes.items():
            node, keys = t, name.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            x = jnp.asarray(inp[prefix + "/" + name]).astype(dt)
            node[keys[-1]] = jax.device_put(x, NamedSharding(mesh, spec))
        return t

    def save(prefix, t):
        for path, x in jax.tree_util.tree_flatten_with_path(t)[0]:
            name = "/".join(k.key for k in path)
            out[prefix + "/" + name] = np.asarray(x.astype(jnp.float32))

    save("plain", jax.jit(lambda q: global_sync_shardmap(q, mesh))(
        tree("diverged")))

    def drifted(p, t):
        d = tree(f"drift{t}")
        return jax.tree.map(lambda x, e: (x.astype(jnp.float32) + e
                                          ).astype(x.dtype), p, d)

    for kind, spec in (("int8", P("cluster")),
                       ("manual", P("cluster", "data"))):
        p = tree("start", spec)
        ef = init_ef_state(p)
        for t in range(rounds):
            p = drifted(p, t)
            if kind == "int8":
                p, ef = jax.jit(lambda q, e: compressed_global_sync_shardmap(
                    q, e, mesh))(p, ef)
            else:
                specs = [spec] * len(dtypes)
                p, ef = jax.jit(lambda q, e: compressed_global_sync_manual(
                    q, e, mesh, specs))(p, ef)
            save(f"{kind}{t}/params", p)
            save(f"{kind}{t}/anchor", ef.anchor)
            save(f"{kind}{t}/residual", ef.residual)

    def base(p, o, b):
        loss, g = jax.value_and_grad(
            lambda w: jnp.mean((b["x"] @ w - b["y"]) ** 2))(p["w"])
        return {"w": p["w"] - 0.1 * g}, o, loss

    stepped = make_hfl_local_step_shardmap(base, mesh)
    p = {"w": jax.device_put(jnp.ones((2, 4)), sh)}
    o = jax.device_put(jnp.zeros((2,)), sh)
    b = {"x": jax.device_put(jnp.asarray(inp["ls/x"]), sh),
         "y": jax.device_put(jnp.asarray(inp["ls/y"]), sh)}
    p2, _, losses = jax.jit(stepped)(p, o, b)
    out["local/w"] = np.asarray(p2["w"])
    out["local/loss"] = np.asarray(losses)

    pmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = jnp.asarray(inp["allreduce/x"])
    xs = jax.device_put(x, NamedSharding(pmesh, P(("data",))))
    out["hier/local"] = np.asarray(hierarchical_allreduce(
        xs, pmesh, do_global=False))
    out["hier/global"] = np.asarray(hierarchical_allreduce(
        xs, pmesh, do_global=True))
    out["flat"] = np.asarray(flat_allreduce(jax.device_put(
        x, NamedSharding(pmesh, P(("pod", "data")))), pmesh))
    np.savez(sys.argv[2], **out)
    print("JAX_REF_OK")
""")


# ---------------------------------------------------------------------------
# the port's ranks (module level: spawned processes import them)
# ---------------------------------------------------------------------------

def local_block(x, mesh, axes):
    """The dim-0 block of ``x`` this rank holds when dim 0 is sharded
    over ``axes`` (major to minor), as a ``shard_map`` in_spec ``P(axes)``
    places it."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, idx = 1, 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    step = x.shape[0] // n
    return x[idx * step:(idx + 1) * step]


def _tree(inp, prefix, rows=slice(None), cut=None):
    """Nested-dict tree of ``prefix``'s leaves, cluster rows ``rows``;
    ``cut`` (index, parts) keeps that block of each leaf's first dim."""
    paths, leaves = [], []
    for path, (_, dtype) in LEAVES.items():
        x = torch.as_tensor(inp[prefix + "/" + "/".join(path)])[rows]
        if cut is not None:
            i, n = cut
            step = x.shape[1] // n
            x = x[:, i * step:(i + 1) * step]
        paths.append(path)
        leaves.append(x.to(getattr(torch, dtype)).contiguous())
    return unflatten(paths, leaves)


def _drifted(tree, drift):
    d = dict(flatten_with_path(drift))
    return unflatten([p for p, _ in flatten_with_path(tree)],
                     [(x.float() + d[p].float()).to(x.dtype)
                      for p, x in flatten_with_path(tree)])


def _numpy(tree):
    return {"/".join(map(str, p)): x.float().numpy()
            for p, x in flatten_with_path(tree)}


def _int8_rounds(inp, sync, mesh, rows, cut=None):
    """``ROUNDS`` int8 syncs from the equal start replicas, each after
    its drift; the params, anchor and residual after each."""
    p = _tree(inp, "start", rows, cut)
    ef = compression.init_ef_state(p)
    out = []
    for t in range(ROUNDS):
        p = _drifted(p, _tree(inp, f"drift{t}", rows, cut))
        collectives.reset_collective_bytes()
        p, ef = sync(p, ef, mesh)
        out.append({"params": _numpy(p), "anchor": _numpy(ef.anchor),
                    "residual": _numpy(ef.residual),
                    "bytes": collectives.collective_bytes()})
    return out


def cluster_ranks(rank, results, inp):
    """One cluster a rank on a (cluster 2) mesh."""
    mesh = make_hfl_mesh("cpu")
    mine = slice(rank, rank + 1)
    out = {"coordinate": mesh.get_coordinate()}
    collectives.reset_collective_bytes()
    out["plain"] = _numpy(collectives.global_sync_shardmap(
        _tree(inp, "diverged", mine), mesh))
    out["plain_bytes"] = collectives.collective_bytes()
    out["int8"] = _int8_rounds(
        inp, compression.compressed_global_sync_shardmap, mesh, mine)

    def base(p, o, b):
        w = p["w"].detach().requires_grad_()
        with torch.enable_grad():
            loss = torch.mean((b["x"] @ w - b["y"]) ** 2)
            g, = torch.autograd.grad(loss, w)
        return {"w": p["w"] - 0.1 * g}, o, loss.detach()

    stepped = collectives.make_hfl_local_step_shardmap(base, mesh)
    collectives.reset_collective_bytes()
    p, o, loss = stepped({"w": torch.ones((1, 4))}, torch.zeros((1,)),
                         {"x": torch.as_tensor(inp["ls/x"][mine]),
                          "y": torch.as_tensor(inp["ls/y"][mine])})
    out["local"] = {"w": p["w"].numpy(), "loss": loss.numpy(),
                    "opt_shape": tuple(o.shape),
                    "bytes": collectives.collective_bytes()}
    return out


def mesh4_ranks(rank, results, inp):
    """4 ranks: the int8 syncs on a (cluster 2, data 2) mesh, each
    rank's cluster whole (shard_map) and its data shard (manual); then
    the reductions on a (pod 2, data 2) mesh."""
    mesh = make_hfl_mesh("cpu", n_clusters=2)
    c, d = mesh.get_coordinate()
    mine = slice(c, c + 1)
    out = {"coordinate": (c, d)}
    out["int8"] = _int8_rounds(
        inp, compression.compressed_global_sync_shardmap, mesh, mine)
    out["manual"] = _int8_rounds(
        inp, compression.compressed_global_sync_manual, mesh, mine, (d, 2))
    pmesh = make_test_mesh("cpu", (2, 2), ("pod", "data"))
    x = torch.as_tensor(inp["allreduce/x"])
    collectives.reset_collective_bytes()
    out["hier/local"] = collectives.hierarchical_allreduce(
        local_block(x, pmesh, ("data",)), pmesh, do_global=False).numpy()
    out["hier/global"] = collectives.hierarchical_allreduce(
        local_block(x, pmesh, ("data", "pod")), pmesh).numpy()
    out["flat"] = collectives.flat_allreduce(
        local_block(x, pmesh, ("pod", "data")), pmesh).numpy()
    out["reduce_bytes"] = collectives.collective_bytes()
    return out


def failing_rank(rank, results):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()                     # waits for a rank that is gone
    return rank


def hanging_rank(rank, results):
    if rank == 1:
        time.sleep(3600)
    return rank


# ---------------------------------------------------------------------------
# fixtures: one JAX subprocess, one spawn a mesh shape
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def jax_ref(inputs, tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("jax_ref")
    np.savez(d / "in.npz", **inputs)
    dtypes = ",".join(f"{'/'.join(p)}={dt}" for p, (_, dt) in LEAVES.items())
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                           str(d / "in.npz"), str(d / "out.npz"), dtypes,
                           str(ROUNDS)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_REF_OK" in proc.stdout
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def ranks2(inputs):
    return run_ranks(cluster_ranks, 2, backend="gloo", device="cpu",
                     timeout=TIMEOUT, args=(inputs,))


@pytest.fixture(scope="module")
def ranks4(inputs):
    return run_ranks(mesh4_ranks, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, args=(inputs,))


def _dtype(name):
    return LEAVES[tuple(name.split("/"))][1]


def _tol(name):
    return BF16 if _dtype(name) == "bfloat16" else F32


def _stacked(ranks, get):
    """Each leaf's per-rank arrays stacked on the cluster dim."""
    first = get(ranks[0])
    return {k: np.concatenate([get(r)[k] for r in ranks]) for k in first}


def _single_device(inputs):
    """The port's single-device syncs over the stacked clusters: the
    plain sync of the diverged replicas and ROUNDS int8 syncs."""
    plain = _numpy(collectives.global_sync(_tree(inputs, "diverged")))
    p = _tree(inputs, "start")
    ef = compression.init_ef_state(p)
    rounds = []
    for t in range(ROUNDS):
        p = _drifted(p, _tree(inputs, f"drift{t}"))
        p, ef = compression.compressed_global_sync(p, ef)
        rounds.append({"params": _numpy(p), "anchor": _numpy(ef.anchor),
                       "residual": _numpy(ef.residual)})
    return plain, rounds


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_sit_on_their_mesh_coordinates(ranks2, ranks4):
    assert [r["coordinate"] for r in ranks2] == [(0, 0), (1, 0)]
    assert [r["coordinate"] for r in ranks4] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]


def test_global_sync_shardmap_matches_jax_and_global_sync(inputs, jax_ref,
                                                          ranks2):
    got = _stacked(ranks2, lambda r: r["plain"])
    single, _ = _single_device(inputs)
    for name, x in got.items():
        assert_allclose(x, jax_ref[f"plain/{name}"], **_tol(name),
                        err_msg=name)
        # the port's own single-device sync, bit for bit; replicas equal
        assert np.array_equal(x, single[name]), name
        assert np.array_equal(x[0], x[1]), name


@pytest.mark.parametrize("t", range(ROUNDS))
@pytest.mark.parametrize("kind", ["int8", "manual"])
def test_int8_syncs_match_jax(inputs, jax_ref, ranks2, ranks4, kind, t):
    """Both int8 syncs over 2 rounds with their error-feedback state: the
    params, anchor and residual of every cluster against the
    reference's (the manual variant's shards reassembled)."""
    if kind == "int8":
        ranks = ranks2
        get = lambda r, part: r["int8"][t][part]  # noqa: E731
    else:
        # ranks (c, 0), (c, 1) hold the two halves of cluster c's first dim
        ranks = ranks4

        def get(r, part):
            return r["manual"][t][part]
    for part in ("params", "anchor", "residual"):
        if kind == "int8":
            got = _stacked(ranks, lambda r: get(r, part))
        else:
            got = {k: np.concatenate([np.concatenate(
                [get(ranks[2 * c + d], part)[k] for d in range(2)], axis=1)
                for c in range(C)]) for k in get(ranks[0], part)}
        for name, x in got.items():
            tol = _tol(name) if part == "params" else F32
            assert_allclose(x, jax_ref[f"{kind}{t}/{part}/{name}"], **tol,
                            err_msg=f"{part} {name}")


@pytest.mark.parametrize("t", range(ROUNDS))
def test_int8_sync_shardmap_is_compressed_global_sync_bit_for_bit(
        inputs, ranks2, ranks4, t):
    _, single = _single_device(inputs)
    for ranks, stride in ((ranks2, 1), (ranks4, 2)):
        clusters = ranks[::stride]
        for part in ("params", "anchor", "residual"):
            got = _stacked(clusters, lambda r: r["int8"][t][part])
            for name, x in got.items():
                assert np.array_equal(x, single[t][part][name]), \
                    (stride, part, name)
        # a data axis holds copies of its cluster: the same bits
        if stride == 2:
            for c in range(C):
                a, b = ranks[2 * c]["int8"][t], ranks[2 * c + 1]["int8"][t]
                for name in a["params"]:
                    assert np.array_equal(a["params"][name],
                                          b["params"][name])
    for name, x in _stacked(ranks2, lambda r: r["int8"][t]["params"]
                            ).items():
        assert np.array_equal(x[0], x[1]), name


@pytest.mark.parametrize("t", range(ROUNDS))
def test_manual_shards_are_pieces_of_the_shardmap_result(ranks4, t):
    """On one (cluster, data) mesh: rank (c, d)'s manual result is block
    d of its cluster's ``shard_map`` result, bit for bit."""
    for r in ranks4:
        c, d = r["coordinate"]
        for part in ("params", "anchor", "residual"):
            whole, shard = r["int8"][t][part], r["manual"][t][part]
            for name, x in shard.items():
                half = whole[name].shape[1] // 2
                assert np.array_equal(
                    x, whole[name][:, d * half:(d + 1) * half]), \
                    (c, d, part, name)


def test_local_step_shardmap_matches_jax_with_no_collective(jax_ref, ranks2):
    w = np.concatenate([r["local"]["w"] for r in ranks2])
    loss = np.concatenate([r["local"]["loss"] for r in ranks2])
    assert loss.shape == (C,)
    assert_allclose(w, jax_ref["local/w"], **F32)
    assert_allclose(loss, jax_ref["local/loss"], **F32)
    # clusters trained on different data: the replicas diverged
    assert not np.allclose(w[0], w[1])
    for r in ranks2:
        assert r["local"]["opt_shape"] == (1,)
        assert r["local"]["bytes"] == {}         # no collective at all


def test_collective_bytes_of_the_syncs(inputs, ranks2):
    params = {name: int(np.prod(shape)) for name, (shape, _) in
              (("/".join(p), v) for p, v in LEAVES.items())}
    itemsize = {"bfloat16": 2, "float32": 4}
    plain = sum(n * itemsize[_dtype(k)] for k, n in params.items())
    local = _tree(inputs, "start", slice(0, 1))
    assert plain == compression.sync_bytes(local, compressed=False)
    for r in ranks2:
        assert r["plain_bytes"] == {"all_gather": {"cluster": plain}}
        # 1 byte a parameter, 4 bytes a leaf (its scale), on the wire
        int8 = sum(params.values()) + 4 * len(params)
        assert int8 == compression.sync_bytes(local, True) + 4 * len(params)
        for t in range(ROUNDS):
            assert r["int8"][t]["bytes"] == {"all_gather": {"cluster": int8}}


def test_manual_sync_bytes_carry_only_the_shard(inputs, ranks4):
    n = sum(int(np.prod(s)) for s, _ in LEAVES.values())
    for r in ranks4:
        for t in range(ROUNDS):
            assert r["manual"][t]["bytes"] == {
                "all_gather": {"cluster": n // 2 + 4 * len(LEAVES)},
                "all_reduce": {"data": 4 * len(LEAVES)}}


@pytest.mark.parametrize("key", ["hier/local", "hier/global", "flat"])
def test_allreduces_match_jax(inputs, jax_ref, ranks4, key):
    x = inputs["allreduce/x"]
    for r in ranks4:
        assert_allclose(r[key], jax_ref[key], **F32)
    # the means they stand for
    blocks = {"hier/local": x.reshape(2, 4, 3),
              "hier/global": x.reshape(4, 2, 3),
              "flat": x.reshape(4, 2, 3)}[key]
    assert_allclose(jax_ref[key], blocks.mean(axis=0), **F32)


def test_allreduce_bytes_by_axis(ranks4):
    block = {"local": 4 * 3 * 4, "global": 2 * 3 * 4, "flat": 2 * 3 * 4}
    for r in ranks4:
        assert r["reduce_bytes"] == {"all_reduce": {
            "data": block["local"] + block["global"],
            "pod": block["global"], "pod,data": block["flat"]}}


@pytest.mark.parametrize("body,error,timeout", [
    (failing_rank, RuntimeError, 60), (hanging_rank, TimeoutError, 10)])
def test_run_ranks_raises_within_its_timeout(body, error, timeout):
    t0 = time.monotonic()
    with pytest.raises(error) as info:
        run_ranks(body, 2, backend="gloo", device="cpu", timeout=timeout)
    # the ranks are stopped within seconds of the failure or the deadline
    assert time.monotonic() - t0 < timeout + 15
    if error is RuntimeError:
        assert "rank 1 fails on purpose" in str(info.value)


def test_run_ranks_refuses_an_unknown_backend():
    with pytest.raises(ValueError):
        run_ranks(failing_rank, 2, backend="mpi")


def test_run_ranks_without_a_device_asks_for_the_card():
    """No ``device`` means one card a rank, as every entry point of the
    port: where CUDA is absent it raises ``resolve_device``'s error
    before any rank starts, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card is here: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(failing_rank, 2, backend="gloo")
