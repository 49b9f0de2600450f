"""The port's cluster-replicated parameters (``repro_torch.fl.
collectives``) and int8 error-feedback sync (``repro_torch.fl.
compression``) against the JAX package's, on the CPU: trees with bf16
and fp32 leaves drawn with numpy and fed to both.

- ``global_sync`` with and without weights (one ``fedavg_reduce`` a
  dtype group, every replica identical after it), ``stack_for_clusters``,
  ``cluster_slice`` and ``cluster_divergence``;
- no aliasing: after ``stack_for_clusters`` and after ``global_sync``,
  an in-place update of one cluster's replica leaves the others as they
  were (JAX's ``broadcast_to`` is a value; an ``expand`` view is not);
- ``quantize_int8`` / ``dequantize_int8`` with exact .5 ties (rounded
  half to even, as ``jnp.round``), and ``compressed_global_sync`` over 3
  rounds with its error-feedback state, with and without weights;
- ``sync_bytes``.

Tolerances: fp32 3e-5, bf16 3e-2 (``tests/test_kernels.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.fl import collectives as jcol  # noqa: E402
from repro.fl import compression as jcomp  # noqa: E402
from repro_torch.fl import collectives, compression  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.params import flatten_with_path, from_numpy_tree  # noqa: E402

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
C = 3


def tree(seed=0, lead=()):
    """bf16 leaves (the transformer's) and fp32 ones (a MoE router, an
    xLSTM gate), as the JAX tree's numpy arrays."""
    r = np.random.default_rng(seed)
    n = lambda *s: r.normal(size=lead + s)  # noqa: E731
    return {"layers": {"w": n(4, 6).astype(jnp.bfloat16),
                       "router": n(6, 3).astype(np.float32)},
            "embed": {"table": n(10, 4).astype(jnp.bfloat16)},
            "gate": n(5).astype(np.float32)}


def leaves(t):
    return [(p, np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                           np.float32))
            for p, x in flatten_with_path(t)]


def jleaves(t):
    return leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), t))


def assert_tree_close(got, want):
    for (p, g), (_, w), (_, x) in zip(leaves(got), jleaves(want),
                                      flatten_with_path(got)):
        tol = BF16 if x.dtype == torch.bfloat16 else F32
        assert_allclose(g, w, **tol, err_msg=str(p))


def test_stack_for_clusters_copies_and_cluster_slice_views():
    params = from_numpy_tree(tree(), "cpu")
    stacked = collectives.stack_for_clusters(params, C)
    want = jcol.stack_for_clusters(jax.tree.map(jnp.asarray, tree()), C)
    for (p, g), (_, w) in zip(leaves(stacked), jleaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w), p
    for (_, x), (_, s) in zip(flatten_with_path(params),
                              flatten_with_path(stacked)):
        assert s.dtype == x.dtype and s.is_contiguous()
        assert s.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
    view = collectives.cluster_slice(stacked, 1)
    assert torch.equal(view["gate"], stacked["gate"][1])
    view["gate"].add_(1.0)                  # a view: lands in the stack
    assert torch.equal(stacked["gate"][1], params["gate"] + 1.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_global_sync_matches_jax(monkeypatch, weighted):
    stacked_np = tree(1, lead=(C,))
    w = np.array([1.0, 3.0, 0.5], np.float32) if weighted else None
    want = jcol.global_sync(jax.tree.map(jnp.asarray, stacked_np),
                            None if w is None else jnp.asarray(w))
    calls = []
    real = ops.fedavg_reduce

    def counted(x, weights):
        calls.append((tuple(x.shape), x.dtype))
        return real(x, weights)

    monkeypatch.setattr(ops, "fedavg_reduce", counted)
    stacked = from_numpy_tree(stacked_np, "cpu")
    got = collectives.global_sync(stacked, w)
    assert_tree_close(got, want)
    # one reduction a dtype group, over all of its leaves
    assert sorted(calls, key=str) == sorted(
        [((C, 4 * 6 + 10 * 4), torch.bfloat16),
         ((C, 6 * 3 + 5), torch.float32)], key=str)
    for (p, x), (_, s) in zip(flatten_with_path(got),
                              flatten_with_path(stacked)):
        assert x.dtype == s.dtype and x.shape == s.shape, p
        assert all(torch.equal(x[0], x[c]) for c in range(C)), p
    # the input is left as it was
    for (p, x), (_, s) in zip(leaves(stacked), leaves(stacked_np)):
        assert np.array_equal(x, s), p


def test_global_sync_weights_may_be_a_tensor():
    stacked = from_numpy_tree(tree(2, lead=(C,)), "cpu")
    w = [2.0, 1.0, 1.0]
    a = collectives.global_sync(stacked, w)
    b = collectives.global_sync(stacked, torch.tensor(w))
    for (_, x), (_, y) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stage", ["stacked", "synced"])
def test_no_cluster_aliases_another(stage):
    stacked = collectives.stack_for_clusters(
        from_numpy_tree(tree(3), "cpu"), C)
    if stage == "synced":
        stacked = collectives.global_sync(stacked)
    before = [x.clone() for _, x in flatten_with_path(stacked)]
    with torch.no_grad():
        for _, x in flatten_with_path(collectives.cluster_slice(stacked, 0)):
            x.mul_(-2.0).add_(1.0)
    for (p, x), old in zip(flatten_with_path(stacked), before):
        assert not torch.equal(x[0], old[0]), p
        for c in range(1, C):
            assert torch.equal(x[c], old[c]), (p, c)


def test_cluster_divergence_matches_jax():
    stacked_np = tree(4, lead=(C,))
    want = jcol.cluster_divergence(jax.tree.map(jnp.asarray, stacked_np))
    got = collectives.cluster_divergence(from_numpy_tree(stacked_np, "cpu"))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert_allclose(float(got), float(want), **F32)
    # equal replicas: only the fp32 mean's rounding is left, as in JAX
    synced = collectives.global_sync(from_numpy_tree(stacked_np, "cpu"))
    got = float(collectives.cluster_divergence(synced))
    want = float(jcol.cluster_divergence(jax.tree.map(
        lambda x: jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32),
        synced)))
    assert got < 1e-6 and want < 1e-6


def test_quantize_int8_rounds_ties_to_even_as_jax():
    # scale = 127 / 127 = 1: x / scale lands exactly on .5 ties
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -126.5],
                 np.float32)
    q, s = compression.quantize_int8(torch.as_tensor(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert float(s) == float(js) == 1.0
    assert q.dtype == torch.int8
    assert q.tolist() == np.asarray(jq).tolist() == \
        [127, 0, 2, 2, 0, -2, -2, 3, -126]
    # and on drawn values, the scale from the largest magnitude
    r = np.random.default_rng(5)
    x = (r.normal(size=(7, 9)) * 3).astype(np.float32)
    q, s = compression.quantize_int8(torch.as_tensor(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert_allclose(float(s), float(js), rtol=1e-7)
    assert_allclose(compression.dequantize_int8(q, s).numpy(),
                    np.asarray(jcomp.dequantize_int8(jq, js)), **F32)
    # an all-zero tensor keeps the floor scale
    q, s = compression.quantize_int8(torch.zeros(3))
    assert float(s) == pytest.approx(1e-12 / 127.0) and not q.any()


def _drifted(stacked, drift):
    """x + d, summed in fp32 and cast back, leaf by leaf."""
    d = dict(flatten_with_path(drift))
    out = {}
    for p, x in flatten_with_path(stacked):
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = (x.float() + d[p]).to(x.dtype)
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_compressed_global_sync_matches_jax_over_three_rounds(weighted):
    """3 rounds: each cluster drifts by its own draw, then syncs; the
    parameters, anchor and residual follow the reference's."""
    r = np.random.default_rng(6)
    w = np.array([1.0, 2.0, 4.0], np.float32) if weighted else None
    # replicas that start equal, as after stack_for_clusters
    start = jax.tree.map(lambda x: np.repeat(x[None], C, axis=0), tree(7))
    jp = jax.tree.map(jnp.asarray, start)
    jef = jcomp.init_ef_state(jp)
    tp = from_numpy_tree(start, "cpu")
    ef = compression.init_ef_state(tp)
    for _ in range(3):
        drift = jax.tree.map(
            lambda x: (r.normal(size=x.shape) * 0.05).astype(np.float32),
            start)
        jp = jax.tree.map(lambda x, d: (x.astype(jnp.float32) + d
                                        ).astype(x.dtype), jp, drift)
        tp = _drifted(tp, from_numpy_tree(drift, "cpu"))
        jp, jef = jcomp.compressed_global_sync(
            jp, jef, None if w is None else jnp.asarray(w))
        tp, ef = compression.compressed_global_sync(tp, ef, w)
        assert_tree_close(tp, jp)
        for got, want in ((ef.anchor, jef.anchor),
                          (ef.residual, jef.residual)):
            for (p, g), (_, v) in zip(leaves(got), jleaves(want)):
                assert_allclose(g, v, **F32, err_msg=str(p))
        for (p, x), (_, a) in zip(flatten_with_path(tp),
                                  flatten_with_path(ef.anchor)):
            assert all(torch.equal(x[0], x[c]) for c in range(C)), p
            assert a.dtype == torch.float32
            # the params never alias the anchor, not even fp32 leaves
            assert x.untyped_storage().data_ptr() != \
                a.untyped_storage().data_ptr(), p


def test_init_ef_state_does_not_alias_fp32_params():
    stacked = from_numpy_tree(tree(8, lead=(C,)), "cpu")
    ef = compression.init_ef_state(stacked)
    stacked["gate"].add_(1.0)
    assert not torch.equal(ef.anchor["gate"], stacked["gate"])
    assert all(not x.any() for _, x in flatten_with_path(ef.residual))


def test_compressed_sync_reduces_once(monkeypatch):
    """Every leaf's dequantized fp32 deltas in one (C, N) matrix: one
    ``fedavg_reduce``."""
    calls = []
    real = ops.fedavg_reduce
    monkeypatch.setattr(ops, "fedavg_reduce", lambda x, w: (
        calls.append((tuple(x.shape), x.dtype)), real(x, w))[1])
    stacked = from_numpy_tree(tree(9, lead=(C,)), "cpu")
    compression.compressed_global_sync(
        stacked, compression.init_ef_state(stacked))
    assert calls == [((C, 4 * 6 + 6 * 3 + 10 * 4 + 5), torch.float32)]


@pytest.mark.parametrize("compressed", [False, True])
def test_sync_bytes_matches_jax(compressed):
    stacked_np = tree(10, lead=(C,))
    want = jcomp.sync_bytes(jax.tree.map(jnp.asarray, stacked_np),
                            compressed)
    got = compression.sync_bytes(from_numpy_tree(stacked_np, "cpu"),
                                 compressed)
    assert isinstance(got, int) and got == want
    assert got == ((4 * 6 + 6 * 3 + 10 * 4 + 5) if compressed
                   else 2 * (4 * 6 + 10 * 4) + 4 * (6 * 3 + 5))
