"""The port's FedAvg rounds against ``repro.fl.aggregation`` on the same
stacked client replicas: flat FedAvg with and without weights, cluster
and global rounds, including a cluster id with no members."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.fl import aggregation as jagg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.fl import aggregation as agg  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree, to_numpy_tree, tree_map)

TOL = dict(atol=3e-5, rtol=3e-5)
IDS = {"two_clusters": [0, 0, 1, 1, 1],
       "empty_cluster": [0, 0, 2, 2, 2],
       "singletons": [3, 1, 0, 2, 4],
       "one_cluster": [0, 0, 0, 0, 0]}


def _stacked(C=5, h=6, seed=0):
    """Stacked GRU-shaped client replicas as a numpy tree."""
    r = np.random.default_rng(seed)

    def draw(*shape):
        return r.normal(size=(C,) + shape).astype(np.float32)

    return {"gru": {"0": {"w_x": draw(1, 3 * h), "w_h": draw(h, 3 * h),
                          "b": draw(3 * h)}},
            "head": {"w": draw(h, 1), "b": draw(1)}}


def _assert_trees_close(got, want, **tol):
    g, w = flatten_with_path(to_numpy_tree(got)), flatten_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.shape == np.shape(b), p
        assert np.isfinite(a).all(), p
        assert_allclose(a, np.asarray(b), err_msg=str(p), **tol)


@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_matches_jax(weighted):
    tree = _stacked()
    w = np.array([1.0, 2.0, 3.0, 0.5, 4.0]) if weighted else None
    want = jagg.fedavg(jax.tree.map(jnp.asarray, tree),
                       None if w is None else jnp.asarray(w))
    got = agg.fedavg(from_numpy_tree(tree, "cpu"), w)
    _assert_trees_close(got, jax.tree.map(np.asarray, want), **TOL)


def test_fedavg_takes_weights_as_a_tensor():
    tree = from_numpy_tree(_stacked(), "cpu")
    w = np.array([1.0, 2.0, 3.0, 0.5, 4.0])
    a = agg.fedavg(tree, w)
    b = agg.fedavg(tree, torch.as_tensor(w))
    for (_, x), (_, y) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ids", list(IDS.values()), ids=list(IDS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("round_fn", ["cluster_fedavg", "global_fedavg"])
def test_hierarchical_rounds_match_jax(ids, weighted, round_fn):
    tree = _stacked(seed=len(ids) + sum(ids))
    w = np.array([100.0, 50.0, 80.0, 20.0, 60.0]) if weighted else None
    want = getattr(jagg, round_fn)(jax.tree.map(jnp.asarray, tree),
                                   np.asarray(ids), w)
    got = getattr(agg, round_fn)(from_numpy_tree(tree, "cpu"),
                                 np.asarray(ids), w)
    _assert_trees_close(got, jax.tree.map(np.asarray, want), **TOL)


def test_empty_cluster_adds_nothing_to_the_global_model():
    tree = from_numpy_tree(_stacked(), "cpu")
    w = np.array([1.0, 3.0, 2.0, 2.0, 4.0])
    with_gap = agg.global_fedavg(tree, [0, 0, 2, 2, 2], w)
    packed = agg.global_fedavg(tree, [0, 0, 1, 1, 1], w)
    for (_, a), (_, b) in zip(flatten_with_path(with_gap),
                              flatten_with_path(packed)):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_bf16_follows_fedavg_reduce_ref():
    """For bf16 replicas the port keeps the normalised weights in fp32,
    as the JAX package's fedavg_reduce does (its fedavg rounds them to
    the parameter dtype first)."""
    tree = _stacked(seed=7)
    w = np.array([1.0, 2.0, 3.0, 0.5, 4.0], np.float32)
    got = agg.fedavg(tree_map(lambda v: torch.from_numpy(v).bfloat16(), tree),
                     w)
    for p, leaf in flatten_with_path(tree):
        xj = jnp.asarray(leaf.reshape(leaf.shape[0], -1), jnp.bfloat16)
        want = np.asarray(jref.fedavg_reduce_ref(xj, jnp.asarray(w)),
                          np.float32)
        node = got
        for k in p:
            node = node[k]
        assert node.dtype == torch.bfloat16
        assert_allclose(node.float().numpy().reshape(-1), want,
                        atol=3e-2, rtol=3e-2)


def test_cluster_ids_must_cover_every_client():
    tree = from_numpy_tree(_stacked(), "cpu")
    with pytest.raises(ValueError, match="one id per client"):
        agg.cluster_fedavg(tree, [0, 1, 1])
