"""Checkpoints cross between the packages in the flat-key npz format:
a JAX ``save_pytree`` loads into the port, and a port save loads back
with ``repro.checkpoint.io.load_pytree``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree, to_numpy_tree)


def _jax_params(seed):
    cfg = jax_get_config("gru-traffic").reduced()
    params, _ = jax_gru.init_params(jax.random.key(seed), cfg.model)
    return params


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    params = _jax_params(0)
    path = str(tmp_path / "jax_ckpt.npz")
    jio.save_pytree(path, params)
    like = from_numpy_tree(jax.tree.map(np.zeros_like, params), "cpu")
    got = load_pytree(path, like)
    want = jax.tree.map(np.asarray, params)
    for (p, a), (q, b) in zip(flatten_with_path(to_numpy_tree(got)),
                              flatten_with_path(want)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_into_jax(tmp_path):
    params = from_numpy_tree(jax.tree.map(np.asarray, _jax_params(1)), "cpu")
    path = str(tmp_path / "torch_ckpt")
    save_pytree(path + ".npz", params)
    like = _jax_params(2)
    got = jio.load_pytree(path, like)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.numpy()), got, params)


def test_keys_are_the_jax_keystr_paths(tmp_path):
    params = from_numpy_tree(jax.tree.map(np.asarray, _jax_params(0)), "cpu")
    save_pytree(str(tmp_path / "c.npz"), params)
    with np.load(tmp_path / "c.npz") as data:
        keys = set(data.files)
    assert "['gru']::['0']::['w_x']" in keys
    assert "['head']::['b']" in keys


def test_load_keeps_dtype_of_like_and_checks_keys(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16)]}
    save_pytree(str(tmp_path / "t.npz"), tree)
    got = load_pytree(str(tmp_path / "t"), tree)
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"])
    with pytest.raises(ValueError, match="mismatch"):
        load_pytree(str(tmp_path / "t.npz"), {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "t.npz"),
                    {"a": torch.zeros(3, 2), "b": tree["b"]})


def _bf16_jax_tree(seed):
    """A bfloat16 tree as the LM configs make one (``dtype="bfloat16"``),
    with values that are not exact in fewer bits."""
    r = np.random.default_rng(seed)
    return {"embed": {"table": jax.numpy.asarray(r.normal(size=(7, 5)),
                                                 jax.numpy.bfloat16)},
            "layers": {"wq": jax.numpy.asarray(r.normal(size=(2, 5, 3)),
                                               jax.numpy.bfloat16)}}


def _bits(x):
    return np.asarray(x).view(np.uint16)


def test_bf16_jax_tree_carries_over_bit_exactly():
    tree = _bf16_jax_tree(0)
    got = from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")
    for (p, a), (q, b) in zip(flatten_with_path(got),
                              flatten_with_path(tree)):
        assert p == q and a.dtype == torch.bfloat16
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.view(torch.int16).numpy()
                                      .view(np.uint16), _bits(b))


def test_bf16_jax_checkpoint_loads_bit_exactly(tmp_path):
    tree = _bf16_jax_tree(1)
    path = str(tmp_path / "bf16.npz")
    jio.save_pytree(path, tree)
    with np.load(path) as data:      # npz keeps bfloat16 as raw bytes
        assert {data[k].dtype.str for k in data.files} == {"|V2"}
    like = jax.tree.map(
        lambda x: torch.zeros(x.shape, dtype=torch.bfloat16), tree)
    got = load_pytree(path, like)
    for (_, a), (_, b) in zip(flatten_with_path(got),
                              flatten_with_path(tree)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy()
                                      .view(np.uint16), _bits(b))
