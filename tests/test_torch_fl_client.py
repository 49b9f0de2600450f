"""The port's FL clients (``repro_torch.fl.client``) against
``repro.fl.client`` on the reduced GRU (hidden 32): local SGD on the
same numpy initial models and the same minibatch orders, the
validation MSE, and the stacking of client trees; on the card, the
launches of ``gru_seq`` that local training makes.

The JAX package draws each client's epoch permutations inside ``jit``
from ``split(split(key, C)[c], epochs)[e]``; the port takes them as a
(C, epochs, N) argument, which the tests rebuild from the same key
chain."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fl import client  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree, to_numpy_tree)

TOL = dict(atol=2e-5, rtol=2e-5)
C, N, T, EPOCHS, BATCH, LR = 4, 64, 12, 2, 8, 1e-2


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons.  Imported here, not at
    the top, so that the card's test runs where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.fl import client as jax_client
    from repro.models import gru as jax_gru
    return SimpleNamespace(jax=jax, jnp=jax.numpy, client=jax_client,
                           gru=jax_gru,
                           cfg=jax_get_config("gru-traffic").reduced())


def jax_permutations(jax, key, C, epochs, N):
    """(C, epochs, N): the permutations ``repro.fl.client`` draws from
    ``key``, one call per key."""
    return np.stack([np.stack([np.asarray(jax.random.permutation(ek, N))
                               for ek in jax.random.split(ck, epochs)])
                     for ck in jax.random.split(key, C)])


def _cfg():
    return get_config("gru-traffic").reduced()


def _stacked_init(jx, C, seed=0):
    keys = jx.jax.random.split(jx.jax.random.key(seed), C)
    jtree = jx.client.stack_clients(
        [jx.gru.init_params(k, jx.cfg.model)[0] for k in keys])
    return jtree, from_numpy_tree(jx.jax.tree.map(np.asarray, jtree), "cpu")


def numpy_clients(C, seed=2):
    """C stacked reduced GRUs in the JAX package's layout, drawn with
    numpy."""
    r, h = np.random.default_rng(seed), _cfg().model.rnn_hidden

    def draw(*shape):
        return (r.normal(size=(C,) + shape) / np.sqrt(shape[0])).astype(
            np.float32)

    return {"gru": {str(i): {"w_x": draw(1 if i == 0 else h, 3 * h),
                             "w_h": draw(h, 3 * h), "b": draw(3 * h)}
                    for i in range(_cfg().model.rnn_layers)},
            "head": {"w": draw(h, 1), "b": draw(1)}}


def _data(C, N, seed=1):
    r = np.random.default_rng(seed)
    return (r.normal(size=(C, N, T, 1)).astype(np.float32),
            r.normal(size=(C, N, 1)).astype(np.float32))


def _assert_tree_close(torch_tree, want, **tol):
    """``want``: a tree of numpy arrays (or of JAX arrays)."""
    got = flatten_with_path(to_numpy_tree(torch_tree))
    want = [(p, np.asarray(w)) for p, w in flatten_with_path(want)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert_allclose(g, w, err_msg=str(path), **tol)


def test_vmapped_permutation_draws_what_separate_calls_draw(jx):
    jax = jx.jax
    keys = jax.random.split(jax.random.key(1), 4)
    vmapped = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 50))(
        keys))
    separate = np.stack([np.asarray(jax.random.permutation(k, 50))
                         for k in keys])
    np.testing.assert_array_equal(vmapped, separate)


@pytest.mark.parametrize("max_batches", [3, 0])
def test_train_clients_locally_matches_jax(jx, max_batches):
    jtree, ttree = _stacked_init(jx, C)
    X, y = _data(C, N)
    key = jx.jax.random.key(7)
    want, want_loss = jx.client.train_clients_locally(
        jtree, jx.client.ClientBatch(jx.jnp.asarray(X), jx.jnp.asarray(y)),
        key, cfg=jx.cfg, epochs=EPOCHS, batch_size=BATCH, lr=LR,
        max_batches=max_batches)
    perms = torch.from_numpy(jax_permutations(jx.jax, key, C, EPOCHS, N))
    got, got_loss = client.train_clients_locally(
        ttree, client.ClientBatch(torch.from_numpy(X), torch.from_numpy(y)),
        perms, cfg=_cfg(), epochs=EPOCHS, batch_size=BATCH, lr=LR,
        max_batches=max_batches)
    assert got_loss.shape == (C,)
    assert_allclose(got_loss.numpy(), np.asarray(want_loss), **TOL)
    _assert_tree_close(got, want, **TOL)
    # the input tree is left as it was
    _assert_tree_close(ttree, jtree, atol=0, rtol=0)


def test_train_clients_locally_rejects_permutations_of_another_shape():
    ttree = from_numpy_tree(numpy_clients(2), "cpu")
    X, y = _data(2, N)
    with pytest.raises(ValueError, match="perms"):
        client.train_clients_locally(
            ttree, client.ClientBatch(torch.from_numpy(X),
                                      torch.from_numpy(y)),
            torch.zeros((2, EPOCHS, N - 1), dtype=torch.int64), cfg=_cfg(),
            epochs=EPOCHS, batch_size=BATCH, lr=LR)


def test_eval_clients_matches_jax(jx):
    jtree, ttree = _stacked_init(jx, C, seed=3)
    X, y = _data(C, 40, seed=4)
    want = jx.client.eval_clients(
        jtree, jx.client.ClientBatch(jx.jnp.asarray(X), jx.jnp.asarray(y)),
        cfg=jx.cfg)
    got = client.eval_clients(
        ttree, client.ClientBatch(torch.from_numpy(X), torch.from_numpy(y)),
        cfg=_cfg())
    assert got.shape == (C,) and not got.requires_grad
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stack_and_unstack_round_trip(jx):
    jtree, ttree = _stacked_init(jx, 3, seed=5)
    clients = [client.unstack_client(ttree, i) for i in range(3)]
    for i, c in enumerate(clients):
        _assert_tree_close(c, jx.client.unstack_client(jtree, i),
                           atol=0, rtol=0)
    _assert_tree_close(client.stack_clients(clients), jtree, atol=0, rtol=0)


def test_draw_permutations_are_permutations_and_follow_the_generator():
    a = client.draw_permutations(torch.Generator().manual_seed(0), 3, 2, 17)
    b = client.draw_permutations(torch.Generator().manual_seed(0), 3, 2, 17)
    assert a.shape == (3, 2, 17) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert torch.equal(a.sort(dim=-1).values,
                       torch.arange(17).expand(3, 2, 17))


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
def test_training_on_the_card_runs_every_forward_through_gru_seq(
        cuda_device):
    tcfg = _cfg()
    tree = numpy_clients(2)
    X, y = _data(2, 16)
    perms = client.draw_permutations(torch.Generator().manual_seed(0), 2, 1,
                                     16)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        data = client.ClientBatch(torch.from_numpy(X).to(dev),
                                  torch.from_numpy(y).to(dev))
        ops.reset_launches()
        out[dev.type] = client.train_clients_locally(
            from_numpy_tree(tree, dev), data, perms, cfg=tcfg, epochs=1,
            batch_size=8, lr=LR, max_batches=1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # one step per client: one launch per layer in the forward,
            # none in the backward (the plain version's)
            assert ops.launch_counts()["gru_seq"] == 2 * tcfg.model.rnn_layers
    for (_, g), (_, w) in zip(flatten_with_path(out["cuda"][0]),
                              flatten_with_path(out["cpu"][0])):
        assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4, rtol=1e-4)
