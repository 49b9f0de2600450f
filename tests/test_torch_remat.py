"""Per-layer activation checkpointing (``RunConfig.remat``) in the
port's four checkpointed families, on reduced fp32 configs on the CPU:
the loss and every gradient with ``remat="layer"`` equal those with
``"none"`` bit for bit, fewer bytes are saved for backward, and a
forward without grad takes no checkpoint.  Parity with the reference's
checkpointed step is ``test_torch_training.py``'s
``test_train_step_matches_jax`` (every reduced config keeps its
``remat="layer"``)."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, make_model  # noqa: E402
from repro_torch.params import flatten_with_path  # noqa: E402
from repro_torch.params import from_numpy_tree  # noqa: E402
from repro_torch.training import SGD, make_train_step  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402

#: family -> arch, each cut to its reduced config
ARCHS = {"dense": "stablelm-1.6b", "moe": "deepseek-v2-lite-16b",
         "hybrid": "zamba2-1.2b", "xlstm": "xlstm-125m",
         "audio": "whisper-small"}
B, S = 2, 12


def config(family, remat, k=1):
    cfg = get_config(ARCHS[family]).reduced()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       param_dtype="float32"),
        run=dataclasses.replace(cfg.run, remat=remat, microbatches=k))


def checkpointed_layers(cfg):
    """Layers a forward checkpoints: the reference's scope."""
    m = cfg.model
    if m.family == "audio":
        return m.encoder_layers + m.num_layers
    if m.moe is not None:
        return m.num_layers - m.moe.first_dense_layers
    return m.num_layers


_PARAMS = {}


def setup(family):
    """(parameters, numpy batch) of the fp32 reduced arch, drawn once."""
    if family not in _PARAMS:
        cfg = config(family, "none")
        m = cfg.model
        params = make_model(cfg).init_params(
            torch.Generator().manual_seed(0), "cpu")
        r = np.random.default_rng(1)
        batch = {"tokens": r.integers(0, m.vocab_size, (B, S)),
                 "labels": r.integers(0, m.vocab_size, (B, S))}
        if m.family == "audio":
            batch["frames"] = r.normal(
                size=(B, m.frontend.num_positions, m.d_model)
            ).astype(np.float32)
        _PARAMS[family] = (params, batch)
    return _PARAMS[family]


_RUNS = {}


def run(family, remat):
    """One ``value_and_grad`` of the loss, drawn once per (family, remat):
    (loss, gradients by path, bytes autograd saved for backward, the
    keyword arguments of each checkpoint taken)."""
    if (family, remat) not in _RUNS:
        params, batch = setup(family)
        api = make_model(config(family, remat))
        saved, calls = [0], []
        real = common.checkpoint

        def counting(fn, *args, **kw):
            calls.append(kw)
            return real(fn, *args, **kw)

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with mock.patch.object(common, "checkpoint", counting), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, grads = value_and_grad(api.loss, params,
                                         from_numpy_tree(batch, "cpu"))
        _RUNS[family, remat] = (loss, dict(flatten_with_path(grads)),
                                saved[0], calls)
    return _RUNS[family, remat]


@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_layer_equals_none_bit_for_bit(family):
    loss0, g0, _, _ = run(family, "none")
    loss1, g1, _, _ = run(family, "layer")
    assert torch.equal(loss0, loss1), (float(loss0), float(loss1))
    assert g0.keys() == g1.keys()
    for p, a in g0.items():
        assert torch.equal(a, g1[p]), p
    assert any(float(g.abs().max()) > 0 for g in g1.values())


def test_remat_dots_is_layer():
    loss1, g1, _, _ = run("dense", "layer")
    loss2, g2, _, _ = run("dense", "dots")
    assert torch.equal(loss1, loss2)
    for p, a in g1.items():
        assert torch.equal(a, g2[p]), p


def test_moe_train_step_at_two_microbatches_bit_for_bit():
    """The MoE at microbatches 2 through ``make_train_step`` (SGD): the
    new parameters and the loss equal the un-checkpointed step's."""
    params, batch = setup("moe")
    out = {}
    for remat in ("none", "layer"):
        cfg = config("moe", remat, k=2)
        opt = SGD(lr=1e-2)
        new, _, loss = make_train_step(make_model(cfg), cfg, opt)(
            params, opt.init(params), from_numpy_tree(batch, "cpu"))
        out[remat] = (loss, dict(flatten_with_path(new)))
    assert torch.equal(out["none"][0], out["layer"][0])
    for p, x in out["none"][1].items():
        assert torch.equal(x, out["layer"][1][p]), p


@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_saves_fewer_bytes_for_backward(family):
    none, layer = run(family, "none")[2], run(family, "layer")[2]
    assert layer < none, (layer, none)


@pytest.mark.parametrize("family", list(ARCHS))
def test_checkpoint_taken_under_grad_only(family, monkeypatch):
    """With grad each checkpointed layer goes through the checkpoint
    once; without grad, or with ``remat="none"``, none does."""
    calls = []
    monkeypatch.setattr(common, "checkpoint",
                        lambda *a, **kw: calls.append(kw))
    params, batch = setup(family)
    cfg = config(family, "layer")
    with torch.no_grad():
        make_model(cfg).loss(params, from_numpy_tree(batch, "cpu"))
    assert calls == []
    assert run(family, "none")[3] == []
    taken = run(family, "layer")[3]
    assert len(taken) == checkpointed_layers(cfg)
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False}
               for kw in taken)


def test_recomputation_keeps_the_forward_s_sharding_context():
    """On the card autograd recomputes a checkpointed layer in its own
    thread for the device, which sees neither the caller's thread-local
    ``logical_sharding`` nor DTensor's implicit replication: the layer
    takes both along (a backward in another thread stands for it here)."""
    import threading

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    seen = []

    def layer(x):
        seen.append((getattr(common._CTX, "state", None),
                     DTensor._op_dispatcher._allow_implicit_replication))
        return (x * 2).sin()

    x = torch.ones(3, requires_grad=True)
    state = ({"data": 1}, {"embed": ()})
    with common.logical_sharding(*state), implicit_replication():
        y = common.checkpointed("layer", layer, x).sum()
        assert DTensor._op_dispatcher._allow_implicit_replication
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [(state, True), (state, True)]
    assert torch.allclose(x.grad, 2 * torch.cos(2 * torch.ones(3)))
    assert getattr(common._CTX, "state", None) is None
    assert not DTensor._op_dispatcher._allow_implicit_replication
