"""The port's traffic GRU against ``repro.models.gru`` on carried-over
weights: forward, loss and decode step at hidden 32 (the reduced config)
and 128 (the paper's width), within 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import gru, make_model  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(reduced):
    j, t = jax_get_config("gru-traffic"), get_config("gru-traffic")
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _carried(jcfg, seed=0):
    jparams, _ = jax_gru.init_params(jax.random.key(seed), jcfg.model)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, from_numpy_tree(np_tree, "cpu")


def _windows(B, T=12, seed=1):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, 1)).astype(np.float32),
            r.normal(size=(B, 1)).astype(np.float32))


@pytest.mark.parametrize("reduced,hidden", [(True, 32), (False, 128)])
@pytest.mark.parametrize("B", [1, 4, 16])
def test_forward_matches_jax(reduced, hidden, B):
    jcfg, tcfg = _cfgs(reduced)
    assert tcfg.model.rnn_hidden == hidden
    jparams, tparams = _carried(jcfg)
    w, _ = _windows(B)
    want = jax_gru.forward(jparams, jcfg.model, jnp.asarray(w))
    got = gru.forward(tparams, tcfg.model, torch.from_numpy(w))
    assert got.shape == (B, 1)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reduced", [True, False])
def test_loss_and_decode_step_match_jax(reduced):
    jcfg, tcfg = _cfgs(reduced)
    jparams, tparams = _carried(jcfg, seed=3)
    w, y = _windows(8, seed=4)
    want = jax_gru.mse_loss(jparams, jcfg.model, jnp.asarray(w),
                            jnp.asarray(y))
    got = gru.mse_loss(tparams, tcfg.model, torch.from_numpy(w),
                       torch.from_numpy(y))
    assert_allclose(got.item(), float(want), **TOL)
    jpred, jcache = jax_gru.decode_step(jparams, jcfg.model, jnp.asarray(w))
    tpred, tcache = gru.decode_step(tparams, tcfg.model, torch.from_numpy(w))
    assert jcache is None and tcache is None
    assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)


@pytest.mark.parametrize("B", [1, 8])
def test_loss_gradients_match_jax(B):
    """``jax.grad`` of the reduced GRU's loss against the port's autograd
    through the same function, every leaf, within the GRU kernels' 2e-5:
    the target a loss on the card must reach through ``gru_seq``."""
    jcfg, tcfg = _cfgs(True)
    jparams, tparams = _carried(jcfg, seed=5)
    w, y = _windows(B, seed=6)
    want = jax.grad(jax_gru.mse_loss)(jparams, jcfg.model, jnp.asarray(w),
                                      jnp.asarray(y))
    leaves = [x.requires_grad_() for _, x in flatten_with_path(tparams)]
    got = torch.autograd.grad(
        gru.mse_loss(tparams, tcfg.model, torch.from_numpy(w),
                     torch.from_numpy(y)), leaves)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(k.key for k in path) for path, _ in jflat] == \
        [path for path, _ in flatten_with_path(tparams)]
    for g, (_, jg) in zip(got, jflat):
        assert g.abs().max() > 0
        assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_has_the_jax_tree(reduced):
    jcfg, tcfg = _cfgs(reduced)
    jparams, _ = jax_gru.init_params(jax.random.key(0), jcfg.model)
    tparams = gru.init_params(torch.Generator().manual_seed(0), tcfg.model,
                              device="cpu")
    jflat = [(tuple(k.key for k in p), x.shape, str(x.dtype))
             for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tflat = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
             for p, x in flatten_with_path(tparams)]
    assert jflat == tflat
    # fan-in normal: std 1/sqrt(fan_in); biases start at zero
    w_h = tparams["gru"]["1"]["w_h"]
    assert abs(w_h.std().item() * np.sqrt(w_h.shape[0]) - 1.0) < 0.1
    assert not tparams["gru"]["0"]["b"].any()


def test_make_model_rnn_api_matches_forward():
    _, tcfg = _cfgs(True)
    api = make_model(tcfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    w, y = _windows(4)
    batch = {"windows": torch.from_numpy(w), "targets": torch.from_numpy(y)}
    pred, aux = api.forward(params, batch)
    assert aux.item() == 0.0
    assert torch.equal(pred, gru.forward(params, tcfg.model, batch["windows"]))
    assert torch.equal(api.loss(params, batch),
                       gru.mse_loss(params, tcfg.model, batch["windows"],
                                    batch["targets"]))
    assert api.init_cache(4, 12) is None
    assert torch.equal(api.decode_step(params, batch["windows"], None,
                                       None)[0], pred)


def test_make_model_other_families_wait_for_their_slice():
    """Every family of the JAX registry has its API in the port (the
    ssm, audio and vlm families since the last of the model slices); a
    family the registry does not know raises."""
    from repro_torch.configs import get_config
    for arch, family in (("xlstm-125m", "ssm"), ("whisper-small", "audio"),
                         ("internvl2-76b", "vlm")):
        cfg = get_config(arch).reduced()
        assert cfg.model.family == family
        assert make_model(cfg).init_cache(1, 8, device="cpu") is not None
    _, tcfg = _cfgs(True)
    other = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, family="diffusion"))
    with pytest.raises(ValueError, match="unknown model family"):
        make_model(other)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    _, tcfg = _cfgs(True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gru.init_params(torch.Generator().manual_seed(0), tcfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy_tree({"a": np.zeros(2)})
