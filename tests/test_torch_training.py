"""The port's training layer (``repro_torch.training``) against the JAX
package's (``repro.training``), fp32 on the CPU: inputs drawn with numpy
and fed to both, parameters carried over by ``from_numpy_tree``.

- The optimizers over 3 updates on the same gradients: AdamW with fp32
  and bf16 moments and with ``warmup_steps = 1``, SGD with and without
  momentum; and the reference's warm-up, pinned: the first update runs
  at ``2 / warmup_steps`` of ``lr``.
- ``make_train_step`` at ``microbatches`` 1 and 2 and ``make_eval_step``,
  one case per family at reduced size (dense gemma3, moe deepseek,
  hybrid zamba2, ssm xlstm, audio whisper, vlm internvl2), with SGD,
  whose update ``-lr * g`` shows every gradient.
- ``make_hfl_train_step`` at 2 clusters against ``jax.vmap`` of the
  reference's step, with AdamW and with SGD.

Tolerances: losses 3e-5 relative.  A parameter *update* (new - old)
within 1e-3 of the larger of the step's learning rate and the leaf's
largest update: AdamW's first update is ``lr * g / (|g| + eps)``, of
size ``lr`` whatever the gradient, and SGD's is ``lr * g``.  AdamW turns
a gradient's sign into a whole step: where a gradient is no larger than
the two frameworks' fp32 disagreement (which stays within 1e-3 of its
leaf's largest gradient) its update is the sign of rounding noise in
either package.  So the AdamW step compares updates where the two
gradients agree within 1e-3 of themselves (more than half of every
leaf), and bounds them by the step size elsewhere; SGD shows every
gradient and is compared everywhere."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.fl.collectives import stack_for_clusters as jax_stack  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fl.collectives import (cluster_slice,  # noqa: E402
                                        stack_for_clusters)
from repro_torch.models import make_model  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)
from repro_torch.training import (SGD, AdamW, init_hfl_opt_state,  # noqa: E402
                                  make_eval_step, make_hfl_train_step,
                                  make_train_step)
from repro_torch.training.train_step import value_and_grad  # noqa: E402

LOSS_RTOL = 3e-5
UPDATE_TOL = 1e-3
#: fp32 state / parameters, and bf16, against the reference
F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
#: the two packages' fp32 gradients agree within this share of their
#: leaf's largest gradient (module docstring)
GRAD_FLOOR = 1e-3
FAMILIES = {"dense": "gemma3-1b", "moe": "deepseek-v2-lite-16b",
            "hybrid": "zamba2-1.2b", "ssm": "xlstm-125m",
            "audio": "whisper-small", "vlm": "internvl2-76b"}
B, S = 4, 8


def np_leaves(tree):
    return [(p, np.asarray(x.detach().float().cpu().numpy()
                           if torch.is_tensor(x) else x, np.float32))
            for p, x in flatten_with_path(tree)]


def jax_np(tree):
    """A JAX tree -> numpy float32 leaves (bf16 upcast)."""
    return np_leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def opt_tree(seed=0):
    """Parameters with fp32 and bf16 leaves, and 3 gradient draws."""
    r = np.random.default_rng(seed)
    params = {"w": r.normal(size=(6, 5)).astype(np.float32),
              "b": {"v": r.normal(size=(7,)).astype(np.float32)},
              "h": r.normal(size=(4, 3)).astype(jnp.bfloat16)}
    grads = [{"w": r.normal(size=(6, 5)).astype(np.float32),
              "b": {"v": r.normal(size=(7,)).astype(np.float32) * 1e-3},
              "h": r.normal(size=(4, 3)).astype(jnp.bfloat16)}
             for _ in range(3)]
    return params, grads


def run_both(jax_opt, port_opt, params, grads):
    """3 updates on both packages; returns their (params, state)."""
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init(jp)
    tp = from_numpy_tree(params, "cpu")
    ts = port_opt.init(tp)
    for g in grads:
        jp, js = jax_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = port_opt.update(from_numpy_tree(g, "cpu"), ts, tp)
    return (jp, js), (tp, ts)


def assert_updates_close(got_new, want_new, old, lr, mask=None):
    """Updates (new - old) within ``UPDATE_TOL`` of max(lr, the leaf's
    largest update); where ``mask`` (path -> bool array) is False, only
    bounded by the step size."""
    for (p, g), (_, w), (_, o) in zip(np_leaves(got_new), jax_np(want_new),
                                      np_leaves(old)):
        du, dw = g - o, w - o
        tol = UPDATE_TOL * max(lr, float(np.abs(dw).max()))
        m = np.ones(dw.shape, bool) if mask is None else mask[p]
        assert np.abs(du - dw)[m].max(initial=0.0) <= tol, p
        assert m.mean() > 0.5, p
        # elsewhere: no more than a step (AdamW: lr (1 + wd |p|))
        bound = lr * (1 + 0.01 * np.abs(o)) * (1 + 1e-3) + tol
        assert (np.abs(du)[~m] <= bound[~m]).all(), p


@pytest.mark.parametrize("case", ["fp32_state", "bf16_state", "warmup_1"])
def test_adamw_matches_jax(case):
    params, grads = opt_tree()
    kw = dict(lr=1e-2, weight_decay=0.1)
    if case == "bf16_state":
        kw["state_dtype"] = "bfloat16"
    if case == "warmup_1":
        kw["warmup_steps"] = 1
    (jp, js), (tp, ts) = run_both(jopt.AdamW(**kw), AdamW(**kw), params,
                                  grads)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    lr = AdamW(**kw)._sched(torch.tensor(3)).item()
    assert_updates_close(tp, jp, params, lr)
    state_tol = BF16 if case == "bf16_state" else F32
    for got, want in ((ts.m, js.m), (ts.v, js.v)):
        for (p, g), (_, w) in zip(np_leaves(got), jax_np(want)):
            assert_allclose(g, w, **state_tol, err_msg=str(p))
        assert {str(x.dtype) for _, x in flatten_with_path(got)} == \
            {"torch." + kw.get("state_dtype", "float32")}
    # parameters keep their dtypes
    assert tp["h"].dtype == torch.bfloat16 and tp["w"].dtype == torch.float32


def test_adamw_first_update_runs_at_two_over_warmup():
    """``update`` increments ``step`` before ``_sched(step)``, which uses
    ``(step + 1) / warmup_steps``: the first update's rate is 2/warmup of
    ``lr`` (the reference's quirk, kept)."""
    lr, warm = 1e-2, 100
    opt = AdamW(lr=lr, warmup_steps=warm, weight_decay=0.0)
    assert opt._sched(torch.tensor(1, dtype=torch.int32)).item() == \
        pytest.approx(lr * 2 / warm, rel=1e-6)
    assert opt._sched(torch.tensor(99)).item() == pytest.approx(lr)
    assert opt._sched(torch.tensor(500)).item() == pytest.approx(lr)
    params, grads = opt_tree()
    p0 = from_numpy_tree({"w": params["w"]}, "cpu")
    g = from_numpy_tree({"w": grads[0]["w"]}, "cpu")
    p1, _ = opt.update(g, opt.init(p0), p0)
    want = -lr * 2 / warm * g["w"] / (g["w"].abs() + opt.eps)
    # p1 - p0 carries p1's rounding: half an fp32 ulp of |p| < 4
    ulp = 2.4e-7
    torch.testing.assert_close(p1["w"] - p0["w"], want, atol=ulp, rtol=0)
    jp1, _ = jopt.AdamW(lr=lr, warmup_steps=warm, weight_decay=0.0).update(
        {"w": jnp.asarray(grads[0]["w"])},
        jopt.AdamW().init({"w": jnp.asarray(params["w"])}),
        {"w": jnp.asarray(params["w"])})
    assert_allclose((p1["w"] - p0["w"]).numpy(),
                    np.asarray(jp1["w"]) - params["w"], atol=ulp, rtol=0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    params, grads = opt_tree(1)
    (jp, js), (tp, ts) = run_both(jopt.SGD(lr=1e-2, momentum=momentum),
                                  SGD(lr=1e-2, momentum=momentum), params,
                                  grads)
    assert int(ts.step) == int(js.step) == 3
    assert_updates_close(tp, jp, params, 1e-2)
    if momentum:
        for (p, g), (_, w) in zip(np_leaves(ts.momentum),
                                  jax_np(js.momentum)):
            assert_allclose(g, w, **F32, err_msg=str(p))
    else:
        assert ts.momentum is None and js.momentum is None


# ---------------------------------------------------------------------------
# train and eval steps, one case per family
# ---------------------------------------------------------------------------

def fp32(cfg, k=1):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       param_dtype="float32"),
        run=dataclasses.replace(cfg.run, microbatches=k))


def o1_scores(tree):
    """``wq`` / ``wk`` (..., d, H, hd) rescaled to std 1/sqrt(d), as the
    family tests do for whisper and internvl2 (JAX's fan-in over H makes
    their reduced fp32 softmax ill-conditioned)."""
    def f(path, x):
        if path[-1].key in ("wq", "wk"):
            return (x * np.float32(math.sqrt(x.shape[-2] / x.shape[-3]))
                    ).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


_SETUPS = {}


def setup(family):
    """(JAX cfg, port cfg, numpy params) of the fp32 reduced arch."""
    if family not in _SETUPS:
        arch = FAMILIES[family]
        jcfg = fp32(jax_get_config(arch).reduced())
        tcfg = fp32(get_config(arch).reduced())
        params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
        npp = jax.tree.map(np.array, params)
        if family in ("audio", "vlm"):
            npp = o1_scores(npp)
        _SETUPS[family] = (jcfg, tcfg, npp)
    return _SETUPS[family]


def lm_batch(m, lead=(), seed=1):
    r = np.random.default_rng(seed)
    shape = lead + (B, S)
    batch = {"tokens": r.integers(0, m.vocab_size, shape).astype(np.int32),
             "labels": r.integers(0, m.vocab_size, shape).astype(np.int32)}
    P = m.frontend.num_positions
    if m.family == "vlm":
        batch["patches"] = r.normal(size=lead + (B, P, m.d_model)
                                    ).astype(np.float32)
    if m.family == "audio":
        batch["frames"] = r.normal(size=lead + (B, P, m.d_model)
                                   ).astype(np.float32)
    return batch


def with_k(cfg, k):
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                            microbatches=k))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family, k):
    jcfg, tcfg, npp = setup(family)
    jcfg, tcfg = with_k(jcfg, k), with_k(tcfg, k)
    batch = lm_batch(tcfg.model)
    lr = 1e-3
    jstep = jax.jit(jts.make_train_step(jax_make_model(jcfg), jcfg,
                                        jopt.SGD(lr=lr)))
    jp = jax.tree.map(jnp.asarray, npp)
    jnew, jstate, jloss = jstep(jp, jopt.SGD(lr=lr).init(jp),
                                jax.tree.map(jnp.asarray, batch))
    opt = SGD(lr=lr)
    tp = from_numpy_tree(npp, "cpu")
    tnew, tstate, tloss = make_train_step(make_model(tcfg), tcfg, opt)(
        tp, opt.init(tp), from_numpy_tree(batch, "cpu"))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert int(tstate.step) == int(jstate.step) == 1
    assert_updates_close(tnew, jnew, npp, lr)
    # the inputs are left as they were
    for (p, x), (_, w) in zip(np_leaves(tp), np_leaves(npp)):
        assert np.array_equal(x, w), p


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_step_matches_jax(family):
    jcfg, tcfg, npp = setup(family)
    batch = lm_batch(tcfg.model, seed=2)
    want = jax.jit(jts.make_eval_step(jax_make_model(jcfg)))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    got = make_eval_step(make_model(tcfg))(from_numpy_tree(npp, "cpu"),
                                           from_numpy_tree(batch, "cpu"))
    assert not got.requires_grad
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


def test_microbatches_sum_grads_in_the_parameters_dtype():
    """k = 2 on bf16 parameters: the gradient sum is bf16, as the
    reference's ``zeros_like(params)`` carry; loss = mean of the two."""
    cfg = with_k(get_config("gemma3-1b").reduced(), 2)
    api = make_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = from_numpy_tree(lm_batch(cfg.model), "cpu")
    seen = []

    class Probe:
        def update(self, grads, state, params):
            seen.append(grads)
            return params, state

    _, _, loss = make_train_step(api, cfg, Probe())(params, None, batch)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    parts = [value_and_grad(api.loss, params, h) for h in halves]
    assert float(loss) == pytest.approx(
        float((parts[0][0] + parts[1][0]) / 2), rel=1e-6)
    for (p, g), (_, a), (_, b) in zip(flatten_with_path(seen[0]),
                                      flatten_with_path(parts[0][1]),
                                      flatten_with_path(parts[1][1])):
        assert g.dtype == torch.bfloat16, p
        assert torch.equal(g, (a + b) / 2), p


# ---------------------------------------------------------------------------
# the hierarchical-FL step against jax.vmap
# ---------------------------------------------------------------------------

def grad_mask(api, stacked, batch, jax_grads):
    """Per leaf, where the two packages' gradients agree within
    ``UPDATE_TOL`` of themselves, so that AdamW's first update must agree
    within ``UPDATE_TOL`` of ``lr`` (module docstring).  Everywhere the
    gradients agree within ``GRAD_FLOOR`` of their leaf's largest."""
    C = len(jax_grads)
    masks = []
    for c in range(C):
        _, g = value_and_grad(api.loss, cluster_slice(stacked, c),
                              {k: v[c] for k, v in batch.items()})
        mask = {}
        for (p, t), (_, j) in zip(np_leaves(g), jax_np(jax_grads[c])):
            diff = np.abs(t - j)
            assert diff.max() <= GRAD_FLOOR * np.abs(j).max(), p
            mask[p] = diff <= UPDATE_TOL * np.abs(j)
        masks.append(mask)
    return masks


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_hfl_train_step_matches_jax_vmap(optimizer):
    jcfg, tcfg, npp = setup("dense")
    C, lr = 2, 1e-3
    jo, to = ((jopt.AdamW(lr=lr, warmup_steps=1), AdamW(lr=lr,
                                                        warmup_steps=1))
              if optimizer == "adamw" else (jopt.SGD(lr=lr), SGD(lr=lr)))
    batch = lm_batch(tcfg.model, lead=(C,))
    jstacked = jax_stack(jax.tree.map(jnp.asarray, npp), C)
    jnew, jstate, jlosses = jax.jit(jts.make_hfl_train_step(
        jax_make_model(jcfg), jcfg, jo))(
        jstacked, jax.vmap(jo.init)(jstacked),
        jax.tree.map(jnp.asarray, batch))

    api = make_model(tcfg)
    stacked = stack_for_clusters(from_numpy_tree(npp, "cpu"), C)
    state = init_hfl_opt_state(to, stacked)
    tbatch = from_numpy_tree(batch, "cpu")
    masks = [None] * C
    if optimizer == "adamw":
        jgrads = jax.jit(jax.vmap(jax.grad(jax_make_model(jcfg).loss)))(
            jstacked, jax.tree.map(jnp.asarray, batch))
        masks = grad_mask(api, stacked, tbatch,
                          [jax.tree.map(lambda x: x[c], jgrads)
                           for c in range(C)])
    out, out_state, losses = make_hfl_train_step(api, tcfg, to)(
        stacked, state, tbatch)
    # written back into the stacked tensors
    assert out is stacked and out_state is state
    assert tuple(losses.shape) == (C,)
    assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=LOSS_RTOL)
    assert state.step.tolist() == np.asarray(jstate.step).tolist() == [1, 1]
    for c in range(C):
        assert_updates_close(cluster_slice(stacked, c),
                             jax.tree.map(lambda x: x[c], jnew), npp, lr,
                             masks[c])
