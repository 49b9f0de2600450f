"""The port's xLSTM (``repro_torch.models.xlstm``) against
``repro.models.xlstm`` and the JAX serving engine on the same weights:
the reduced xlstm-125m (2 layers, d 256, 2 heads, an mLSTM at layer 0
and an sLSTM at layer 1) in fp32, then the LM tiers' default arch.

Tolerances: fp32 on both sides, summed in other orders by the two
frameworks, 3e-5 on logits and loss (``tests/test_kernels.py``'s fp32
tolerance) and on states relative to their largest entry; the port's
own decode against its forward uses the 2e-3 of
``tests/test_decode_consistency.py``; greedy tokens are identical.

The serving cases pin three faults of the port found against the JAX
engine: ``lm_tiers()`` with its default arch raised; an admission reset
its slot's states to 0 where a fresh xLSTM state holds the stabiliser
-1e30; and the engine took the batch of a per-layer state on axis 1."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import replica as jrep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import make_model, xlstm  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)
from repro_torch.serving import (PagedServeEngine, ReplicaPool,  # noqa: E402
                                 ServeEngine, lm_tiers, paged_lm_tiers)

ARCH = "xlstm-125m"
TOL = dict(atol=3e-5, rtol=3e-5)
#: tests/test_decode_consistency.py's sequence length and tolerance
S = 12
CONSISTENCY_TOL = dict(atol=2e-3, rtol=2e-3)


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


def _perturbed(params):
    """JAX's init leaves the biases at 0 (b_f at 1) and the norm scales
    at 1; draw them away so every term of both blocks shows."""
    r = np.random.default_rng(7)
    out = jax.tree.map(np.array, params)
    for path, x in jax.tree_util.tree_flatten_with_path(out)[0]:
        keys = [p.key for p in path]
        name = keys[-1]
        if name.startswith("b_") or name in ("conv_b", "bias"):
            base = 1.0 if name == "b_f" else 0.0
        elif name in ("scale", "out_norm", "ffn_norm"):
            base = 1.0
        else:
            continue
        node = out
        for k in keys[:-1]:
            node = node[k]
        node[name] = (base + r.normal(size=x.shape) * 0.2).astype(x.dtype)
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, numpy params) of the fp32 reduced
    xlstm-125m."""
    jcfg = fp32(jax_get_config(ARCH).reduced())
    tcfg = fp32(get_config(ARCH).reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    npp = _perturbed(params)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), npp


def tokens(B, S_, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (B, S_))


def _block(npp, i):
    return jax.tree.map(jnp.asarray, npp["blocks"][str(i)])


def _tblock(npp, i):
    return from_numpy_tree(npp["blocks"][str(i)], "cpu")


def _hidden(B, S_, d, seed=2):
    return np.random.default_rng(seed).normal(size=(B, S_, d)).astype(
        np.float32)


def test_reduced_config_shape(setup):
    m = setup[1].model
    x = m.xlstm
    assert (m.family, m.num_layers, m.d_model, m.d_ff) == ("ssm", 2, 256, 0)
    assert (x.num_heads, x.slstm_layers, x.conv_width) == (2, (1,), 4)
    assert xlstm._mlstm_dims(m) == (512, 2, 256)
    assert xlstm._slstm_dims(m) == (2, 128)
    # int(768 * 1.333): the published sLSTM FFN's odd width
    assert int(get_config(ARCH).model.d_model
               * m.xlstm.proj_factor_slstm) == 1023


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_is_the_jax_tree(dtype):
    """Same keys, shapes and dtypes as the JAX tree: the gates' w_i, w_f,
    b_i, b_f and the sLSTM biases fp32 in a bf16 model."""
    jcfg = jax_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    if dtype == "float32":
        jcfg, tcfg = fp32(jcfg), fp32(tcfg)
    shapes = jax.eval_shape(
        lambda k: jax_make_model(jcfg).init_params(k)[0], jax.random.key(0))
    want = {tuple(str(getattr(p, "key", p)) for p in path): (x.shape,
                                                              str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tree = make_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu")
    got = {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for path, x in flatten_with_path(tree)}
    assert got == want
    fp32_leaves = {p[-1] for p, (_, dt) in got.items() if dt == "float32"}
    if dtype == "bfloat16":
        assert fp32_leaves == {"w_i", "w_f", "b_i", "b_f", "b_z", "b_o"}
    mb, sb = tree["blocks"]["0"], tree["blocks"]["1"]
    assert torch.equal(mb["b_f"], torch.ones(2))
    assert torch.equal(sb["b_f"], torch.ones(2, 128))


def test_bf16_tree_carries_over_bit_for_bit():
    """``from_numpy_tree`` takes the JAX bf16 tree key for key, its fp32
    gate leaves as they are."""
    jcfg = jax_get_config(ARCH).reduced()
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(3))
    tree = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    leaves = dict(flatten_with_path(tree))
    n32 = 0
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = tuple(str(getattr(p, "key", p)) for p in path)
        t = leaves.pop(key)
        if x.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(x).view(np.int16))
        else:
            n32 += 1
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(x))
    assert not leaves and n32 == 4 + 4


@pytest.mark.parametrize("q_chunk", [2048, 4])
def test_mlstm_parallel_matches_jax(q_chunk):
    """The stabilised parallel form, whole and in query chunks of 4 (T
    16: four chunks, as the reference's scan takes them)."""
    r = np.random.default_rng(2)
    B, T, H, hd = 2, 16, 2, 8
    q, k, v = (r.normal(size=(B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logf = -np.abs(r.normal(size=(B, T, H))).astype(np.float32)
    logi = r.normal(size=(B, T, H)).astype(np.float32)
    args = (q, k, v, logf, logi)
    want = jxl.mlstm_parallel(*map(jnp.asarray, args), q_chunk=q_chunk)
    got = xlstm.mlstm_parallel(*map(torch.as_tensor, args), q_chunk=q_chunk)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_matches_jax(setup, kind):
    jcfg, tcfg, _, npp = setup
    i = 0 if kind == "mlstm" else 1
    x = _hidden(2, 10, 256)
    want = getattr(jxl, f"apply_{kind}")(_block(npp, i), jcfg.model,
                                         jnp.asarray(x))
    got = getattr(xlstm, f"apply_{kind}")(_tblock(npp, i), tcfg.model,
                                          torch.as_tensor(x))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_jax(setup, kind):
    """Five single-token steps from a fresh state: outputs and every
    field of the state (written in place in the port)."""
    jcfg, tcfg, _, npp = setup
    i = 0 if kind == "mlstm" else 1
    jst = getattr(jxl, f"init_{kind}_state")(jcfg.model, 2)
    st = getattr(xlstm, f"init_{kind}_state")(tcfg.model, 2, "cpu")
    jp, tp = _block(npp, i), _tblock(npp, i)
    x = _hidden(2, 5, 256, seed=3)
    for t in range(5):
        want, jst = getattr(jxl, f"{kind}_decode")(
            jp, jcfg.model, jnp.asarray(x[:, t:t + 1]), jst)
        got, st2 = getattr(xlstm, f"{kind}_decode")(
            tp, tcfg.model, torch.as_tensor(x[:, t:t + 1]), st)
        assert st2 is st
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # a state sums products of O(10) projections: fp32 rounding is
        # relative to the state's scale, not to each element
        for name, a, b in zip(st._fields, st, jst):
            b = np.asarray(b, np.float32)
            scale = max(1.0, float(np.abs(b).max()))
            assert_allclose(a.float().numpy() / scale, b / scale, **TOL,
                            err_msg=name)


def test_init_cache_is_the_jax_cache(setup):
    """States fp32 with the stabiliser at -1e30, conv rings in the
    model's dtype, keyed by the layer's index."""
    jcfg, tcfg, _, _ = setup
    for dtype in ("float32", "bfloat16"):
        jm = dataclasses.replace(jcfg.model, dtype=dtype)
        tm = dataclasses.replace(tcfg.model, dtype=dtype)
        want = jxl.init_cache(jm, 3, 16)
        got = xlstm.init_cache(tm, 3, 16, device="cpu")
        assert list(got) == list(want) == ["0", "1"]
        assert isinstance(got["0"], xlstm.MLSTMState)
        assert isinstance(got["1"], xlstm.SLSTMState)
        for k in got:
            for a, b in zip(got[k], want[k]):
                assert tuple(a.shape) == b.shape
                assert str(a.dtype).replace("torch.", "") == str(b.dtype)
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32))
        for k in got:
            assert bool((got[k].m == torch.tensor(-1e30)).all())


def test_forward_and_loss_match_jax(setup):
    jcfg, tcfg, jp, npp = setup
    toks = tokens(2, 24)
    labels = tokens(2, 24, seed=2)
    labels[0, :5] = -100
    japi, tapi = jax_make_model(jcfg), make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    logits, aux = tapi.forward(tp, batch)
    want, _ = japi.forward(jp, jbatch)
    assert logits.shape == (2, 24, tcfg.model.padded_vocab)
    assert float(aux) == 0.0
    assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert_allclose(float(tapi.loss(tp, batch)),
                    float(japi.loss(jp, jbatch)), **TOL)


def test_decode_steps_match_jax_and_forward(setup):
    """Twelve decode steps from a fresh cache: logits against JAX's at
    every step, then against the port's own forward (teacher forced,
    per-row positions as the engine passes them)."""
    jcfg, tcfg, jp, npp = setup
    toks = tokens(2, S, seed=4)
    japi, tapi = jax_make_model(jcfg), make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    cache = tapi.init_cache(2, S, device="cpu")
    jcache = japi.init_cache(2, S)
    jstep = jax.jit(japi.decode_step)
    outs = []
    for t in range(S):
        lg, cache = tapi.decode_step(tp, torch.as_tensor(toks[:, t:t + 1]),
                                     torch.full((2,), t), cache)
        want, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t), jcache)
        assert_allclose(lg.numpy(), np.asarray(want), **TOL)
        outs.append(lg[:, 0])
    full, _ = tapi.forward(tp, {"tokens": torch.as_tensor(toks)})
    assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                    **CONSISTENCY_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def jax_greedy(jcfg, jp, prompt, steps):
    """The JAX model's greedy run of one prompt from a fresh batch-1
    cache, as the JAX engine computes it: the prompt through the decode
    step, then ``steps - 1`` greedy steps.  Returns (tokens, the logits
    of each of those steps)."""
    api = jax_make_model(jcfg)
    step = jax.jit(api.decode_step)
    cache = api.init_cache(1, 64)
    for t, tok in enumerate(prompt):
        lg, cache = step(jp, jnp.asarray([[tok]]), jnp.int32(t), cache)
    out, logits = [int(np.argmax(lg[0, -1]))], []
    for t in range(steps - 1):
        lg, cache = step(jp, jnp.asarray([[out[-1]]]),
                         jnp.int32(len(prompt) + t), cache)
        logits.append(np.asarray(lg[0, -1]))
        out.append(int(np.argmax(logits[-1])))
    return np.asarray(out), logits


def record_decode_logits(eng, sink):
    """Append the last-position logits of each of the engine's decode
    steps to ``sink`` (not those of the admissions, which run the model's
    decode step too)."""
    inner, decode, active = eng.api.decode_step, eng.decode, []

    def step(*args, **kw):
        out, cache = inner(*args, **kw)
        if active:
            sink.append(out[:, -1].clone())
        return out, cache

    def counted_decode():
        active.append(True)
        try:
            return decode()
        finally:
            active.pop()

    eng.api = eng.api._replace(decode_step=step)
    eng.decode = counted_decode


def test_dense_engine_matches_jax(setup):
    """Two prompts of different lengths in two slots: the greedy tokens
    are the JAX engine's, and each slot's logits at every decode step are
    the JAX model's for its prompt alone (the batch of a per-layer state
    is axis 0)."""
    jcfg, tcfg, jp, npp = setup
    prompts = tokens(2, 9, seed=5)
    want = np.asarray(jeng.ServeEngine(jcfg, jp, batch_size=2, max_len=64)
                      .generate(jnp.asarray(prompts), 6))
    eng = ServeEngine(tcfg, npp, batch_size=2, max_len=64, device="cpu")
    assert eng._batch_axes[("0", 0)] == 0
    sink = []
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    record_decode_logits(eng, sink)
    slot_a, slot_b = eng.acquire_slot(), eng.acquire_slot()
    eng.admit(prompts[0], slot=slot_a)
    eng.admit(prompts[1, :5], slot=slot_b)
    for _ in range(5):
        eng.decode()
    for row, slot in ((prompts[0], slot_a), (prompts[1, :5], slot_b)):
        toks, logits = jax_greedy(jcfg, jp, row, 6)
        for got_lg, want_lg in zip(sink, logits):
            assert_allclose(got_lg[slot].numpy(), want_lg, **TOL)
    np.testing.assert_array_equal(
        eng.generate_sequential(prompts, 6).numpy(), want)


def test_readmitted_slot_matches_a_fresh_engine(setup):
    """A slot that served one sequence is reset to the fresh batch-1
    state before the next, stabiliser -1e30 included: the next
    sequence's logits at every step are a fresh engine's and JAX's."""
    jcfg, tcfg, jp, npp = setup
    prompt = tokens(1, 7, seed=6)[0]
    fresh = ServeEngine(tcfg, npp, batch_size=1, max_len=64, device="cpu")
    want_sink = []
    record_decode_logits(fresh, want_sink)
    want = fresh.generate(prompt[None], 5).numpy()
    eng = ServeEngine(tcfg, npp, batch_size=1, max_len=64, device="cpu")
    slot = eng.acquire_slot()
    eng.admit(tokens(1, 11, seed=7)[0], slot=slot)
    for _ in range(3):
        eng.decode()
    eng.evict(slot)
    sink = []
    record_decode_logits(eng, sink)
    np.testing.assert_array_equal(eng.generate(prompt[None], 5).numpy(), want)
    _, jax_logits = jax_greedy(jcfg, jp, prompt, 5)
    assert len(sink) == len(want_sink) == len(jax_logits) == 4
    for a, b, c in zip(sink, want_sink, jax_logits):
        assert torch.equal(a, b)
        assert_allclose(a[0].numpy(), c, **TOL)


def test_paged_engine_refuses_xlstm(setup):
    jcfg, tcfg, jp, npp = setup
    with pytest.raises(ValueError, match="paged"):
        PagedServeEngine(tcfg, npp, max_seqs=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        jeng.PagedServeEngine(jcfg, jp, max_seqs=2)
    with pytest.raises(ValueError, match="paged"):
        ReplicaPool(paged_lm_tiers(ARCH), device="cpu").engine("device")
    api = make_model(tcfg)
    assert api.prefill is None and api.paged_prefill is None


def test_default_lm_tiers_serve_xlstm_as_jax(setup):
    """``lm_tiers()`` with its default arch builds the JAX package's
    tiers, and on one shared weight tree they serve the JAX pool's
    tokens at every tier."""
    _, _, jp, npp = setup
    specs = lm_tiers(max_len=64)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in jrep.lm_tiers(max_len=64)]
    assert {s.arch for s in specs} == {ARCH}
    tpool = ReplicaPool(specs, shared_params=npp, device="cpu")
    jpool = jrep.ReplicaPool(jrep.lm_tiers(max_len=64), shared_params=jp)
    r = np.random.default_rng(8)
    for tier, B in (("device", 1), ("edge", 3), ("cloud", 5)):
        p = r.integers(0, 1024, (B, 6))
        got = tpool.dispatch(tier, p, steps=4)
        assert tpool.engine(tier).cfg.model.family == "ssm"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpool.dispatch(tier, p, steps=4)))
    m = tpool.measure(prompt_len=8, decode_steps=2)
    assert all(mm.prefill_ms > 0 for mm in m.values())


def test_cpu_serving_launches_no_kernel(setup):
    _, tcfg, _, npp = setup
    ops.reset_launches()
    ServeEngine(tcfg, npp, batch_size=1, max_len=32,
                device="cpu").generate(tokens(1, 4), 2)
    assert set(ops.launch_counts().values()) == {0}
