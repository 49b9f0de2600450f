"""gemma3-1b and h2o-danube-1.8b on the port against the JAX package on
the same weights, fp32 on the CPU.

gemma3's reduced config has 2 layers, both local, so it cannot show the
5 local : 1 global mix: the cut here has 6 layers (0-4 local with rope
base 10k, 5 global with 1M), QK-norm, GQA 4:1 at head dim 32, and a
window of 8, so the prompts of 13 to 20 tokens wrap the local layers'
dense rings.  Forward, stepwise decode, prefill into per-layer rings and
the paged path match JAX within 1e-4, the two engines give JAX's greedy
tokens, and ``logit_soft_cap`` (which both packages apply in decode
only) matches too.  h2o-danube's reduced config (sliding window 8)
gives both JAX engines' tokens.  The three attention kernels' plain
versions hold at gemma3's head dim 256 against ``repro/kernels/ref.py``
(and the dense decode's soft cap against the JAX model's ``_sdpa``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import make_model, transformer  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)
from repro_torch.serving import PagedServeEngine, ServeEngine  # noqa: E402

#: fp32 end to end; the two frameworks sum products in other orders
TOL = dict(atol=1e-4, rtol=1e-4)
#: plain kernel versions, fp32 (tests/test_kernels.py)
KTOL = dict(atol=3e-5, rtol=3e-5)
GEMMA = "gemma3-1b"
DANUBE = "h2o-danube-1.8b"


def cut(cfg, layers=None, **attention):
    """fp32, window 8, and (gemma3) ``layers`` layers."""
    m = cfg.model
    a = dataclasses.replace(m.attention, window=8, **attention)
    kw = {"num_layers": layers} if layers else {}
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, attention=a, dtype="float32", param_dtype="float32", **kw))


def setup(arch=GEMMA, **attention):
    """(JAX cfg, port cfg, JAX params, numpy params) of the cut."""
    layers = 6 if arch == GEMMA else None
    jcfg = cut(jax_get_config(arch).reduced(), layers, **attention)
    tcfg = cut(get_config(arch).reduced(), layers, **attention)
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def gemma():
    return setup()


def tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def test_cut_has_gemma3s_layer_mix(gemma):
    jcfg, tcfg, _, _ = gemma
    m, jm = tcfg.model, jcfg.model
    assert (m.num_layers, m.attention.head_dim, m.attention.num_heads,
            m.attention.num_kv_heads, m.attention.qk_norm) == \
        (6, 32, 4, 1, True)
    assert [transformer.layer_is_global(m, i) for i in range(6)] == \
        [False] * 5 + [True]
    for i in range(6):
        assert transformer.layer_window(m, i) == jtf.layer_window(jm, i)
        assert transformer.layer_theta(m, i) == jtf.layer_theta(jm, i)
        for max_len in (4, 32):
            assert transformer.cache_capacity(m, i, max_len) == \
                jtf.cache_capacity(jm, i, max_len)
        assert_allclose(transformer._inv_freq(m, "cpu", i).numpy(),
                        np.asarray(jtf.stacked_rope(jm, [i])[0]),
                        atol=0, rtol=0)
    assert transformer.layer_theta(m, 0) == 1e4
    assert transformer.layer_theta(m, 5) == 1e6
    assert not transformer._uniform_cache_geometry(m)
    # full width: 26 layers, every sixth global
    full = get_config(GEMMA).model
    assert [i for i in range(26) if transformer.layer_is_global(full, i)] \
        == [5, 11, 17, 23]


def test_init_params_has_the_jax_tree(gemma):
    _, tcfg, params, _ = gemma
    got = make_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                       "cpu")
    want = [(p, tuple(x.shape)) for p, x in
            flatten_with_path(jax.tree.map(np.asarray, params))]
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(got)] == want
    assert bool((got["layers"]["attn"]["q_norm"] == 1).all())
    assert tuple(got["layers"]["attn"]["k_norm"].shape) == (6, 32)


@pytest.mark.parametrize("B,S", [(1, 8), (2, 20)])
def test_forward_matches_jax(gemma, B, S):
    jcfg, tcfg, params, npp = gemma
    tok = tokens(B, S, tcfg.model.vocab_size)
    want, _ = jtf.forward(params, jcfg.model, jnp.asarray(tok))
    got, _ = transformer.forward(from_numpy_tree(npp, "cpu"), tcfg.model,
                                 torch.as_tensor(tok))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _same_cache(tc, jc):
    """Every per-layer ring equal to JAX's (its scalar index per row)."""
    j = jax.tree.map(np.asarray, jc)["layers"]
    assert isinstance(tc["layers"], dict) and sorted(tc["layers"]) == \
        sorted(j)
    for key, t in tc["layers"].items():
        assert_allclose(t.k.numpy(), j[key].k, **TOL)
        assert_allclose(t.v.numpy(), j[key].v, **TOL)
        np.testing.assert_array_equal(t.pos.numpy(), j[key].pos)
        np.testing.assert_array_equal(
            t.index.numpy(), np.broadcast_to(j[key].index, t.index.shape))


def test_stepwise_decode_matches_jax(gemma):
    """20 tokens fed one by one into per-layer rings (8 slots on the local
    layers, which wrap, 32 on the global one): logits and caches."""
    jcfg, tcfg, params, npp = gemma
    tp = from_numpy_tree(npp, "cpu")
    tok = tokens(2, 20, tcfg.model.vocab_size)
    jc = jtf.init_cache(jcfg.model, 2, 32)
    tc = transformer.init_cache(tcfg.model, 2, 32, device="cpu")
    assert [tc["layers"][str(i)].capacity for i in range(6)] == \
        [8] * 5 + [32]
    for t in range(20):
        jl, jc = jtf.decode_step(params, jcfg.model,
                                 jnp.asarray(tok[:, t:t + 1]), jnp.int32(t),
                                 jc)
        tl, tc = transformer.decode_step(tp, tcfg.model,
                                         torch.as_tensor(tok[:, t:t + 1]),
                                         torch.tensor(t), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(tc, jc)


@pytest.mark.parametrize("length", [13, 16])
def test_prefill_then_decode_matches_jax(gemma, length):
    """A right-padded 16-token bucket prefilled into the per-layer rings
    (the local ones keep the last 8 positions), then 6 decode steps."""
    jcfg, tcfg, params, npp = gemma
    tp = from_numpy_tree(npp, "cpu")
    tok = tokens(2, 16, tcfg.model.vocab_size)
    tok[:, length:] = 0
    jc = jtf.init_cache(jcfg.model, 2, 32)
    tc = transformer.init_cache(tcfg.model, 2, 32, device="cpu")
    jl, jc = jtf.prefill(params, jcfg.model, jnp.asarray(tok), jc,
                         length=length)
    tl, tc = transformer.prefill(tp, tcfg.model, torch.as_tensor(tok), tc,
                                 length=length)
    assert_allclose(tl[:, :length].numpy(), np.asarray(jl)[:, :length], **TOL)
    _same_cache(tc, jc)
    nxt = np.array(jnp.argmax(jl[:, length - 1], -1))
    for step in range(6):
        pos = length + step
        jl, jc = jtf.decode_step(params, jcfg.model, jnp.asarray(nxt[:, None]),
                                 jnp.int32(pos), jc)
        tl, tc = transformer.decode_step(tp, tcfg.model,
                                         torch.as_tensor(nxt[:, None]),
                                         torch.tensor(pos), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
    _same_cache(tc, jc)


def _paged_run(jcfg, tcfg, params, npp, steps=6):
    """Paged prefill of a 20-token bucket (length 18) through scattered
    4-token pages, then ``steps`` paged decode steps: the logits of each
    package, step by step."""
    tp = from_numpy_tree(npp, "cpu")
    B, S, length, ps, pseq, num_pages = 2, 20, 18, 4, 7, 17
    tok = tokens(B, S, tcfg.model.vocab_size)
    tok[:, length:] = 0
    bt = np.random.default_rng(3).permutation(num_pages)[:B * pseq] \
        .reshape(B, pseq).astype(np.int32)
    jc = jtf.init_paged_cache(jcfg.model, num_pages, ps)
    tc = transformer.init_paged_cache(tcfg.model, num_pages, ps,
                                      device="cpu")
    jl, jc = jtf.paged_prefill(params, jcfg.model, jnp.asarray(tok), jc,
                               jnp.asarray(bt), length=length)
    tl, tc = transformer.paged_prefill(tp, tcfg.model, torch.as_tensor(tok),
                                       tc, torch.as_tensor(bt), length=length)
    out = [(tl[:, :length].numpy(), np.asarray(jl)[:, :length])]
    nxt = np.array(jnp.argmax(jl[:, length - 1], -1))
    pos = np.full((B,), length, np.int32)
    for _ in range(steps):
        jl, jc = jtf.paged_decode_step(params, jcfg.model,
                                       jnp.asarray(nxt[:, None]),
                                       jnp.asarray(pos), jc, jnp.asarray(bt))
        tl, tc = transformer.paged_decode_step(
            tp, tcfg.model, torch.as_tensor(nxt[:, None]),
            torch.as_tensor(pos), tc, torch.as_tensor(bt))
        out.append((tl.numpy(), np.asarray(jl)))
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
        pos = pos + 1
    return out


def test_paged_prefill_and_decode_match_jax(gemma):
    """The paged cache is uniform; the local layers' window is a mask."""
    for got, want in _paged_run(*gemma):
        assert_allclose(got, want, **TOL)


def _engines(tcfg, npp, rows=3, max_len=32):
    return (ServeEngine(tcfg, npp, batch_size=rows, max_len=max_len,
                        device="cpu"),
            PagedServeEngine(tcfg, npp, max_seqs=rows, page_size=4,
                             max_len=max_len, device="cpu"))


def _jax_engines(jcfg, params, rows=3, max_len=32):
    return (jeng.ServeEngine(jcfg, params, batch_size=rows, max_len=max_len),
            jeng.PagedServeEngine(jcfg, params, max_seqs=rows, page_size=4,
                                  max_len=max_len))


@pytest.mark.parametrize("B,S", [(2, 13), (3, 20)])
def test_engines_match_the_jax_engines(gemma, B, S):
    jcfg, tcfg, params, npp = gemma
    p = tokens(B, S, tcfg.model.vocab_size, seed=S)
    want = [np.asarray(e.generate(jnp.asarray(p), 6))
            for e in _jax_engines(jcfg, params)]
    np.testing.assert_array_equal(want[1], want[0])
    for eng in _engines(tcfg, npp):
        got = eng.generate(p, 6)
        assert got.shape == (B, 6)
        np.testing.assert_array_equal(got.numpy(), want[0])


def test_dense_engine_keeps_per_layer_rings_through_measure(gemma):
    """The dense engine's cache is the per-layer dict; ``measure()``
    mid-flight clones and restores it, so the in-flight sequence goes on
    as if uninterrupted."""
    _, tcfg, _, npp = gemma
    eng = _engines(tcfg, npp)[0]
    assert isinstance(eng.cache["layers"], dict)
    prompt = tokens(1, 14, tcfg.model.vocab_size, seed=5)[0]
    expected = eng.generate(prompt[None], 6).numpy()[0]
    slot = eng.acquire_slot()
    toks = [eng.admit(prompt, slot=slot), int(eng.decode()[slot])]
    eng.measure(prompt_len=10, decode_steps=2, occupancy_levels=(1, 2))
    toks += [int(eng.decode()[slot]) for _ in range(4)]
    eng.evict(slot)
    np.testing.assert_array_equal(np.asarray(toks), expected)


def test_soft_cap_applies_in_decode_only(gemma):
    """``logit_soft_cap`` 1.0: forward and prefill are uncapped in both
    packages; stepwise dense decode, paged decode and both engines'
    tokens match JAX's capped decode."""
    jcfg, tcfg, params, npp = setup(logit_soft_cap=1.0)
    tp = from_numpy_tree(npp, "cpu")
    tok = tokens(2, 14, tcfg.model.vocab_size)
    plain = transformer.forward(from_numpy_tree(gemma[3], "cpu"),
                                gemma[1].model, torch.as_tensor(tok))[0]
    capped = transformer.forward(tp, tcfg.model, torch.as_tensor(tok))[0]
    assert torch.equal(plain, capped)
    jc = jtf.init_cache(jcfg.model, 2, 32)
    tc = transformer.init_cache(tcfg.model, 2, 32, device="cpu")
    nc = transformer.init_cache(gemma[1].model, 2, 32, device="cpu")
    differs = 0.0
    for t in range(14):
        x = tok[:, t:t + 1]
        jl, jc = jtf.decode_step(params, jcfg.model, jnp.asarray(x),
                                 jnp.int32(t), jc)
        tl, tc = transformer.decode_step(tp, tcfg.model, torch.as_tensor(x),
                                         torch.tensor(t), tc)
        nl, nc = transformer.decode_step(tp, gemma[1].model,
                                         torch.as_tensor(x), torch.tensor(t),
                                         nc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        differs = max(differs, (tl - nl).abs().max().item())
    assert differs > 1e-3        # the cap changed the decode
    for got, want in _paged_run(jcfg, tcfg, params, npp):
        assert_allclose(got, want, **TOL)
    p = tokens(2, 13, tcfg.model.vocab_size, seed=7)
    want = np.asarray(_jax_engines(jcfg, params)[0].generate(
        jnp.asarray(p), 6))
    for eng in _engines(tcfg, npp):
        np.testing.assert_array_equal(eng.generate(p, 6).numpy(), want)


@pytest.mark.parametrize("S", [13, 20])
def test_h2o_danube_matches_both_jax_engines(S):
    """Reduced h2o-danube (sliding window 8 on every layer, so one
    uniform ring geometry)."""
    jcfg, tcfg, params, npp = setup(DANUBE)
    assert tcfg.model.attention.kind == "swa"
    assert transformer._uniform_cache_geometry(tcfg.model)
    p = tokens(2, S, tcfg.model.vocab_size, seed=S)
    want = [np.asarray(e.generate(jnp.asarray(p), 6))
            for e in _jax_engines(jcfg, params)]
    np.testing.assert_array_equal(want[1], want[0])
    for eng in _engines(tcfg, npp):
        assert not isinstance(eng.cache["layers"], dict)
        np.testing.assert_array_equal(eng.generate(p, 6).numpy(), want[0])


# ---------------------------------------------------------------------------
# the three attention kernels' plain versions at head dim 256
# ---------------------------------------------------------------------------

def _normal(r, *shape):
    return r.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("B,C,n_valid", [(1, 256, 57), (4, 512, 300),
                                         (2, 64, 0)])
def test_decode_plain_matches_jax_at_head_dim_256(B, C, n_valid):
    """gemma3's decode: H 4 on one kv head, D = Dv = 256; a row with no
    valid slot among them at the last shape."""
    r = np.random.default_rng(B)
    q, k, v = _normal(r, B, 4, 256), _normal(r, B, C, 1, 256), \
        _normal(r, B, C, 1, 256)
    valid = np.arange(C)[None, :] < np.full((B, 1), n_valid)
    got = ref.decode_attention_ref(*map(torch.as_tensor, (q, k, v, valid)))
    want = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, valid)))
    assert got.shape == (B, 4, 256)
    assert_allclose(got.numpy(), np.asarray(want), **KTOL)


@pytest.mark.parametrize("soft_cap", [1.0, 30.0])
def test_decode_plain_soft_cap_matches_the_jax_model(soft_cap):
    """The cap the dense kernel now takes, against the JAX model's decode
    attention (``_sdpa`` with ``soft_cap`` over a validity mask)."""
    r = np.random.default_rng(11)
    B, C = 3, 96
    q, k, v = _normal(r, B, 4, 256), _normal(r, B, C, 1, 256), \
        _normal(r, B, C, 1, 256)
    valid = r.uniform(size=(B, C)) < 0.6
    got = ref.decode_attention_ref(*map(torch.as_tensor, (q, k, v, valid)),
                                   soft_cap=soft_cap)
    want = jattn._sdpa(jnp.asarray(q[:, None]), jnp.asarray(k),
                       jnp.asarray(v), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((C,), jnp.int32), causal=False, window=None,
                       soft_cap=soft_cap, k_valid=jnp.asarray(valid))
    assert_allclose(got.numpy(), np.asarray(want)[:, 0], **KTOL)
    uncapped = ref.decode_attention_ref(*map(torch.as_tensor,
                                             (q, k, v, valid)))
    assert (got - uncapped).abs().max() > 1e-3


@pytest.mark.parametrize("window", [None, 512, 20])
@pytest.mark.parametrize("soft_cap", [0.0, 1.0])
def test_paged_plain_matches_jax_at_head_dim_256(window, soft_cap):
    """16-token pages, rows of 600, 37 and 0 tokens."""
    r = np.random.default_rng(5)
    B, ps, Pseq, pool = 3, 16, 40, 50
    q = _normal(r, B, 4, 256)
    kp, vp = _normal(r, pool, ps, 1, 256), _normal(r, pool, ps, 1, 256)
    bt = r.integers(0, pool, (B, Pseq)).astype(np.int32)
    lengths = np.array([600, 37, 0], np.int32)
    kw = dict(soft_cap=soft_cap, window=window)
    got = ref.paged_decode_attention_ref(
        *map(torch.as_tensor, (q, kp, vp, bt, lengths)), **kw)
    want = jref.paged_decode_attention_ref(
        *map(jnp.asarray, (q, kp, vp, bt, lengths)), **kw)
    assert_allclose(got.numpy(), np.asarray(want), **KTOL)


@pytest.mark.parametrize("T,window", [(64, 0), (96, 40), (130, 512)])
def test_flash_plain_matches_jax_at_value_dim_256(T, window):
    """Dv 256 with one kv head read by 4 query heads (the port's GQA
    signature) against the JAX oracle on repeated kv heads."""
    r = np.random.default_rng(T)
    q, k, v = _normal(r, 4, T, 256), _normal(r, 1, T, 256), \
        _normal(r, 1, T, 256)
    got = ref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                  window=window)
    want = jref.flash_attention_ref(jnp.asarray(q),
                                    jnp.asarray(np.repeat(k, 4, 0)),
                                    jnp.asarray(np.repeat(v, 4, 0)),
                                    window=window)
    assert_allclose(got.numpy(), np.asarray(want), **KTOL)
