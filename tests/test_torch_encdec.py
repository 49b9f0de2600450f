"""The port's whisper encoder-decoder (``repro_torch.models.encdec``), its
cross attention and sinusoidal positions, and the flash kernel's plain
version over a key length of its own, against the JAX package on the
same weights and inputs: the reduced whisper-small (2 encoder and 2
decoder layers, d 256, 4 heads on 2 kv heads of dim 32, 16 frames) in
fp32.

Weights: JAX's init with ``wq`` and ``wk`` rescaled from its fan-in over
the heads (std 1/sqrt(H), 0.5 here) to a fan-in over d_model, so that
attention scores are O(1) as in a trained model.  At JAX's own scale the
scores reach the hundreds and the softmax over 16 frames turns
ill-conditioned: both fp32 forwards are then ~5e-4 from an fp64 forward
of the same weights, and one case shows the port as near to it as JAX.

Tolerances: fp32 on both sides, 3e-5 (``tests/test_kernels.py``); the
port's own decode against its forward 2e-3
(``tests/test_decode_consistency.py``); greedy tokens identical.  The
dense engine's case pins a fault of the port: the engine read every bare
cache tensor as a NamedTuple of per-layer caches, so whisper's
``cross_k`` / ``cross_v`` could not be served."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models.transformer import \
    sinusoidal_positions as jax_sinusoidal  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec, make_model  # noqa: E402
from repro_torch.models.transformer import sinusoidal_positions  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree, tree_map)
from repro_torch.serving import (PagedServeEngine, ReplicaPool,  # noqa: E402
                                 ServeEngine, lm_tiers, paged_lm_tiers)

ARCH = "whisper-small"
TOL = dict(atol=3e-5, rtol=3e-5)
CONSISTENCY_TOL = dict(atol=2e-3, rtol=2e-3)
S = 10


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


def o1_scores(tree):
    """``wq`` / ``wk`` (..., d, H, hd) rescaled to std 1/sqrt(d)."""
    def f(path, x):
        if path[-1].key in ("wq", "wk"):
            return (x * np.float32(math.sqrt(x.shape[-2] / x.shape[-3]))
                    ).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, numpy params) of the fp32 reduced
    whisper-small, attention rescaled (module docstring)."""
    jcfg = fp32(jax_get_config(ARCH).reduced())
    tcfg = fp32(get_config(ARCH).reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    npp = o1_scores(jax.tree.map(np.array, params))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), npp


def tokens(B, S_, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (B, S_))


def frames(B, F=16, d=256, seed=2):
    return np.random.default_rng(seed).normal(size=(B, F, d)).astype(
        np.float32)


def test_reduced_config_shape(setup):
    m = setup[1].model
    a = m.attention
    assert (m.family, m.num_layers, m.encoder_layers, m.d_model) == \
        ("audio", 2, 2, 256)
    assert m.is_encoder_decoder and m.frontend.num_positions == 16
    assert (a.num_heads, a.num_kv_heads, a.head_dim, a.rope_theta) == \
        (4, 2, 32, 0.0)
    full = get_config(ARCH).model
    assert (full.frontend.num_positions, full.attention.num_heads,
            full.attention.head_dim) == (1500, 12, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_is_the_jax_tree(dtype):
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
    assert got[("decoder", "cross_attn", "wq")][0] == (2, 256, 4, 32)


def test_bf16_tree_carries_over_bit_for_bit():
    params, _ = jax_make_model(jax_get_config(ARCH).reduced()).init_params(
        jax.random.key(3))
    tree = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    leaves = dict(flatten_with_path(tree))
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = leaves.pop(tuple(str(getattr(p, "key", p)) for p in path))
        assert t.dtype == torch.bfloat16 and x.dtype == jnp.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(x).view(np.int16))
    assert not leaves


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_positions_match_jax(offset):
    """Sines then cosines (not interleaved), base 10000 ** (2k/d)."""
    got = sinusoidal_positions(16, 256, offset)
    want = np.asarray(jax_sinusoidal(16, 256, offset=offset))
    assert got.shape == (16, 256) and got.dtype == torch.float32
    assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    if offset == 0:                     # position 0: sines 0, cosines 1
        np.testing.assert_array_equal(
            got[0].numpy(), np.r_[np.zeros(128), np.ones(128)])


def test_sinusoidal_positions_per_row():
    """(B,) offsets give each row its own positions, as JAX's vmap over
    the paged decode's rows does."""
    pos = np.array([0, 7, 30])
    got = sinusoidal_positions(1, 64, torch.as_tensor(pos))
    want = np.asarray(jax.vmap(lambda p: jax_sinusoidal(1, 64, offset=p))(
        jnp.asarray(pos)))
    assert got.shape == (3, 1, 64)
    assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def _attn_params(npp):
    return jax.tree.map(lambda x: x[0], npp["decoder"]["cross_attn"])


def test_gqa_forward_cross_matches_jax(setup):
    """Keys and values from the encoder output (F 16 rows for S 10
    queries), no rope, no causal mask."""
    jcfg, tcfg, _, npp = setup
    p = _attn_params(npp)
    x = frames(2, F=S, seed=3)
    src = frames(2, seed=4)
    pos = np.arange(S)
    want = jattn.gqa_forward(jax.tree.map(jnp.asarray, p),
                             jcfg.model.attention, jnp.asarray(x),
                             jnp.asarray(pos), None,
                             kv_source=jnp.asarray(src))
    got = attn.gqa_forward(from_numpy_tree(p, "cpu"), tcfg.model.attention,
                           torch.as_tensor(x), torch.as_tensor(pos), None,
                           kv_source=torch.as_tensor(src))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gqa_decode_cross_matches_jax(setup):
    """One query a row over precomputed (B,F,Hkv,D) rows; the ring is
    returned untouched."""
    jcfg, tcfg, _, npp = setup
    a = tcfg.model.attention
    p = _attn_params(npp)
    r = np.random.default_rng(5)
    x = frames(2, F=1, seed=6)
    ck, cv = (r.normal(size=(2, 16, 2, 32)).astype(np.float32)
              for _ in range(2))
    jcache = jattn.init_kv_cache(2, 8, 2, 32, jnp.float32)
    want, _ = jattn.gqa_decode(jax.tree.map(jnp.asarray, p),
                               jcfg.model.attention, jnp.asarray(x),
                               jnp.int32(3), jcache, None,
                               cross_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    cache = attn.init_kv_cache(2, 8, 2, 32, torch.float32)
    before = tree_map(torch.clone, cache)
    got, out_cache = attn.gqa_decode(
        from_numpy_tree(p, "cpu"), a, torch.as_tensor(x), torch.tensor(3),
        cache, None, cross_kv=(torch.as_tensor(ck), torch.as_tensor(cv)))
    assert out_cache is cache
    assert all(torch.equal(u, w) for u, w in zip(cache, before))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax(setup):
    jcfg, tcfg, jp, npp = setup
    f = frames(2)
    want = jed.encode(jp, jcfg.model, jnp.asarray(f))
    got = encdec.encode(from_numpy_tree(npp, "cpu"), tcfg.model,
                        torch.as_tensor(f))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_and_loss_match_jax(setup):
    jcfg, tcfg, jp, npp = setup
    toks, labels, f = tokens(2, S), tokens(2, S, seed=3), frames(2)
    labels[1, :3] = -100
    japi, tapi = jax_make_model(jcfg), make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels), "frames": torch.as_tensor(f)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    logits, aux = tapi.forward(tp, batch)
    want, _ = japi.forward(jp, jbatch)
    assert logits.shape == (2, S, tcfg.model.padded_vocab)
    assert float(aux) == 0.0
    assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert_allclose(float(tapi.loss(tp, batch)),
                    float(japi.loss(jp, jbatch)), **TOL)
    with pytest.raises(ValueError, match="frame"):
        tapi.forward(tp, {"tokens": batch["tokens"]})


def test_forward_at_jax_init_is_as_near_exact_as_jax():
    """At JAX's own init (module docstring) the two fp32 forwards differ
    by up to ~2e-3; the port is no farther from an fp64 forward of the
    same code and weights than JAX is."""
    jcfg = fp32(jax_get_config(ARCH).reduced())
    tcfg = fp32(get_config(ARCH).reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    toks, f = tokens(2, S), frames(2)
    want = np.asarray(jax_make_model(jcfg).forward(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)})[0])
    api = make_model(tcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    got = api.forward(tp, {"tokens": torch.as_tensor(toks),
                           "frames": torch.as_tensor(f)})[0].numpy()
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        exact = api.forward(tree_map(lambda t: t.double(), tp),
                            {"tokens": torch.as_tensor(toks),
                             "frames": torch.as_tensor(f).double()})[0]
    finally:
        torch.Tensor.float = orig
    exact = exact.numpy()
    port_err = np.abs(got - exact).max()
    jax_err = np.abs(want - exact).max()
    assert port_err <= 2 * jax_err + 1e-5
    assert_allclose(got, want, **CONSISTENCY_TOL)


def test_prime_then_decode_matches_jax_and_forward(setup):
    """The cross rows primed from the encoder output, then S decode
    steps from a fresh ring: logits against JAX's at every step, and
    against the port's forward (per-row positions, as the engine passes
    them)."""
    jcfg, tcfg, jp, npp = setup
    toks, f = tokens(2, S, seed=4), frames(2, seed=5)
    tp = from_numpy_tree(npp, "cpu")
    m, jm = tcfg.model, jcfg.model
    enc = encdec.encode(tp, m, torch.as_tensor(f))
    cache = encdec.prime_cross_cache(tp, m, encdec.init_cache(
        m, 2, 16, device="cpu"), enc)
    jcache = jed.prime_cross_cache(jp, jm, jed.init_cache(jm, 2, 16),
                                   jed.encode(jp, jm, jnp.asarray(f)))
    assert_allclose(cache["cross_k"].numpy(), np.asarray(jcache["cross_k"]),
                    **TOL)
    jstep = jax.jit(lambda p, t, s, c: jed.decode_step(p, jm, t, s, c))
    outs = []
    for t in range(S):
        lg, cache = encdec.decode_step(tp, m, torch.as_tensor(
            toks[:, t:t + 1]), torch.full((2,), t), cache)
        want, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t), jcache)
        assert_allclose(lg.numpy(), np.asarray(want), **TOL)
        outs.append(lg[:, 0])
    full, _ = make_model(tcfg).forward(tp, {"tokens": torch.as_tensor(toks),
                                            "frames": torch.as_tensor(f)})
    assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                    **CONSISTENCY_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def jax_greedy(jcfg, jp, prompt, steps):
    """The JAX model's greedy run of one prompt from a fresh batch-1
    cache (zero cross rows), as the JAX engine computes it: (tokens, the
    logits of each decode step after the prompt)."""
    api = jax_make_model(jcfg)
    step = jax.jit(api.decode_step)
    cache = api.init_cache(1, 32)
    for t, tok in enumerate(prompt):
        lg, cache = step(jp, jnp.asarray([[tok]]), jnp.int32(t), cache)
    out, logits = [int(np.argmax(lg[0, -1]))], []
    for t in range(steps - 1):
        lg, cache = step(jp, jnp.asarray([[out[-1]]]),
                         jnp.int32(len(prompt) + t), cache)
        logits.append(np.asarray(lg[0, -1]))
        out.append(int(np.argmax(logits[-1])))
    return np.asarray(out), logits


def test_dense_engine_matches_jax(setup):
    """Recurrent prefill against the zero cross rows of a fresh cache, as
    the JAX engine serves whisper: its tokens, and each slot's logits at
    every decode step against the JAX model's for that prompt alone.  The
    engine finds the batch of the bare cross tensors and of the stacked
    ring on axis 1."""
    jcfg, tcfg, jp, npp = setup
    prompts = tokens(2, 6, seed=6)
    want = np.asarray(jeng.ServeEngine(jcfg, jp, batch_size=2, max_len=32)
                      .generate(jnp.asarray(prompts), 5))
    eng = ServeEngine(tcfg, npp, batch_size=2, max_len=32, device="cpu")
    assert eng._batch_axes[("cross_k",)] == eng._batch_axes[("cross_v",)] \
        == eng._batch_axes[("self", 0)] == 1
    np.testing.assert_array_equal(eng.generate(prompts, 5).numpy(), want)
    inner, sink = eng.api.decode_step, []

    def step(*args, **kw):
        out, cache = inner(*args, **kw)
        if out.shape[0] == 2:            # the engine's batched decode step
            sink.append(out[:, -1].clone())
        return out, cache

    eng.api = eng.api._replace(decode_step=step)
    slots = [eng.acquire_slot(), eng.acquire_slot()]
    for b, slot in enumerate(slots):
        eng.admit(prompts[b, :4 + b], slot=slot)
    for _ in range(4):
        eng.decode()
    for b, slot in enumerate(slots):
        _, logits = jax_greedy(jcfg, jp, prompts[b, :4 + b], 5)
        for got, w in zip(sink, logits):
            assert_allclose(got[slot].numpy(), w, **TOL)


def test_readmitted_slot_matches_a_fresh_engine(setup):
    """A slot reused after another sequence starts from an empty ring
    and zero cross rows, as a fresh batch-1 cache does."""
    _, tcfg, _, npp = setup
    eng = ServeEngine(tcfg, npp, batch_size=2, max_len=32, device="cpu")
    p = tokens(1, 5, seed=8)
    first = eng.generate(p, 4).numpy()
    slot = eng.acquire_slot()
    eng.admit(tokens(1, 9, seed=9)[0], slot=slot)
    eng.cache["cross_k"].normal_()          # stale rows in every slot
    eng.decode()
    eng.evict(slot)
    np.testing.assert_array_equal(eng.generate(p, 4).numpy(), first)


def test_paged_engine_refuses_whisper(setup):
    jcfg, tcfg, jp, npp = setup
    with pytest.raises(ValueError, match="paged"):
        PagedServeEngine(tcfg, npp, max_seqs=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        jeng.PagedServeEngine(jcfg, jp, max_seqs=2)
    with pytest.raises(ValueError, match="paged"):
        ReplicaPool(paged_lm_tiers(ARCH), device="cpu").engine("device")
    assert make_model(tcfg).prefill is None


def test_lm_tiers_serve_whisper(setup):
    _, _, _, npp = setup
    pool = ReplicaPool(lm_tiers(ARCH, max_len=32), shared_params=npp,
                       device="cpu")
    out = pool.dispatch("edge", tokens(3, 5), steps=3)
    assert out.shape == (3, 3)
    assert bool(((out >= 0) & (out < 1024)).all())


def test_cpu_path_launches_no_kernel(setup):
    _, tcfg, _, npp = setup
    ops.reset_launches()
    make_model(tcfg).forward(from_numpy_tree(npp, "cpu"),
                             {"tokens": torch.as_tensor(tokens(1, 4)),
                              "frames": torch.as_tensor(frames(1))})
    ServeEngine(tcfg, npp, batch_size=1, max_len=16,
                device="cpu").generate(tokens(1, 3), 2)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the flash kernel's plain version over a key length of its own
# ---------------------------------------------------------------------------

def _qkv(BH, BHkv, T, Tk, D, Dv, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.as_tensor(r.normal(size=s), dtype=torch.float32)
                 for s in ((BH, T, D), (BHkv, Tk, D), (BHkv, Tk, Dv)))


@pytest.mark.parametrize("BH,BHkv,T,Tk,window", [(4, 4, 16, 100, 0),
                                                 (4, 2, 1, 77, 0),
                                                 (2, 1, 64, 150, 20),
                                                 (3, 3, 40, 8, 0)])
def test_flash_plain_with_own_key_length_is_a_softmax(BH, BHkv, T, Tk,
                                                      window):
    """Tk != T without the causal mask (cross attention): each query row
    is a softmax over all Tk keys (those within the window of d = q - k
    when one is given), each query head reading kv head bh // G."""
    q, k, v = _qkv(BH, BHkv, T, Tk, 8, 6)
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    assert got.shape == (BH, T, 6)
    G = BH // BHkv
    kk, vv = k.repeat_interleave(G, 0).double(), v.repeat_interleave(
        G, 0).double()
    s = q.double() @ kk.transpose(1, 2) / math.sqrt(8)
    if window:
        d = np.arange(T)[:, None] - np.arange(Tk)[None, :]
        s = s.masked_fill(torch.as_tensor(d >= window)[None], -math.inf)
    want = torch.softmax(s, -1) @ vv
    assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_flash_plain_at_one_length_is_still_the_jax_oracle(causal, window):
    q, k, v = _qkv(2, 2, 24, 24, 16, 16, seed=1)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                      v.numpy())),
                                    causal=causal, window=window)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Tk", [8, 0])
def test_flash_with_own_key_length_needs_no_causal_mask(Tk):
    q, k, v = _qkv(2, 2, 12, Tk, 8, 8)
    with pytest.raises(ValueError, match="causal=False"):
        ops.flash_attention(q, k, v, causal=True)
    if Tk == 0:
        with pytest.raises(ValueError, match="at least one key"):
            ops.flash_attention(q, k, v, causal=False)
