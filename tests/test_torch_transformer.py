"""The port's dense transformer against ``repro.models.transformer`` on
the same weights: reduced stablelm-1.6b at fp32 (2 layers, d 256, heads
4/2, head_dim 32, 8 rotated dims), forward, one-shot prefill into the
dense ring cache and the paged cache, and decode steps after it.  On the
CPU the attention is the plain ``_sdpa``; the kernel calls it makes on
the card are held against ``_sdpa`` here through the wrappers' plain
versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import make_model, transformer  # noqa: E402
from repro_torch.models.rope import apply_rope, rope_frequencies  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)

#: fp32 end to end; the two frameworks sum products in other orders
TOL = dict(atol=1e-4, rtol=1e-4)


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


def jax_setup(seed=0):
    """Reduced fp32 stablelm: (JAX cfg, port cfg, JAX params, numpy
    params)."""
    jcfg = fp32(jax_get_config("stablelm-1.6b").reduced())
    tcfg = fp32(get_config("stablelm-1.6b").reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(seed))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def test_reduced_config_is_the_papers_shape():
    _, tcfg, _, _ = jax_setup()
    m = tcfg.model
    a = m.attention
    assert (m.num_layers, m.d_model, a.num_heads, a.num_kv_heads,
            a.head_dim) == (2, 256, 4, 2, 32)
    assert 2 * len(rope_frequencies(a.head_dim, a.rope_theta,
                                    a.rope_fraction)) == 8


def test_init_params_has_the_jax_tree():
    jcfg, tcfg, params, _ = jax_setup()
    got = make_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                       "cpu")
    want = [(p, tuple(x.shape)) for p, x in
            flatten_with_path(jax.tree.map(np.asarray, params))]
    assert [(p, tuple(x.shape)) for p, x in flatten_with_path(got)] == want
    assert all(x.dtype == torch.float32 for _, x in flatten_with_path(got))
    # the fan-in statistics of ParamBuilder, per layer of a stacked leaf
    wq = got["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - 4 ** -0.5) < 0.02
    assert abs(got["embed"]["table"].std().item() - 0.02) < 0.002


@pytest.mark.parametrize("B,S", [(1, 8), (2, 13)])
def test_forward_matches_jax(B, S):
    jcfg, tcfg, params, npp = jax_setup()
    tok = tokens(B, S, tcfg.model.vocab_size)
    want, _ = jtf.forward(params, jcfg.model, jnp.asarray(tok))
    got, aux = transformer.forward(from_numpy_tree(npp, "cpu"), tcfg.model,
                                   torch.as_tensor(tok))
    assert got.shape == (B, S, tcfg.model.padded_vocab)
    assert aux.item() == 0.0
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_matches_jax():
    jcfg, tcfg, params, npp = jax_setup()
    tok = tokens(2, 9, tcfg.model.vocab_size)
    labels = tokens(2, 9, tcfg.model.vocab_size, seed=2)
    labels[0, :3] = -100
    jl = jax_make_model(jcfg).loss(params, {"tokens": jnp.asarray(tok),
                                            "labels": jnp.asarray(labels)})
    tl = make_model(tcfg).loss(from_numpy_tree(npp, "cpu"),
                               {"tokens": torch.as_tensor(tok),
                                "labels": torch.as_tensor(labels)})
    assert_allclose(tl.item(), float(jl), **TOL)


def _jax_cache_np(cache):
    return jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("length", [5, 8])
def test_prefill_and_decode_match_jax(length):
    """Right-padded prefill (bucket 8, ``length`` <= 8) into a 32-slot
    ring, then 6 decode steps, logits and cache at every step."""
    jcfg, tcfg, params, npp = jax_setup()
    tp = from_numpy_tree(npp, "cpu")
    B, S, cap = 2, 8, 32
    tok = tokens(B, S, tcfg.model.vocab_size)
    tok[:, length:] = 0
    jc = jtf.init_cache(jcfg.model, B, cap)
    tc = transformer.init_cache(tcfg.model, B, cap, device="cpu")
    jl, jc = jtf.prefill(params, jcfg.model, jnp.asarray(tok), jc,
                         length=length)
    tl, tc = transformer.prefill(tp, tcfg.model, torch.as_tensor(tok), tc,
                                 length=length)
    assert_allclose(tl[:, :length].numpy(), np.asarray(jl)[:, :length], **TOL)

    def same_cache():
        j = _jax_cache_np(jc)["layers"]
        t = tc["layers"]
        assert_allclose(t.k.numpy(), j.k, **TOL)
        assert_allclose(t.v.numpy(), j.v, **TOL)
        np.testing.assert_array_equal(t.pos.numpy(), j.pos)
        np.testing.assert_array_equal(
            t.index.numpy(), np.broadcast_to(j.index[:, None], (2, B)))

    same_cache()
    nxt = np.array(jnp.argmax(jl[:, length - 1], -1))
    for step in range(6):
        pos = length + step
        jl, jc = jtf.decode_step(params, jcfg.model,
                                 jnp.asarray(nxt[:, None]), jnp.int32(pos), jc)
        tl, tc = transformer.decode_step(tp, tcfg.model,
                                         torch.as_tensor(nxt[:, None]),
                                         torch.tensor(pos), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        same_cache()
        nxt = np.array(jnp.argmax(jl[:, -1], -1))


def test_decode_step_takes_per_row_positions():
    """The batched step of the dense engine: rows at different positions
    give what each row gives alone at its own position."""
    _, tcfg, _, npp = jax_setup()
    tp = from_numpy_tree(npp, "cpu")
    m = tcfg.model
    lens = [3, 7]
    cache = transformer.init_cache(m, 2, 16, device="cpu")
    solo = []
    for b, n in enumerate(lens):
        tok = torch.as_tensor(tokens(1, 8, m.vocab_size, seed=b))
        row = transformer.init_cache(m, 1, 16, device="cpu")
        transformer.prefill(tp, m, tok, row, length=n)
        for dst, src in zip(cache["layers"], row["layers"]):
            dst[:, b:b + 1] = src
        solo.append(transformer.decode_step(tp, m, torch.tensor([[5]]),
                                            torch.tensor(n), row)[0])
    out, _ = transformer.decode_step(tp, m, torch.tensor([[5], [5]]),
                                     torch.tensor(lens), cache)
    assert_allclose(out.numpy(), torch.cat(solo).numpy(), atol=1e-5,
                    rtol=1e-5)


def _scattered_table(B, pages_per_seq, num_pages, seed=3):
    ids = np.random.default_rng(seed).permutation(num_pages)
    return ids[:B * pages_per_seq].reshape(B, pages_per_seq).astype(np.int32)


def test_paged_prefill_and_decode_match_jax():
    jcfg, tcfg, params, npp = jax_setup()
    tp = from_numpy_tree(npp, "cpu")
    B, S, length, ps, pseq, num_pages = 2, 16, 11, 4, 5, 13
    tok = tokens(B, S, tcfg.model.vocab_size)
    tok[:, length:] = 0
    bt = _scattered_table(B, pseq, num_pages)
    jc = jtf.init_paged_cache(jcfg.model, num_pages, ps)
    tc = transformer.init_paged_cache(tcfg.model, num_pages, ps,
                                      device="cpu")
    jl, jc = jtf.paged_prefill(params, jcfg.model, jnp.asarray(tok), jc,
                               jnp.asarray(bt), length=length)
    tl, tc = transformer.paged_prefill(tp, tcfg.model, torch.as_tensor(tok),
                                       tc, torch.as_tensor(bt), length=length)
    assert_allclose(tl[:, :length].numpy(), np.asarray(jl)[:, :length], **TOL)
    nxt = np.array(jnp.argmax(jl[:, length - 1], -1))
    pos = np.full((B,), length, np.int32)
    for _ in range(6):
        jl, jc = jtf.paged_decode_step(params, jcfg.model,
                                       jnp.asarray(nxt[:, None]),
                                       jnp.asarray(pos), jc, jnp.asarray(bt))
        tl, tc = transformer.paged_decode_step(
            tp, tcfg.model, torch.as_tensor(nxt[:, None]),
            torch.as_tensor(pos), tc, torch.as_tensor(bt))
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        j = _jax_cache_np(jc)["layers"]
        assert_allclose(tc["layers"].k_pages.numpy(), j.k_pages, **TOL)
        assert_allclose(tc["layers"].v_pages.numpy(), j.v_pages, **TOL)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
        pos = pos + 1


def _qkv(B, S, H, Hkv, D, seed=4):
    r = np.random.default_rng(seed)
    return (torch.as_tensor(r.normal(size=(B, S, h, D)), dtype=torch.float32)
            for h in (H, Hkv, Hkv))


@pytest.mark.parametrize("S,window", [(13, None), (13, transformer.FULL_WINDOW),
                                      (40, 6)])
def test_flash_call_matches_plain_sdpa(S, window):
    """The kernel path's head folding (query head h of row b at b*H + h,
    its kv head at (b*H + h) // G), through the wrapper's plain version."""
    q, k, v = _qkv(2, S, 4, 2, 32)
    pos = torch.arange(S)
    got = attn._flash(q, k, v, True, window)
    want = attn._sdpa(q, k, v, pos, pos, True, window, 0.0)
    assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=3e-5)


def test_rope_rotates_half_split_pairs():
    """Dim i pairs with dim i + rot/2 of the rotated dims, and dims past
    rot pass through, as in repro/models/rope.py."""
    from repro.models.rope import apply_rope as japply
    inv = rope_frequencies(32, 10_000.0, 0.25)
    x = np.random.default_rng(5).normal(size=(2, 6, 3, 32)).astype(np.float32)
    p = np.arange(6)[None].repeat(2, 0)
    got = apply_rope(torch.as_tensor(x), torch.as_tensor(p),
                     torch.as_tensor(inv))
    assert_allclose(got.numpy(), np.asarray(japply(jnp.asarray(x),
                                                   jnp.asarray(p),
                                                   jnp.asarray(inv))),
                    atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


@pytest.mark.parametrize("field,value", [("kind", "none"),
                                         ("mla_q_lora_rank", 64)])
def test_unported_attention_features_raise(field, value):
    """What the port's transformer refuses: attention kind "none" (the
    xLSTM family's, which has its own model).  MLA with query compression
    is no refusal: the reference builds a plain ``wq`` whatever
    ``q_lora_rank`` is (``repro/models/attention.py:47-62``), and so does
    the port, so the reduced deepseek at ``q_lora_rank = 64`` gives JAX's
    logits.  (gemma3's ``qk_norm``, ``logit_soft_cap`` and
    ``local_global`` are ported: tests/test_torch_gemma3.py; sinusoidal
    positions: tests/test_torch_encdec.py and the case below.)"""
    if field == "mla_q_lora_rank":
        def with_q_lora(cfg):
            a = cfg.model.attention
            return fp32(dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, attention=dataclasses.replace(
                    a, mla=dataclasses.replace(a.mla, q_lora_rank=value)))))

        jcfg = with_q_lora(jax_get_config("deepseek-v2-lite-16b").reduced())
        tcfg = with_q_lora(get_config("deepseek-v2-lite-16b").reduced())
        params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
        tok = tokens(2, 13, tcfg.model.vocab_size)
        want, jaux = jtf.forward(params, jcfg.model, jnp.asarray(tok))
        got, aux = make_model(tcfg).forward(
            from_numpy_tree(jax.tree.map(np.asarray, params), "cpu"),
            {"tokens": torch.as_tensor(tok)})
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_allclose(aux.item(), float(jaux), **TOL)
        return
    _, tcfg, _, _ = jax_setup()
    a = dataclasses.replace(tcfg.model.attention, **{field: value})
    bad = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, attention=a))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(bad)


@pytest.mark.parametrize("paged", [False, True])
def test_sinusoidal_positions_take_rope_s_place(paged):
    """A dense config with ``rope_theta == 0`` (as internvl2's and
    whisper's attention would have it) rotates nothing and adds the
    sinusoidal positions to the embeddings in every path: forward, the
    one-shot (dense or paged) prefill and decode steps, whose per-row
    positions (B,) give each row its own position encoding."""
    jcfg, tcfg, params, npp = jax_setup()
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, attention=dataclasses.replace(c.model.attention,
                                               rope_theta=0.0)))
        for c in (jcfg, tcfg))
    jm, tm = jcfg.model, tcfg.model
    tp = from_numpy_tree(npp, "cpu")
    B, S, length = 2, 8, 6
    tok = tokens(B, S, tm.vocab_size)
    tok[:, length:] = 0
    assert_allclose(make_model(tcfg).forward(tp, {"tokens": torch.as_tensor(
        tok)})[0].numpy(), np.asarray(jax_make_model(jcfg).forward(
            params, {"tokens": jnp.asarray(tok)})[0]), **TOL)
    if paged:
        bt = _scattered_table(B, 4, 9)
        jc = jtf.init_paged_cache(jm, 9, 4)
        tc = transformer.init_paged_cache(tm, 9, 4, device="cpu")
        jl, jc = jtf.paged_prefill(params, jm, jnp.asarray(tok), jc,
                                   jnp.asarray(bt), length=length)
        tl, tc = transformer.paged_prefill(tp, tm, torch.as_tensor(tok), tc,
                                           torch.as_tensor(bt), length=length)
    else:
        jc = jtf.init_cache(jm, B, 16)
        tc = transformer.init_cache(tm, B, 16, device="cpu")
        jl, jc = jtf.prefill(params, jm, jnp.asarray(tok), jc, length=length)
        tl, tc = transformer.prefill(tp, tm, torch.as_tensor(tok), tc,
                                     length=length)
    assert_allclose(tl[:, :length].numpy(), np.asarray(jl)[:, :length],
                    **TOL)
    nxt = np.array(jnp.argmax(jl[:, length - 1], -1))
    for step in range(4):
        pos = length + step
        if paged:
            rows = np.full((B,), pos, np.int32)
            jl, jc = jtf.paged_decode_step(params, jm,
                                           jnp.asarray(nxt[:, None]),
                                           jnp.asarray(rows), jc,
                                           jnp.asarray(bt))
            tl, tc = transformer.paged_decode_step(
                tp, tm, torch.as_tensor(nxt[:, None]),
                torch.as_tensor(rows), tc, torch.as_tensor(bt))
        else:
            jl, jc = jtf.decode_step(params, jm, jnp.asarray(nxt[:, None]),
                                     jnp.int32(pos), jc)
            tl, tc = transformer.decode_step(tp, tm,
                                             torch.as_tensor(nxt[:, None]),
                                             torch.full((B,), pos), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
