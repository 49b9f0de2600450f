"""The port's MoE layer, MLA attention and MoE transformers against
``repro.models`` and ``repro.serving`` on the same weights: reduced
deepseek-v2-lite (MLA + MoE, a lead dense layer; 2 layers, d 256, 4
experts top-2 with 1 shared, kv_lora 32) and reduced qwen2-moe (GQA +
MoE), at fp32 with weights drawn once with JAX and carried across.

On the CPU the router is the plain version of ``topk_router`` and the
paged MLA decode the plain version of ``paged_mla_decode_attention``; the
kernels themselves, and the reduced deepseek's engines on the card, are
held against those in ``tests/test_torch_moe_kernels.py`` (``cuda``) and
in ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import replica as jrep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import make_model, moe, transformer  # noqa: E402
from repro_torch.models.rope import rope_frequencies  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)
from repro_torch.serving import (PagedServeEngine,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving import replica as rep  # noqa: E402

#: fp32 end to end; the two frameworks sum products in other orders
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b"]
DEEPSEEK = ARCHS[0]


def fp32(cfg, capacity_factor=None):
    m = dataclasses.replace(cfg.model, dtype="float32", param_dtype="float32")
    if capacity_factor is not None:
        m = dataclasses.replace(m, moe=dataclasses.replace(
            m.moe, capacity_factor=capacity_factor))
    return dataclasses.replace(cfg, model=m)


_SETUPS = {}


def setup(arch, capacity_factor=None):
    """(JAX cfg, port cfg, JAX params, numpy params) of the reduced fp32
    ``arch``, weights drawn once with JAX."""
    key = (arch, capacity_factor)
    if key not in _SETUPS:
        jcfg = fp32(jax_get_config(arch).reduced(), capacity_factor)
        tcfg = fp32(get_config(arch).reduced(), capacity_factor)
        params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
        _SETUPS[key] = (jcfg, tcfg, params, jax.tree.map(np.asarray, params))
    return _SETUPS[key]


def tokens(B, S, vocab=1024, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def normal(shape, seed=2):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_case(arch, capacity_factor, B, S):
    jcfg, tcfg, params, npp = setup(arch, capacity_factor)
    p = jax.tree.map(lambda a: a[-1], npp["layers"]["moe"])  # last MoE layer
    return jcfg.model.moe, tcfg.model, p, normal((B, S, tcfg.model.d_model))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,B,S", [(None, 2, 13),
                                                 (0.25, 3, 16),
                                                 (4.0, 1, 5)])
def test_apply_moe_matches_jax(arch, capacity_factor, B, S):
    """Default capacity, a capacity small enough to drop tokens (C = 8
    of 96 assignments over 4 experts), and one large enough for all."""
    jm, m, p, x = _moe_case(arch, capacity_factor, B, S)
    want, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jm,
                                jnp.asarray(x), m.act)
    got, aux = moe.apply_moe(from_numpy_tree(p, "cpu"), m.moe,
                             torch.as_tensor(x), m.act, with_aux=True)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    t, E, K = B * S, m.moe.num_experts, m.moe.top_k
    if capacity_factor == 0.25:        # the case must drop assignments
        logits = torch.tensor(x.reshape(t, -1)) @ torch.tensor(p["router"])
        _, idx = ops.topk_router(logits, K)
        counts = np.bincount(idx.numpy().ravel(), minlength=E)
        assert counts.max() > moe._capacity(t, m.moe)


def test_apply_moe_without_aux_gives_zero():
    _, m, p, x = _moe_case(DEEPSEEK, None, 1, 4)
    with_aux, aux = moe.apply_moe(from_numpy_tree(p, "cpu"), m.moe,
                                  torch.as_tensor(x), m.act, with_aux=True)
    out, zero = moe.apply_moe(from_numpy_tree(p, "cpu"), m.moe,
                              torch.as_tensor(x), m.act)
    assert zero.item() == 0.0 and aux.item() > 0.0
    assert torch.equal(out, with_aux)


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_apply_moe_groups_are_separate_calls(capacity_factor):
    """groups=B over (B,1,d) is the JAX layer vmapped over rows: every
    row's token gets its own capacity, however small the factor."""
    jm, m, p, x = _moe_case(DEEPSEEK, capacity_factor, 16, 1)
    jp = jax.tree.map(jnp.asarray, p)
    want = np.concatenate([np.asarray(jmoe.apply_moe(
        jp, jm, jnp.asarray(x[b:b + 1]), m.act)[0]) for b in range(16)])
    got, _ = moe.apply_moe(from_numpy_tree(p, "cpu"), m.moe,
                           torch.as_tensor(x), m.act, groups=16)
    assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="groups"):
        moe.apply_moe(from_numpy_tree(p, "cpu"), m.moe, torch.as_tensor(x),
                      m.act, groups=3)


@pytest.mark.parametrize("t", [1, 2, 7, 64, 640])
def test_capacity_is_the_jax_one(t):
    jm = setup(DEEPSEEK)[0].model.moe
    full = get_config(DEEPSEEK).model.moe
    jfull = jax_get_config(DEEPSEEK).model.moe
    assert moe._capacity(t, setup(DEEPSEEK)[1].model.moe) == \
        jmoe._capacity(t, jm)
    assert moe._capacity(t, full) == jmoe._capacity(t, jfull)


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

def _mla_case():
    jcfg, tcfg, params, npp = setup(DEEPSEEK)
    a = tcfg.model.attention
    p = npp["lead"]["0"]["attn"]
    inv = rope_frequencies(a.mla.qk_rope_head_dim, a.rope_theta)
    return jcfg.model.attention, a, p, inv


def test_mla_forward_matches_jax():
    ja, a, p, inv = _mla_case()
    x = normal((2, 11, 256))
    pos = np.arange(11)
    want = jattn.mla_forward(jax.tree.map(jnp.asarray, p), ja,
                             jnp.asarray(x), jnp.asarray(pos),
                             jnp.asarray(inv))
    got = attn.mla_forward(from_numpy_tree(p, "cpu"), a, torch.as_tensor(x),
                           torch.as_tensor(pos), torch.as_tensor(inv))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("length", [5, 8])
def test_mla_prefill_and_decode_match_jax(length):
    """Right-padded prefill into a 12-slot ring, then decode steps past
    the ring's end (the ring wraps), outputs and latents at every step."""
    ja, a, p, inv = _mla_case()
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")
    jinv, tinv = jnp.asarray(inv), torch.as_tensor(inv)
    B, S, cap = 2, 8, 12
    x = normal((B, S, 256))
    pos = np.arange(S)
    jc = jattn.init_mla_cache(B, cap, ja, jnp.float32)
    tc = attn.init_mla_cache(B, cap, a, torch.float32)
    jy, jc = jattn.mla_prefill(jp, ja, jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(length), jc, jinv)
    ty, tc = attn.mla_prefill(tp, a, torch.as_tensor(x), torch.as_tensor(pos),
                              length, tc, tinv)
    assert_allclose(ty[:, :length].numpy(), np.asarray(jy)[:, :length], **TOL)
    for step in range(8):
        xd = normal((B, 1, 256), seed=10 + step)
        p_now = length + step
        jy, jc = jattn.mla_decode(jp, ja, jnp.asarray(xd), jnp.int32(p_now),
                                  jc, jinv)
        ty, tc = attn.mla_decode(tp, a, torch.as_tensor(xd),
                                 torch.tensor(p_now), tc, tinv)
        assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert_allclose(tc.c_kv.numpy(), np.asarray(jc.c_kv), **TOL)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_paged_mla_prefill_and_decode_match_jax():
    """Two rows with scattered pages, prefill of different lengths, then
    batched decode with per-row positions crossing page boundaries."""
    ja, a, p, inv = _mla_case()
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")
    jinv, tinv = jnp.asarray(inv), torch.as_tensor(inv)
    ps, num_pages, Pseq = 4, 10, 4
    bt = np.array([[7, 2, 9, 0], [3, 8, 1, 5]], np.int32)
    jc = jattn.init_paged_mla_cache(num_pages, ps, ja, jnp.float32)
    tc = attn.init_paged_mla_cache(num_pages, ps, a, torch.float32)
    x = normal((1, 8, 256))
    pos = np.arange(8)
    lengths = [7, 5]
    for b in range(2):
        jy, jc = jattn.paged_mla_prefill(
            jp, ja, jnp.asarray(x), jnp.asarray(pos),
            jnp.asarray(lengths[b]), jc, jnp.asarray(bt[b:b + 1]), jinv)
        ty, tc = attn.paged_mla_prefill(
            tp, a, torch.as_tensor(x), torch.as_tensor(pos), lengths[b], tc,
            torch.as_tensor(bt[b:b + 1]), tinv)
        assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for step in range(6):
        xd = normal((2, 1, 256), seed=20 + step)
        p_now = np.asarray(lengths) + step
        jy, jc = jattn.paged_mla_decode(jp, ja, jnp.asarray(xd),
                                        jnp.asarray(p_now), jc,
                                        jnp.asarray(bt), jinv)
        ty, tc = attn.paged_mla_decode(tp, a, torch.as_tensor(xd),
                                       torch.as_tensor(p_now), tc,
                                       torch.as_tensor(bt), tinv)
        assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert_allclose(tc.ckv_pages.numpy(), np.asarray(jc.ckv_pages),
                        **TOL)


# ---------------------------------------------------------------------------
# the MoE transformers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_tree(arch):
    _, tcfg, _, npp = setup(arch)
    got = make_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                       "cpu")
    want = [(p, tuple(x.shape), str(x.dtype)) for p, x in
            flatten_with_path(npp)]
    assert [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_path(got)] == want
    if arch == DEEPSEEK:
        assert "0" in got["lead"] and "mlp" in got["lead"]["0"]
        assert got["lead"]["0"]["mlp"]["wi_gate"].shape == (256, 128)
    # routers stay fp32 in a bf16 tree, as ParamBuilder keeps them
    bf16 = make_model(get_config(arch).reduced()).init_params(
        torch.Generator().manual_seed(0), "cpu")
    assert bf16["layers"]["moe"]["router"].dtype == torch.float32
    assert bf16["layers"]["moe"]["wi_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, tcfg, params, npp = setup(arch)
    tok = tokens(2, 13)
    want, jaux = jtf.forward(params, jcfg.model, jnp.asarray(tok))
    got, aux = transformer.forward(from_numpy_tree(npp, "cpu"), tcfg.model,
                                   torch.as_tensor(tok))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    labels = tokens(2, 13, seed=3)
    jl = jax_make_model(jcfg).loss(params, {"tokens": jnp.asarray(tok),
                                            "labels": jnp.asarray(labels)})
    tl = make_model(tcfg).loss(from_numpy_tree(npp, "cpu"),
                               {"tokens": torch.as_tensor(tok),
                                "labels": torch.as_tensor(labels)})
    assert_allclose(tl.item(), float(jl), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Right-padded prefill (bucket 16, length 11) into a 24-slot cache,
    then 6 greedy decode steps of the batch (one pooled capacity, as one
    JAX call at B = 2)."""
    jcfg, tcfg, params, npp = setup(arch)
    tp = from_numpy_tree(npp, "cpu")
    B, S, length, cap = 2, 16, 11, 24
    tok = tokens(B, S)
    tok[:, length:] = 0
    jc = jtf.init_cache(jcfg.model, B, cap)
    tc = transformer.init_cache(tcfg.model, B, cap, device="cpu")
    jl, jc = jtf.prefill(params, jcfg.model, jnp.asarray(tok), jc,
                         length=length)
    tl, tc = transformer.prefill(tp, tcfg.model, torch.as_tensor(tok), tc,
                                 length=length)
    assert_allclose(tl[:, :length].numpy(), np.asarray(jl)[:, :length],
                    **TOL)
    nxt = np.asarray(jl)[:, length - 1:length].argmax(-1)
    for step in range(6):
        jl, jc = jtf.decode_step(params, jcfg.model, jnp.asarray(nxt),
                                 jnp.int32(length + step), jc)
        tl, tc = transformer.decode_step(tp, tcfg.model, torch.as_tensor(nxt),
                                         torch.tensor(length + step), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jl).argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, params, npp = setup(arch)
    tp = from_numpy_tree(npp, "cpu")
    ps, num_pages = 4, 12
    bt = np.array([[5, 1, 9, 3, 12], [2, 7, 0, 11, 12]], np.int32)
    jc = jtf.init_paged_cache(jcfg.model, num_pages, ps)
    tc = transformer.init_paged_cache(tcfg.model, num_pages, ps,
                                      device="cpu")
    lengths = [9, 6]
    tok = tokens(2, 16)
    for b in range(2):
        row = tok[b:b + 1].copy()
        row[:, lengths[b]:] = 0
        jl, jc = jtf.paged_prefill(params, jcfg.model, jnp.asarray(row), jc,
                                   jnp.asarray(bt[b:b + 1]),
                                   length=lengths[b])
        tl, tc = transformer.paged_prefill(tp, tcfg.model,
                                           torch.as_tensor(row), tc,
                                           torch.as_tensor(bt[b:b + 1]),
                                           length=lengths[b])
        assert_allclose(tl[:, :lengths[b]].numpy(),
                        np.asarray(jl)[:, :lengths[b]], **TOL)
    nxt = tok[:, :1]
    for step in range(6):
        pos = np.asarray(lengths) + step
        jl, jc = jtf.paged_decode_step(params, jcfg.model, jnp.asarray(nxt),
                                       jnp.asarray(pos), jc, jnp.asarray(bt))
        tl, tc = transformer.paged_decode_step(
            tp, tcfg.model, torch.as_tensor(nxt), torch.as_tensor(pos), tc,
            torch.as_tensor(bt))
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jl).argmax(-1)


def test_mla_rope_rotates_the_rope_dims_only():
    _, tcfg, _, _ = setup(DEEPSEEK)
    m = tcfg.model.attention.mla
    assert transformer._inv_freq(tcfg.model, "cpu").shape == \
        (m.qk_rope_head_dim // 2,)
    assert tuple(np.asarray(jtf.stacked_rope(setup(DEEPSEEK)[0].model)
                            ).shape[1:]) == (m.qk_rope_head_dim // 2,)


# ---------------------------------------------------------------------------
# the serving engines and the replica pool
# ---------------------------------------------------------------------------

def _engines(arch, capacity_factor, B):
    jcfg, tcfg, params, npp = setup(arch, capacity_factor)
    return ((jeng.ServeEngine(jcfg, params, batch_size=B, max_len=64),
             ServeEngine(tcfg, npp, batch_size=B, max_len=64, device="cpu")),
            (jeng.PagedServeEngine(jcfg, params, max_seqs=B, page_size=8,
                                   max_len=64),
             PagedServeEngine(tcfg, npp, max_seqs=B, page_size=8,
                              max_len=64, device="cpu")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B", [1, 3])
def test_generate_matches_the_jax_engines(arch, B):
    prompt = tokens(B, 13, seed=B)
    for jax_engine, engine in _engines(arch, None, B):
        want = np.asarray(jax_engine.generate(jnp.asarray(prompt, jnp.int32),
                                              steps=6))
        got = engine.generate(prompt, 6)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_more_rows_than_capacity_still_match_the_jax_engines(arch):
    """16 rows at capacity factor 0.25: the dense engine's per-row
    capacity keeps JAX's vmapped tokens, and the paged engine, whose rows
    share one capacity (16 tokens, 32 assignments, C = 8 for 4 experts),
    keeps JAX's paged tokens."""
    prompt = tokens(16, 13, seed=4)
    for jax_engine, engine in _engines(arch, 0.25, 16):
        want = np.asarray(jax_engine.generate(jnp.asarray(prompt, jnp.int32),
                                              steps=5))
        got = engine.generate(prompt, 5)
        np.testing.assert_array_equal(got.numpy(), want)


def test_deepseek_replica_pool_matches_jax():
    """A ReplicaPool of deepseek tiers on the CPU, dense and paged, each
    tier's dispatch against the JAX pool on the same fp32 weights (bf16
    caches, as the reduced config keeps)."""
    cfg = jax_get_config(DEEPSEEK).reduced()
    params, _ = jax_make_model(cfg).init_params(jax.random.key(0))
    shared = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    prompts = tokens(3, 10, seed=5)
    for paged in (False, True):
        fn = "paged_lm_tiers" if paged else "lm_tiers"
        jspecs = getattr(jrep, fn)(DEEPSEEK, max_len=64)
        tspecs = getattr(rep, fn)(DEEPSEEK, max_len=64)
        assert [dataclasses.asdict(s) for s in tspecs] == \
            [dataclasses.asdict(s) for s in jspecs]
        jpool = jrep.ReplicaPool(jspecs, shared_params=jax.tree.map(
            jnp.asarray, shared))
        tpool = rep.ReplicaPool(tspecs, shared_params=shared, device="cpu")
        for tier, B in (("device", 1), ("cloud", 3)):
            want = np.asarray(jpool.dispatch(tier, prompts[:B], steps=4))
            got = tpool.dispatch(tier, prompts[:B], steps=4)
            np.testing.assert_array_equal(got.numpy(), want)
            eng = tpool.engine(tier)
            assert isinstance(eng, PagedServeEngine if paged
                              else ServeEngine)
            assert isinstance(eng.cache["lead"]["0"],
                              attn.PagedMLACache if paged else attn.MLACache)


def test_bf16_deepseek_tree_carries_over_key_for_key():
    """A bf16 JAX deepseek tree (lead subtree, fp32 routers) crosses
    bit for bit, every key and dtype kept."""
    cfg = jax_get_config(DEEPSEEK).reduced()
    params, _ = jax_make_model(cfg).init_params(jax.random.key(1))
    got = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    want = flatten_with_path(jax.tree.map(np.asarray, params))
    flat = flatten_with_path(got)
    assert [p for p, _ in flat] == [p for p, _ in want]
    assert any(p[0] == "lead" for p, _ in flat)
    for (path, t), (_, a) in zip(flat, want):
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.ascontiguousarray(a).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    assert got["lead"]["0"]["attn"]["w_uk"].dtype == torch.bfloat16

