"""The vlm family (internvl2-76b's language model behind the stub's patch
prefix) and the llama3-405b config copy against the JAX package on the
same weights: both at ``.reduced()`` size (2 layers, d 256, 4 heads on 2
kv heads of dim 32; internvl2 with 16 patch embeddings) in fp32, since
neither fits one card at full width.

Weights: JAX's init with ``wq`` and ``wk`` rescaled to a fan-in over
d_model, so that attention scores are O(1) (``tests/test_torch_encdec.py``
says why).  Tolerances: fp32 3e-5 (``tests/test_kernels.py``); greedy
tokens identical."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.params import flatten_with_path, from_numpy_tree  # noqa: E402
from repro_torch.serving import (PagedServeEngine, ServeEngine,  # noqa: E402
                                 bucket_len)

VLM = "internvl2-76b"
TOL = dict(atol=3e-5, rtol=3e-5)
P = 16


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


def o1_scores(tree):
    def f(path, x):
        if path[-1].key in ("wq", "wk"):
            return (x * np.float32(math.sqrt(x.shape[-2] / x.shape[-3]))
                    ).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def setup(arch):
    jcfg = fp32(jax_get_config(arch).reduced())
    tcfg = fp32(get_config(arch).reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    npp = o1_scores(jax.tree.map(np.array, params))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module")
def vlm():
    return setup(VLM)


def tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


def patches(B, seed=2):
    return np.random.default_rng(seed).normal(size=(B, P, 256)).astype(
        np.float32)


def test_reduced_config_shape(vlm):
    m = vlm[1].model
    assert (m.family, m.num_layers, m.d_model, m.frontend.kind,
            m.frontend.num_positions) == ("vlm", 2, 256, "vision_patches", 16)
    tree = make_model(vlm[1]).init_params(torch.Generator().manual_seed(0),
                                          "cpu")
    shapes = jax.eval_shape(lambda k: jax_make_model(vlm[0]).init_params(
        k)[0], jax.random.key(0))
    want = {tuple(str(getattr(p, "key", p)) for p in path): x.shape
            for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {p: tuple(x.shape) for p, x in flatten_with_path(tree)} == want


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_and_loss_match_jax(vlm, with_patches):
    """The patch prefix goes before the tokens, and the loss pads the
    labels with -100 over its P positions."""
    jcfg, tcfg, jp, npp = vlm
    labels = tokens(2, 12, seed=3)
    labels[0, :4] = -100
    batch = {"tokens": tokens(2, 12), "labels": labels}
    if with_patches:
        batch["patches"] = patches(2)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tapi, japi = make_model(tcfg), jax_make_model(jcfg)
    tp = from_numpy_tree(npp, "cpu")
    logits, aux = tapi.forward(tp, tb)
    want, _ = japi.forward(jp, jb)
    assert logits.shape == (2, 12 + (P if with_patches else 0),
                            tcfg.model.padded_vocab)
    assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert_allclose(float(tapi.loss(tp, tb)), float(japi.loss(jp, jb)),
                    **TOL)


def test_prefill_with_prefix_matches_jax(vlm):
    """``extra_embeds`` before the tokens in the one-shot prefill: the
    logits over all P + S positions and the ring written for the first
    ``length`` (= S by default, as in JAX) positions."""
    jcfg, tcfg, jp, npp = vlm
    toks, pt = tokens(2, 8, seed=4), patches(2, seed=5)
    tapi, japi = make_model(tcfg), jax_make_model(jcfg)
    cache = tapi.init_cache(2, 32, device="cpu")
    lg, cache = tapi.prefill(from_numpy_tree(npp, "cpu"),
                             torch.as_tensor(toks), cache,
                             extra_embeds=torch.as_tensor(pt))
    want, jcache = japi.prefill(jp, jnp.asarray(toks), japi.init_cache(2, 32),
                                extra_embeds=jnp.asarray(pt))
    assert lg.shape[1] == P + 8
    assert_allclose(lg.numpy(), np.asarray(want), **TOL)
    layers = cache["layers"]
    assert_allclose(layers.k.numpy(), np.asarray(jcache["layers"].k), **TOL)
    np.testing.assert_array_equal(layers.pos.numpy()[:, 0],
                                  np.asarray(jcache["layers"].pos)[:, 0])


def _jax_greedy_logits(jcfg, jp, prompt, steps):
    """The JAX model's one-shot prefill of one prompt in its bucket, then
    greedy decode steps: the logits of each decode step."""
    api = jax_make_model(jcfg)
    S = len(prompt)
    padded = np.zeros((1, bucket_len(S)), np.int64)
    padded[0, :S] = prompt
    lg, cache = api.prefill(jp, jnp.asarray(padded), api.init_cache(1, 32),
                            length=S)
    tok, out = int(np.argmax(lg[0, S - 1])), []
    for t in range(steps - 1):
        lg, cache = api.decode_step(jp, jnp.asarray([[tok]]),
                                    jnp.int32(S + t), cache)
        out.append(np.asarray(lg[0, -1]))
        tok = int(np.argmax(out[-1]))
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engines_match_the_jax_engines(vlm, paged):
    """The text prefill (no patches, as the JAX engines serve a vlm):
    greedy tokens of both engines, and every decode step's logits against
    the JAX model's for the prompt alone."""
    jcfg, tcfg, jp, npp = vlm
    prompts = tokens(2, 9, seed=6)
    if paged:
        jeng_ = jeng.PagedServeEngine(jcfg, jp, max_seqs=2, page_size=4,
                                      max_len=32)
        eng = PagedServeEngine(tcfg, npp, max_seqs=2, page_size=4,
                               max_len=32, device="cpu")
        name = "paged_decode_step"
    else:
        jeng_ = jeng.ServeEngine(jcfg, jp, batch_size=2, max_len=32)
        eng = ServeEngine(tcfg, npp, batch_size=2, max_len=32, device="cpu")
        name = "decode_step"
    want = np.asarray(jeng_.generate(jnp.asarray(prompts), 5))
    inner, sink = getattr(eng.api, name), []

    def step(*args, **kw):
        out, c = inner(*args, **kw)
        sink.append(out[:, -1].clone())
        return out, c

    eng.api = eng.api._replace(**{name: step})
    np.testing.assert_array_equal(eng.generate(prompts, 5).numpy(), want)
    assert len(sink) == 4
    for b in range(2):
        for got, w in zip(sink, _jax_greedy_logits(jcfg, jp, prompts[b], 5)):
            assert_allclose(got[b].numpy(), w, **TOL)


def test_llama3_405b_reduced_forward_matches_jax():
    jcfg, tcfg, jp, npp = setup("llama3-405b")
    assert (tcfg.model.family, tcfg.model.attention.kind) == ("dense", "full")
    toks = tokens(2, 13)
    got, _ = make_model(tcfg).forward(from_numpy_tree(npp, "cpu"),
                                      {"tokens": torch.as_tensor(toks)})
    want, _ = jax_make_model(jcfg).forward(jp, {"tokens": jnp.asarray(toks)})
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
