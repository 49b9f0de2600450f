"""The port's zamba2 hybrid against ``repro.models.hybrid`` and the JAX
serving engine on the same weights: the reduced zamba2-1.2b (2 Mamba2
layers, d 256, 32 SSD heads of P 16, N 16, chunk 32, one shared
attention block of 4/2 heads, head_dim 32, window 64) in fp32.

Tolerances: fp32 on both sides, summed in other orders by the two
frameworks, 1e-4 on logits and loss; the port's own decode-vs-forward
check uses the 2e-3 of ``tests/test_decode_consistency.py``; greedy
tokens are identical.  The reduced model's run on the card against the
CPU is in ``tests/test_torch_ssm.py``, whose cuda cases need no JAX."""
import dataclasses

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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import hybrid, make_model  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.params import (flatten_with_path,  # noqa: E402
                                from_numpy_tree)
from repro_torch.serving import (PagedServeEngine, ReplicaPool,  # noqa: E402
                                 ServeEngine, lm_tiers, paged_lm_tiers)

ARCH = "zamba2-1.2b"
TOL = dict(atol=1e-4, rtol=1e-4)
#: tests/test_decode_consistency.py's sequence length and tolerance
S = 12
CONSISTENCY_TOL = dict(atol=2e-3, rtol=2e-3)


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


def _perturbed(params):
    """JAX's init leaves A_log, dt_bias and conv_b at 0 and D and the
    norm scales at 1; draw them away so every term of the block shows."""
    r = np.random.default_rng(7)
    out = jax.tree.map(np.array, params)
    mb = out["mamba_layers"]["mamba"]
    for k, std, base in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                         ("conv_b", 0.1, 0.0), ("D", 0.2, 1.0),
                         ("norm_scale", 0.1, 1.0)):
        mb[k] = (base + r.normal(size=mb[k].shape) * std).astype(mb[k].dtype)
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, numpy params) of the fp32 reduced
    zamba2."""
    jcfg = fp32(jax_get_config(ARCH).reduced())
    tcfg = fp32(get_config(ARCH).reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    npp = _perturbed(params)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), npp


def tokens(B, S_, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (B, S_))


def test_reduced_config_shape(setup):
    m = setup[1].model
    a, s = m.attention, m.ssm
    assert (m.family, m.num_layers, m.d_model, m.shared_attn_every) == \
        ("hybrid", 2, 256, 2)
    assert (s.state_dim, s.head_dim, s.chunk, s.ngroups) == (16, 16, 32, 1)
    assert m.d_model * s.expand // s.head_dim == 32
    assert (a.num_heads, a.num_kv_heads, a.head_dim, a.window) == \
        (4, 2, 32, 64)
    assert hybrid._segments(m) == [(0, 2, True)]


def test_segments_are_the_jax_ones():
    from repro.models import hybrid as jhyb
    m = get_config(ARCH).model
    assert hybrid._segments(m) == jhyb._segments(m)
    assert [seg[2] for seg in hybrid._segments(m)] == [True] * 6 + [False]
    r3 = dataclasses.replace(m, num_layers=5, shared_attn_every=2)
    assert hybrid._segments(r3) == jhyb._segments(r3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_is_the_jax_tree(dtype):
    """Same keys, shapes and dtypes as the JAX tree (A_log, D, dt_bias
    fp32 in a bf16 model)."""
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
    assert got[("mamba_layers", "mamba", "A_log")][1] == "float32"


def test_bf16_tree_carries_over_bit_for_bit():
    jcfg = jax_get_config(ARCH).reduced()
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(3))
    tree = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    leaves = dict(flatten_with_path(tree))
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = tuple(str(getattr(p, "key", p)) for p in path)
        t = leaves[key]
        if x.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(x).view(np.int16))
        else:
            assert key[-1] in ("A_log", "D", "dt_bias")
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(x))


def test_forward_and_loss_match_jax(setup):
    jcfg, tcfg, jp, npp = setup
    toks = tokens(2, 64)
    labels = tokens(2, 64, seed=2)
    labels[0, :5] = -100
    japi, tapi = jax_make_model(jcfg), make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    batch = {"tokens": torch.as_tensor(toks), "labels":
             torch.as_tensor(labels)}
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    logits, aux = tapi.forward(tp, batch)
    want, _ = japi.forward(jp, jbatch)
    assert logits.shape == (2, 64, tcfg.model.padded_vocab)
    assert float(aux) == 0.0
    assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert_allclose(float(tapi.loss(tp, batch)),
                    float(japi.loss(jp, jbatch)), **TOL)


def test_decode_steps_match_jax(setup):
    """Stepwise decode from a fresh cache, past the reduced window (64)
    so the shared ring wraps: logits at every step."""
    jcfg, tcfg, jp, npp = setup
    toks = tokens(2, 70, seed=3)
    japi, tapi = jax_make_model(jcfg), make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    cache = tapi.init_cache(2, 128, device="cpu")
    jcache = japi.init_cache(2, 128)
    assert isinstance(cache["mamba"], SSMState)
    assert list(cache["shared"]) == list(jcache["shared"]) == ["0"]
    assert cache["shared"]["0"].capacity == 64
    jstep = jax.jit(japi.decode_step)
    for t in range(70):
        lg, cache = tapi.decode_step(tp, torch.as_tensor(toks[:, t:t + 1]),
                                     torch.tensor(t), cache)
        want, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t), jcache)
        assert_allclose(lg.numpy(), np.asarray(want), **TOL)
    assert_allclose(cache["mamba"].s.numpy(), np.asarray(jcache["mamba"].s),
                    **TOL)


def test_decode_matches_forward(setup):
    """tests/test_decode_consistency.py for the port: teacher-forced
    decode steps reproduce the forward's logits, here with per-row
    positions (B,) as the engine passes them."""
    _, tcfg, _, npp = setup
    api = make_model(tcfg)
    tp = from_numpy_tree(npp, "cpu")
    toks = torch.as_tensor(tokens(2, S, seed=4))
    full, _ = api.forward(tp, {"tokens": toks})
    cache = api.init_cache(2, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(tp, toks[:, t:t + 1],
                                    torch.full((2,), t), cache)
        outs.append(lg[:, 0])
    assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                    **CONSISTENCY_TOL)


@pytest.mark.parametrize("B,S_", [(2, 5), (1, 70), (3, 13)])
def test_engine_tokens_match_the_jax_engine(setup, B, S_):
    """A 5-token prompt in its 8-token bucket (the JAX engine scans the
    3 padded steps, the port stops after 5), and a 70-token prompt, past
    the window 64, in its 128-token bucket."""
    jcfg, tcfg, jp, npp = setup
    p = tokens(B, S_, seed=S_)
    want = np.asarray(jeng.ServeEngine(jcfg, jp, batch_size=3, max_len=128)
                      .generate(jnp.asarray(p), 6))
    eng = ServeEngine(tcfg, npp, batch_size=3, max_len=128, device="cpu")
    got = eng.generate(p, 6)
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eng.generate_sequential(p, 6).numpy(),
                                  want)


def test_admission_empties_the_slot_first(setup):
    """A slot that served a sequence starts the next from a zero SSM
    state and an empty ring, as a fresh batch-1 cache would."""
    _, tcfg, _, npp = setup
    eng = ServeEngine(tcfg, npp, batch_size=2, max_len=64, device="cpu")
    p = tokens(1, 9, seed=5)[0]
    first = eng.generate(p[None], 4).numpy()
    slot = eng.acquire_slot()
    eng.admit(tokens(1, 20, seed=6)[0], slot=slot)
    eng.decode()
    eng.evict(slot)
    np.testing.assert_array_equal(eng.generate(p[None], 4).numpy(), first)


def test_measure_preserves_inflight_sequences(setup):
    _, tcfg, _, npp = setup
    eng = ServeEngine(tcfg, npp, batch_size=2, max_len=64, device="cpu")
    prompt = tokens(1, 8, seed=3)[0]
    expected = eng.generate(prompt[None], 6).numpy()[0]
    slot = eng.acquire_slot()
    toks = [eng.admit(prompt, slot=slot)]
    toks.append(int(eng.decode()[slot]))
    m = eng.measure(prompt_len=8, decode_steps=2, occupancy_levels=(1, 2))
    assert m.prefill_ms > 0 and m.decode_ms_per_token > 0
    assert [lvl for lvl, _ in m.occupancy_ms] == [1, 2]
    for _ in range(4):
        toks.append(int(eng.decode()[slot]))
    eng.evict(slot)
    np.testing.assert_array_equal(np.asarray(toks), expected)


def test_replica_pool_dispatch_matches_jax(setup):
    """``lm_tiers("zamba2-1.2b")``: three dense engines on one weight
    tree (the reduced config's bf16 shared ring, fp32 weights, as the
    stablelm tier tests serve them); dispatch at each tier and failover
    from a down edge to the cloud give the JAX pool's tokens."""
    from repro.serving import replica as jrep
    _, _, jp, npp = setup
    specs = lm_tiers(ARCH, max_len=128)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in jrep.lm_tiers(ARCH, max_len=128)]
    jpool = jrep.ReplicaPool(jrep.lm_tiers(ARCH, max_len=128),
                             shared_params=jp)
    tpool = ReplicaPool(specs, shared_params=npp, device="cpu")
    r = np.random.default_rng(8)
    for tier, B in (("device", 1), ("edge", 3), ("cloud", 5)):
        p = r.integers(0, 1024, (B, 11))
        got = tpool.dispatch(tier, p, steps=5)
        assert isinstance(tpool.engine(tier), ServeEngine)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpool.dispatch(tier, p, steps=5)))
    p = r.integers(0, 1024, (2, 9))
    tpool.mark_down("edge")
    jpool.mark_down("edge")
    got = tpool.dispatch("edge", p, steps=4)
    want = np.asarray(jpool.dispatch("edge", p, steps=4))
    assert tpool.failovers == jpool.failovers == 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_tiers_build_dense_engines_for_the_hybrid():
    pool = ReplicaPool(lm_tiers(ARCH, max_len=64), device="cpu")
    for tier, rows in (("device", 1), ("edge", 4), ("cloud", 8)):
        eng = pool.engine(tier)
        assert isinstance(eng, ServeEngine) and eng.batch_size == rows
        assert eng.cfg.model.family == "hybrid"
    out = pool.dispatch("device", tokens(1, 6), steps=3)
    assert out.shape == (1, 3)
    assert bool(((out >= 0) & (out < 1024)).all())
    m = pool.measure(prompt_len=8, decode_steps=2)
    assert all(mm.prefill_ms > 0 for mm in m.values())


def test_paged_tiers_raise_as_in_jax(setup):
    jcfg, tcfg, jp, npp = setup
    with pytest.raises(ValueError, match="paged"):
        ReplicaPool(paged_lm_tiers(ARCH), device="cpu").engine("device")
    with pytest.raises(ValueError, match="paged"):
        PagedServeEngine(tcfg, npp, max_seqs=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        jeng.PagedServeEngine(jcfg, jp, max_seqs=2)
    api = make_model(tcfg)
    assert api.prefill is None and api.paged_prefill is None
    assert api.init_paged_cache is None and api.paged_decode_step is None


def test_cpu_serving_launches_no_kernel(setup):
    _, tcfg, _, npp = setup
    ops.reset_launches()
    ServeEngine(tcfg, npp, batch_size=1, max_len=32,
                device="cpu").generate(tokens(1, 4), 2)
    make_model(tcfg).forward(from_numpy_tree(npp, "cpu"),
                             {"tokens": torch.as_tensor(tokens(1, 32))})
    assert set(ops.launch_counts().values()) == {0}
