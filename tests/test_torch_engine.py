"""The port's serving engines against ``repro.serving.engine`` on the
same weights (reduced stablelm-1.6b at fp32): greedy tokens of both
engines equal the JAX engines' and each other's, ``measure()`` mid-flight
leaves in-flight sequences as they were, and the slot and page
bookkeeping raises and recovers as in JAX."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (EngineMeasurement,  # noqa: E402
                                 PagedServeEngine, PagesExhausted,
                                 ServeEngine, bucket_len)


def fp32(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))


@pytest.fixture(scope="module")
def setup():
    jcfg = fp32(jax_get_config("stablelm-1.6b").reduced())
    tcfg = fp32(get_config("stablelm-1.6b").reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def prompts(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


def dense(setup, B=2, max_len=64):
    _, tcfg, _, npp = setup
    return ServeEngine(tcfg, npp, batch_size=B, max_len=max_len,
                       device="cpu")


def paged(setup, B=2, max_len=64, page_size=8, num_pages=None):
    _, tcfg, _, npp = setup
    return PagedServeEngine(tcfg, npp, max_seqs=B, page_size=page_size,
                            num_pages=num_pages, max_len=max_len,
                            device="cpu")


def test_bucket_len_is_the_jax_one():
    assert [bucket_len(n) for n in (1, 8, 9, 64, 65, 200)] == \
        [jeng.bucket_len(n) for n in (1, 8, 9, 64, 65, 200)]


@pytest.mark.parametrize("B,S", [(2, 13), (1, 8), (3, 5)])
def test_generate_matches_the_jax_engines(setup, B, S):
    jcfg, _, params, _ = setup
    p = prompts(B, S, seed=S)
    want = np.asarray(jeng.ServeEngine(jcfg, params, batch_size=3,
                                       max_len=64).generate(jnp.asarray(p), 6))
    want_paged = np.asarray(jeng.PagedServeEngine(
        jcfg, params, max_seqs=3, page_size=8, max_len=64
    ).generate(jnp.asarray(p), 6))
    np.testing.assert_array_equal(want_paged, want)
    got = dense(setup, B=3).generate(p, 6)
    got_paged = paged(setup, B=3).generate(p, 6)
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_paged.numpy(), want)


def test_generate_sequential_matches_prefill_path(setup):
    eng = dense(setup)
    p = prompts(2, 7, seed=3)
    np.testing.assert_array_equal(eng.generate_sequential(p, 5).numpy(),
                                  eng.generate(p, 5).numpy())


@pytest.mark.parametrize("make", [dense, paged])
def test_measure_preserves_inflight_sequences(setup, make):
    """tests/test_serving.py's calibration-mid-serving case, for both
    engines: tokens after a measure() equal an uninterrupted run."""
    eng = make(setup)
    prompt = prompts(1, 8, seed=3)[0]
    expected = eng.generate(prompt[None], 6).numpy()[0]
    slot = eng.acquire_slot()
    toks = [eng.admit(prompt, slot=slot)]
    toks.append(int(eng.decode()[slot]))
    m = eng.measure(prompt_len=8, decode_steps=2, occupancy_levels=(1, 2))
    assert isinstance(m, EngineMeasurement)
    assert m.prefill_ms > 0 and m.decode_ms_per_token > 0
    for _ in range(4):
        toks.append(int(eng.decode()[slot]))
    eng.evict(slot)
    np.testing.assert_array_equal(np.asarray(toks), expected)


@pytest.mark.parametrize("make", [dense, paged])
def test_double_evict_raises_and_drain_frees_all(setup, make):
    eng = make(setup)
    s0, s1 = eng.acquire_slot(), eng.acquire_slot()
    eng.admit(prompts(1, 5)[0], slot=s0)
    eng.admit(prompts(1, 9)[0], slot=s1)
    assert eng.active_slots == 2 and not eng.can_admit(4)
    eng.evict(s0)
    with pytest.raises(ValueError, match="double evict"):
        eng.evict(s0)
    s0 = eng.acquire_slot()
    eng.admit(prompts(1, 6)[0], slot=s0)
    assert sorted(eng.drain()) == [0, 1]
    assert eng.active_slots == 0
    if isinstance(eng, PagedServeEngine):
        assert eng.pool.free_pages == eng.num_pages
        assert (eng._block_tables == eng.scratch_page).all()


def test_failed_admission_releases_its_pages(setup):
    eng = paged(setup)
    slot = eng.acquire_slot()

    def boom(*args, **kwargs):
        raise RuntimeError("prefill failed")

    eng.api = eng.api._replace(paged_prefill=boom)
    with pytest.raises(RuntimeError, match="prefill failed"):
        eng.admit(prompts(1, 10)[0], slot=slot)
    assert eng.pool.free_pages == eng.num_pages
    assert slot not in eng.pool.sequences
    assert (eng._block_tables[slot] == eng.scratch_page).all()
    eng.evict(slot)                       # frees the row, holds no pages
    assert eng.drain() == []


def test_pages_exhausted_on_a_dry_pool(setup):
    eng = paged(setup, B=3, num_pages=4)       # 32 tokens of 8-token pages
    a, b = eng.acquire_slot(), eng.acquire_slot()
    eng.admit(prompts(1, 12)[0], slot=a, reserve_tokens=4)  # 2 pages
    eng.admit(prompts(1, 10)[0], slot=b, reserve_tokens=4)  # 2 pages
    assert eng.pool.free_pages == 0 and not eng.can_admit(1)
    c = eng.acquire_slot()
    with pytest.raises(PagesExhausted):
        eng.admit(prompts(1, 3)[0], slot=c)
    eng.evict(c)
    with pytest.raises(PagesExhausted):            # row a grows past 16
        for _ in range(6):
            eng.decode()
    eng.drain()


def test_engines_refuse_busy_generate_and_long_prompts(setup):
    eng = dense(setup)
    eng.admit(prompts(1, 4)[0], slot=eng.acquire_slot())
    with pytest.raises(RuntimeError, match="active sequences"):
        eng.generate(prompts(1, 4), 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.admit(prompts(1, 65)[0], slot=1)


def test_gru_has_no_engine(setup):
    cfg = get_config("gru-traffic").reduced()
    from repro_torch.models import make_model
    params = make_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         "cpu")
    with pytest.raises(ValueError, match="per-request"):
        ServeEngine(cfg, params, batch_size=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        PagedServeEngine(cfg, params, max_seqs=1, device="cpu")
