"""The port's replica pool against ``repro.serving.replica`` with the same
shared weights: per-tier dispatch, health and failover, measurement into
the latency model; and the slice as a whole, FedAvg rounds feeding the
served model, against the JAX pipeline."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.fl import aggregation as jagg  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.serving import replica as jrep  # noqa: E402
from repro_torch.fl import aggregation as agg  # noqa: E402
from repro_torch.params import from_numpy_tree  # noqa: E402
from repro_torch.routing import LatencyModel  # noqa: E402
from repro_torch.serving import EngineMeasurement  # noqa: E402
from repro_torch.serving import replica as rep  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _shared(reduced=True, seed=0):
    cfg = jax_get_config("gru-traffic")
    cfg = cfg.reduced() if reduced else cfg
    params, _ = jax_gru.init_params(jax.random.key(seed), cfg.model)
    return jax.tree.map(np.asarray, params)


def _pools(specs=None, shared=None):
    shared = _shared() if shared is None else shared
    jspecs = specs or jrep.DEFAULT_TIERS
    tspecs = [rep.TierSpec(**dataclasses.asdict(s)) for s in jspecs]
    jpool = jrep.ReplicaPool(jspecs, shared_params=jax.tree.map(
        jnp.asarray, shared))
    tpool = rep.ReplicaPool(tspecs, shared_params=shared, device="cpu")
    return jpool, tpool


def test_tier_layout_matches_jax():
    assert rep.TIERS == jrep.TIERS
    assert rep.FAILOVER_ORDER == jrep.FAILOVER_ORDER
    assert rep.HEALTH_STATES == jrep.HEALTH_STATES
    shared = [f.name for f in dataclasses.fields(rep.TierSpec)]
    assert ([dataclasses.asdict(s) for s in rep.DEFAULT_TIERS]
            == [{k: getattr(s, k) for k in shared}
                for s in jrep.DEFAULT_TIERS])
    _, tpool = _pools()
    assert tpool.tiers == ("device", "edge", "cloud")
    assert [tpool.concurrency(t) for t in tpool.tiers] == [1, 4, 16]


@pytest.mark.parametrize("tier,B", [("device", 1), ("edge", 4),
                                    ("cloud", 16), ("edge", 3)])
def test_dispatch_matches_jax(tier, B):
    jpool, tpool = _pools()
    w = np.random.default_rng(B).normal(size=(B, 12, 1))
    want = np.asarray(jpool.dispatch(tier, w))
    got = tpool.dispatch(tier, w)
    assert got.shape == (B, 1) and got.device.type == "cpu"
    assert_allclose(got.numpy(), want, **TOL)


def test_dispatch_at_full_width_matches_jax():
    specs = [jrep.TierSpec(t, batch_size=b, reduced=False)
             for t, b in (("device", 1), ("edge", 4), ("cloud", 16))]
    jpool, tpool = _pools(specs, _shared(reduced=False))
    assert tpool.replica("cloud").cfg.model.rnn_hidden == 128
    w = np.random.default_rng(5).normal(size=(16, 12, 1))
    assert_allclose(tpool.dispatch("cloud", w).numpy(),
                    np.asarray(jpool.dispatch("cloud", w)), **TOL)


def _health_script(pool):
    """The failover walk of tests/test_serving.py; returns what it saw."""
    seen = [pool.health(t) for t in pool.tiers]
    seen.append(pool.resolve_tier("edge"))
    pool.set_health("edge", "degraded")
    seen.append(pool.resolve_tier("edge"))
    pool.set_health("edge", "down")
    seen.append(pool.resolve_tier("edge"))
    seen.append(pool.resolve_tier("device"))
    pool.mark_down("device")
    seen.append(pool.resolve_tier("device"))
    pool.set_health("cloud", "down")
    with pytest.raises(RuntimeError, match="failover chain"):
        pool.resolve_tier("device")
    pool.mark_up("edge")
    seen.append(pool.resolve_tier("device"))
    with pytest.raises(ValueError):
        pool.set_health("edge", "on-fire")
    with pytest.raises(ValueError):
        pool.set_health("fog", "down")
    seen.append(pool.failovers)
    return seen


def test_health_and_failover_match_jax():
    jpool, tpool = _pools()
    assert _health_script(tpool) == _health_script(jpool)
    assert tpool.failovers == 3


def test_down_tier_fails_over_with_the_same_predictions():
    jpool, tpool = _pools()
    w = np.random.default_rng(2).normal(size=(4, 12, 1))
    for pool in (jpool, tpool):
        assert pool.mark_down("edge") == []
    got = tpool.dispatch("edge", w)          # served by the cloud replica
    want = np.asarray(jpool.dispatch("edge", w))
    assert tpool.failovers == jpool.failovers == 1
    assert "cloud" in tpool._replicas and "edge" not in tpool._replicas
    assert_allclose(got.numpy(), want, **TOL)


def test_measure_feeds_the_latency_model():
    _, tpool = _pools()
    measured = tpool.measure()
    assert set(measured) == {"device", "edge", "cloud"}
    for tier, m in measured.items():
        assert isinstance(m, EngineMeasurement)
        assert m.batch_size == tpool.specs[tier].batch_size
        assert m.prompt_len == 12 and m.prefill_ms > 0.0
    lat = LatencyModel.from_measurements(measured)
    for tier in tpool.tiers:
        assert lat.infer_ms(tier) == measured[tier].prefill_ms
        assert lat.infer_ms(tier, occupancy=100) > lat.infer_ms(tier)


def test_pool_runs_on_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rep.ReplicaPool()
    pool = rep.ReplicaPool(device="cpu")
    assert pool.device.type == "cpu"
    pred = pool.dispatch("device", np.zeros((1, 12, 1)))
    assert pred.shape == (1, 1)


def test_lm_paths_wait_for_their_slice():
    """The LM tiers serve every family, the default one (xlstm-125m, as
    in JAX) included; the GRU tiers have no engine."""
    _, tpool = _pools()
    with pytest.raises(TypeError):
        tpool.engine("device")
    assert [s.arch for s in rep.lm_tiers()] == ["xlstm-125m"] * 3
    xl = rep.ReplicaPool(rep.lm_tiers(max_len=32), device="cpu")
    out = xl.dispatch("edge", np.zeros((1, 6), np.int64), steps=3)
    assert out.shape == (1, 3)
    assert xl.engine("edge").cfg.model.family == "ssm"
    with pytest.raises(ValueError):
        rep.ReplicaPool([rep.TierSpec("fog")], device="cpu")
    lm = rep.ReplicaPool([rep.TierSpec("edge", arch="stablelm-1.6b",
                                       max_len=32)], device="cpu")
    assert lm.engine("edge").batch_size == 1


def test_pool_without_shared_params_serves_one_model_everywhere():
    pool = rep.ReplicaPool(seed=3, device="cpu")
    w = np.random.default_rng(0).normal(size=(1, 12, 1))
    preds = [pool.dispatch(t, w) for t in pool.tiers]
    assert all(torch.equal(preds[0], p) for p in preds[1:])


def test_slice_fedavg_then_serve_matches_jax():
    """The slice as a whole: stacked client replicas -> cluster and
    global FedAvg (with an empty cluster id) -> the global model served
    from every tier."""
    ids = np.array([0, 0, 0, 2, 2, 3])
    sizes = np.array([120.0, 80.0, 200.0, 50.0, 90.0, 300.0])
    clients = [_shared(seed=s) for s in range(len(ids))]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *clients)
    jglob = jagg.global_fedavg(jax.tree.map(jnp.asarray, stacked), ids, sizes)
    tglob = agg.global_fedavg(from_numpy_tree(stacked, "cpu"), ids, sizes)
    jmodel = jax.tree.map(lambda x: np.asarray(x[0]), jglob)
    tmodel = jax.tree.map(lambda x: x[0], tglob)
    jpool = jrep.ReplicaPool(shared_params=jax.tree.map(jnp.asarray, jmodel))
    tpool = rep.ReplicaPool(shared_params=tmodel, device="cpu")
    r = np.random.default_rng(9)
    for tier, B in (("device", 1), ("edge", 4), ("cloud", 16)):
        w = r.normal(size=(B, 12, 1))
        assert_allclose(tpool.dispatch(tier, w).numpy(),
                        np.asarray(jpool.dispatch(tier, w)), **TOL)


# ---------------------------------------------------------------------------
# LM tiers: reduced stablelm-1.6b, dense and paged engines
# ---------------------------------------------------------------------------

def _lm_shared(seed=0):
    """Reduced stablelm weights from the JAX package, cast to fp32 (the
    tiers keep the config's bf16 caches)."""
    from repro.models import make_model as jax_make_model
    cfg = jax_get_config("stablelm-1.6b").reduced()
    params, _ = jax_make_model(cfg).init_params(jax.random.key(seed))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _lm_pools(paged, shared=None):
    shared = _lm_shared() if shared is None else shared
    jspecs = (jrep.paged_lm_tiers(max_len=64) if paged
              else jrep.lm_tiers("stablelm-1.6b", max_len=64))
    tspecs = (rep.paged_lm_tiers(max_len=64) if paged
              else rep.lm_tiers("stablelm-1.6b", max_len=64))
    assert [dataclasses.asdict(s) for s in tspecs] == \
        [dataclasses.asdict(s) for s in jspecs]
    jpool = jrep.ReplicaPool(jspecs, shared_params=jax.tree.map(
        jnp.asarray, shared))
    tpool = rep.ReplicaPool(tspecs, shared_params=shared, device="cpu")
    return jpool, tpool


def test_lm_tier_layouts_match_jax():
    for fn in ("lm_tiers", "paged_lm_tiers"):
        assert ([dataclasses.asdict(s) for s in getattr(rep, fn)()]
                == [dataclasses.asdict(s) for s in getattr(jrep, fn)()])
    assert [s.batch_size for s in rep.lm_tiers()] == [1, 4, 8]
    assert [(s.batch_size, s.num_pages) for s in rep.paged_lm_tiers()] == \
        [(4, 16), (16, 64), (32, 128)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tier,B", [("device", 1), ("edge", 3),
                                    ("cloud", 4)])
def test_lm_dispatch_matches_jax(paged, tier, B):
    jpool, tpool = _lm_pools(paged)
    prompts = np.random.default_rng(B).integers(0, 1024, (B, 11))
    want = np.asarray(jpool.dispatch(tier, prompts, steps=5))
    got = tpool.dispatch(tier, prompts, steps=5)
    assert got.shape == (B, 5) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    eng = tpool.engine(tier)
    assert isinstance(eng, rep.PagedServeEngine if paged else rep.ServeEngine)
    assert eng.batch_size == tpool.specs[tier].batch_size


@pytest.mark.parametrize("paged", [False, True])
def test_lm_failover_from_a_down_edge_goes_to_the_cloud(paged):
    jpool, tpool = _lm_pools(paged)
    prompts = np.random.default_rng(7).integers(0, 1024, (2, 9))
    eng = tpool.engine("edge")
    slot = eng.acquire_slot()
    eng.admit(prompts[0], slot=slot)             # in flight when it crashes
    for pool in (jpool, tpool):
        pool.engine("edge")
    assert tpool.mark_down("edge") == [slot]
    assert jpool.mark_down("edge") == []
    if paged:
        assert eng.pool.free_pages == eng.num_pages
    got = tpool.dispatch("edge", prompts, steps=4)   # served by the cloud
    want = np.asarray(jpool.dispatch("edge", prompts, steps=4))
    assert tpool.failovers == jpool.failovers == 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tpool.engine("cloud").generate(prompts, 4).numpy())


@pytest.mark.parametrize("paged", [False, True])
def test_lm_measure_feeds_the_latency_model(paged):
    """Per-tier timings into the latency model; the occupancy sweep
    reaches the levels the JAX pool reaches (the slot or page budget
    stops it at the same place)."""
    jpool, tpool = _lm_pools(paged)
    kw = dict(prompt_len=8, decode_steps=2, occupancy_levels=(1, 4, 8))
    measured = tpool.measure(**kw)
    jmeasured = jpool.measure(**kw)
    assert set(measured) == {"device", "edge", "cloud"}
    for tier, m in measured.items():
        assert m.batch_size == tpool.specs[tier].batch_size
        assert m.prompt_len == 8 and m.prefill_ms > 0.0
        assert [lvl for lvl, _ in m.occupancy_ms] == \
            [lvl for lvl, _ in jmeasured[tier].occupancy_ms]
        assert all(ms > 0.0 for _, ms in m.occupancy_ms)
    lat = LatencyModel.from_measurements(measured, decode_tokens=2)
    for tier in tpool.tiers:
        assert lat.infer_ms(tier) > 0.0
