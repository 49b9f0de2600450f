"""The port's continuous-batching scheduler (a copy of
``repro/serving/scheduler.py``) on the port's engines against JAX's
scheduler on JAX's engines, and the port's serve launcher.

The same Poisson requests (prompts of 13 to 20 tokens, 3 to 6 new
tokens each) go through both on the 6-layer gemma3 cut of
``tests/test_torch_gemma3.py``, dense and paged (a page budget that
gates admission), with a crash part way (``requeue_active``).  The
scheduler's clock adds the wall time of each admit and decode; both
runs read one fake clock that advances a fixed step a reading, so the
two interleave arrivals and service the same way.  Per request the
tokens, and per run the slot reuses, peak occupancy and requeues, are
equal; so are the ``serve.*`` counters and spans and the
``page_pool.*`` gauges of a ``Telemetry`` attached to each engine."""
import dataclasses
import importlib.util
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import page_pool as jpp  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.workload import poisson_requests  # noqa: E402
from repro.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (PagedServeEngine, ServeEngine,  # noqa: E402
                                 page_pool, scheduler)
from repro_torch.telemetry import Telemetry  # noqa: E402

#: virtual seconds a clock reading advances: an admit or a decode step
#: (two readings) takes 5 ms, against arrivals at 40 requests a second
CLOCK_STEP = 0.005


class FakeClock:
    """``time`` for a scheduler module: ``perf_counter`` advances
    ``CLOCK_STEP`` a reading."""

    def __init__(self):
        self._ticks = itertools.count()

    def perf_counter(self):
        return next(self._ticks) * CLOCK_STEP


def _cut(cfg):
    """gemma3's 6-layer cut: fp32, window 8."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, num_layers=6, dtype="float32", param_dtype="float32",
        attention=dataclasses.replace(m.attention, window=8)))


@pytest.fixture(scope="module")
def gemma():
    """(JAX cfg, port cfg, JAX params, numpy params)."""
    jcfg = _cut(jax_get_config("gemma3-1b").reduced())
    tcfg = _cut(get_config("gemma3-1b").reduced())
    params, _ = jax_make_model(jcfg).init_params(jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def requests(module, vocab, seed=0):
    """Poisson arrivals at 40/s over 0.5 s, each request its own prompt
    length (13..20) and budget (3..6 new tokens)."""
    events = poisson_requests(np.full(4, 10.0), duration_s=0.5, seed=seed)
    r = np.random.default_rng(seed)
    return [module.Request(id=k, arrival_s=ev.t,
                           prompt=r.integers(0, vocab, int(r.integers(13, 21))),
                           max_new_tokens=int(r.integers(3, 7)))
            for k, ev in enumerate(events)]


def serve(module, engine, reqs, crash_after):
    """Admit and decode ``crash_after`` rounds, requeue every in-flight
    request (a crash), then run to the end."""
    sched = module.ContinuousBatchingScheduler(engine)
    for r in sorted(reqs, key=lambda r: r.arrival_s):
        sched.submit(r)
    now = 0.0
    for _ in range(crash_after):
        now = sched._admit_ready(max(now, sched.queue[0].arrival_s)
                                 if not sched.active else now)
        if sched.active:
            now = sched._decode_once(now)
    requeued = sched.requeue_active(now)
    stats = sched.run([])
    return sched, stats, requeued


def engines(gemma, paged, tel, jtel):
    jcfg, tcfg, params, npp = gemma
    if paged:
        kw = dict(max_seqs=4, page_size=4, num_pages=24, max_len=32)
        return (PagedServeEngine(tcfg, npp, device="cpu", telemetry=tel,
                                 **kw),
                jeng.PagedServeEngine(jcfg, params, telemetry=jtel, **kw))
    return (ServeEngine(tcfg, npp, batch_size=3, max_len=32, device="cpu",
                        telemetry=tel),
            jeng.ServeEngine(jcfg, params, batch_size=3, max_len=32,
                             telemetry=jtel))


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_matches_jax_per_request(monkeypatch, gemma, paged):
    vocab = gemma[1].model.vocab_size
    tel, jtel = Telemetry(), JaxTelemetry()
    eng, jeng_ = engines(gemma, paged, tel, jtel)
    out = {}
    for name, module, e in (("port", scheduler, eng),
                            ("jax", jsched, jeng_)):
        monkeypatch.setattr(module, "time", FakeClock())
        out[name] = serve(module, e, requests(module, vocab), crash_after=4)
    (sched, stats, requeued), (jsched_, jstats, jrequeued) = \
        out["port"], out["jax"]
    assert requeued == jrequeued > 0
    assert sched.requeues == jsched_.requeues == requeued
    assert len(sched.completed) == len(jsched_.completed) == \
        len(requests(scheduler, vocab))
    got = {r.id: r for r in sched.completed}
    want = {r.id: r for r in jsched_.completed}
    assert sorted(got) == sorted(want)
    for k, r in got.items():
        assert r.tokens == want[k].tokens
        assert len(r.tokens) == r.max_new_tokens
        assert (r.t_first_token, r.t_done) == \
            (want[k].t_first_token, want[k].t_done)
    assert (stats.slot_reuses, stats.peak_occupancy) == \
        (jstats.slot_reuses, jstats.peak_occupancy)
    assert stats.slot_reuses > 0
    np.testing.assert_array_equal(stats.ttft_ms, jstats.ttft_ms)
    np.testing.assert_array_equal(stats.tpot_ms, jstats.tpot_ms)
    assert stats.tokens_generated == jstats.tokens_generated
    # telemetry: the same counters and gauges, and the same spans
    snap, jsnap = tel.metrics.snapshot(), jtel.metrics.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    counters = snap["counters"]
    assert counters["serve.admissions"] == \
        len(sched.completed) + requeued
    assert counters["serve.evictions"] == counters["serve.admissions"]
    names = sorted(s.name for s in tel.tracer.spans)
    assert names == sorted(s.name for s in jtel.tracer.spans)
    assert names.count("serve.admit") == counters["serve.admissions"]
    if paged:
        assert set(snap["gauges"]) == {
            "page_pool.free_pages", "page_pool.allocated_pages",
            "page_pool.occupancy", "page_pool.internal_fragmentation",
            "page_pool.sequences"}
        assert snap["gauges"]["page_pool.free_pages"] == 24
        eng.pool.check_invariants()


def test_engines_hand_the_scheduler_host_values(gemma):
    """The scheduler's clock stops after ``admit`` and ``decode`` return;
    they return an ``int`` and a numpy array, which on the card exist only
    once the step's kernels are done."""
    _, tcfg, _, npp = gemma
    for eng in (ServeEngine(tcfg, npp, batch_size=2, max_len=32,
                            device="cpu"),
                PagedServeEngine(tcfg, npp, max_seqs=2, page_size=4,
                                 max_len=32, device="cpu")):
        first = eng.admit(np.arange(14), slot=eng.acquire_slot())
        assert type(first) is int
        toks = eng.decode()
        assert isinstance(toks, np.ndarray) and toks.dtype == np.int32


def test_measure_records_its_span_and_counts(gemma):
    """``measure()`` under telemetry: one ``serve.measure`` span around
    the probe's admissions and steps, as in JAX."""
    jcfg, tcfg, params, npp = gemma
    tel, jtel = Telemetry(), JaxTelemetry()
    eng, jeng_ = engines(gemma, True, tel, jtel)
    for e in (eng, jeng_):
        e.measure(prompt_len=10, decode_steps=2, occupancy_levels=(1, 2))
    snap, jsnap = tel.metrics.snapshot(), jtel.metrics.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    spans = [s for s in tel.tracer.spans if s.name == "serve.measure"]
    assert len(spans) == 1
    assert spans[0].args == {"prompt_len": 10, "decode_steps": 2}


def test_disabled_telemetry_records_nothing(gemma):
    _, tcfg, _, npp = gemma
    tel = Telemetry(enabled=False)
    eng = PagedServeEngine(tcfg, npp, max_seqs=2, page_size=4, max_len=32,
                           device="cpu", telemetry=tel)
    eng.generate(np.arange(14)[None], 3)
    assert eng._tel is None and eng.pool._tel is None
    assert tel.metrics.snapshot()["counters"] == {}
    assert not tel.tracer.spans


@pytest.mark.parametrize("seed", [0, 1])
def test_page_pool_gauges_match_jax_through_churn(seed):
    """The page pool's five gauges after every step of a seeded churn of
    allocate, extend and release."""
    r = np.random.default_rng(seed)
    tel, jtel = Telemetry(), JaxTelemetry()
    pools = (page_pool.PagePool(16, 4, telemetry=tel),
             jpp.PagePool(16, 4, telemetry=jtel))
    for _ in range(60):
        op, seq, n = int(r.integers(3)), int(r.integers(5)), \
            int(r.integers(1, 9))
        for pool in pools:
            try:
                if op == 0:
                    pool.allocate(seq, n)
                elif op == 1:
                    pool.extend(seq, pool.length(seq) + n)
                else:
                    pool.release(seq)
            except (KeyError, ValueError, page_pool.PagesExhausted,
                    jpp.PagesExhausted):
                pass
        assert tel.metrics.snapshot()["gauges"] == \
            jtel.metrics.snapshot()["gauges"]


def test_serve_launcher_runs_on_the_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--requests", "8", "--slots", "4",
                      "--prompt-len", "12", "--decode-steps", "4"])
    assert out["completed"] == out["requests"] > 0
    assert out["stats"].tokens_generated == 4 * out["requests"]
    assert out["measurement"].batch_size == 4
    assert np.isfinite(out["latency"].infer_ms("edge"))


def test_tiered_serving_example_runs_its_steps_on_the_cpu():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "tiered_serving_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_serving_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu"])
    assert out["requests"] > 0
    assert out["stats"].tokens_generated == 8 * out["requests"]
    for tier in ("device", "edge", "cloud"):
        assert 0 < out["latency"].infer_ms(tier) < float("inf")
    for logs in out["logs"].values():
        assert set(logs) == {"flat", "hflop"}
        assert all(np.isfinite(log.mean_latency()) for log in logs.values())
