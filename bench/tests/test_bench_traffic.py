"""The traffic generator repeats from its seed, draws in its stated
ranges, and gives every seed the same multiset of lengths."""
import numpy as np
import pytest

import tiny
from benchkit import serve
from benchkit.spec import BENCH_DIR
from benchkit.traffic import closed_loop, draw_lengths
import json


def _mix(name):
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("dist,lo,hi", [
    ({"dist": "loguniform", "lo": 1024, "hi": 3072}, 1024, 3072),
    ({"dist": "loguniform", "lo": 128, "hi": 512}, 128, 512),
    ({"dist": "fixed", "value": 77}, 77, 77)])
def test_lengths_in_range(dist, lo, hi):
    x = draw_lengths(dist, 20000, np.random.default_rng(3))
    assert x.min() >= lo and x.max() <= hi
    if lo < hi:
        # log-uniform: the geometric midpoint splits the mass in half
        mid = np.sqrt(lo * hi)
        assert abs(np.mean(x < mid) - 0.5) < 0.02


def test_unknown_distribution_raises():
    with pytest.raises(ValueError):
        draw_lengths({"dist": "zipf"}, 3, np.random.default_rng(0))


@pytest.mark.parametrize("mix", ["decode-long"])
def test_closed_loop_repeats_and_orders(mix):
    t = _mix(mix)
    seed = 2 ** 31 + 977          # above 32 signed bits
    a = closed_loop(t, 8, 1000, seed)
    b = closed_loop(t, 8, 1000, seed)
    c = closed_loop(t, 8, 1000, seed + 1)
    flat = lambda x: [(q.client, q.index, q.max_new_tokens,
                       q.prompt.tolist()) for r in x for q in r]
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)
    sizes = lambda x: sorted((len(q.prompt), q.max_new_tokens)
                             for r in x for q in r)
    # another seed serves the same sizes in another order
    assert sizes(a) == sizes(c)
    for r in a:
        for q in r:
            assert t["prompt_len"]["lo"] <= len(q.prompt) <= t["prompt_len"]["hi"]
            assert t["output_len"]["lo"] <= q.max_new_tokens <= t["output_len"]["hi"]
            assert q.prompt.min() >= 1 and q.prompt.max() < 1000


def test_buckets():
    assert serve.reachable_buckets(1024, 3072) == [1024, 2048, 4096]
    assert serve.reachable_buckets(20, 60) == [32, 64]
    assert serve.reachable_buckets(512, 3584) == [512, 1024, 2048, 4096]


def test_mix_fits_the_cache():
    """Every prompt plus its outputs fits a row's max_len."""
    for cfg in ("stablelm-1.6b", "deepseek-v2-lite-16b"):
        with open(BENCH_DIR / "configs" / f"{cfg}.json") as f:
            c = json.load(f)
        t = _mix("decode-long")
        assert t["prompt_len"]["hi"] + t["output_len"]["hi"] \
            <= c["serve"]["max_len"]
    t = tiny.mix()
    assert t["prompt_len"]["hi"] + t["output_len"]["hi"] \
        <= tiny.stablelm()["serve"]["max_len"]


def test_window_closes_before_a_slot_is_taken():
    """At the deadline the proxy raises before the engine gives out a
    slot, so no slot is left taken and never admitted when the window
    closes."""
    from types import SimpleNamespace
    taken = []
    engine = SimpleNamespace(batch_size=2,
                             acquire_slot=lambda: taken.append(0) or 0)
    log = serve.ServeLog(t_start=0.0, deadline=0.0)
    proxy = serve.EngineProxy(engine, log, lambda slot: None)
    with pytest.raises(serve.WindowClosed):
        proxy.acquire_slot()
    assert taken == []
    log.deadline = float("inf")
    assert proxy.acquire_slot() == 0 and taken == [0]
