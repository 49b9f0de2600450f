"""The port's copy of the page pool (``repro_torch.serving.page_pool``,
numpy only; its telemetry gauges are held against JAX's in
``tests/test_torch_scheduler.py``) against
``repro.serving.page_pool`` through the same seeded churn of allocate,
extend and release: every block table and free count agree."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import page_pool as jpp  # noqa: E402
from repro_torch.serving import page_pool as tpp  # noqa: E402


def _state(pool):
    return (pool.free_pages, pool.allocated_pages, pool.sequences,
            {s: pool.block_table(s) for s in pool.sequences},
            {s: pool.length(s) for s in pool.sequences},
            pool.occupancy, pool.internal_fragmentation)


def _apply(pool, op, seq, n):
    """One churn step; returns what it did, exceptions included."""
    try:
        if op == 0:
            return ("alloc", pool.allocate(seq, n))
        if op == 1:
            return ("extend", pool.extend(seq, pool.length(seq) + n))
        return ("release", pool.release(seq))
    except (jpp.PagesExhausted, tpp.PagesExhausted) as e:
        return ("exhausted", type(e).__name__)
    except (KeyError, ValueError) as e:
        return ("refused", type(e).__name__)


@pytest.mark.parametrize("seed,num_pages,page_size", [(0, 16, 4), (1, 64, 16),
                                                      (2, 5, 8)])
def test_churn_agrees_with_the_jax_pool(seed, num_pages, page_size):
    r = np.random.default_rng(seed)
    j, t = jpp.PagePool(num_pages, page_size), tpp.PagePool(num_pages,
                                                            page_size)
    for _ in range(300):
        op, seq, n = int(r.integers(3)), int(r.integers(6)), \
            int(r.integers(0, 3 * page_size))
        assert _apply(t, op, seq, n) == _apply(j, op, seq, n)
        assert _state(t) == _state(j)
        t.check_invariants()
    snap = t.snapshot()
    assert snap == j.snapshot()
    t.allocate(99, 1) if t.free_pages else None
    t.restore(snap)
    assert _state(t) == _state(j)


def test_misuse_raises_like_the_jax_pool():
    with pytest.raises(ValueError):
        tpp.PagePool(0, 4)
    pool = tpp.PagePool(4, 4)
    pool.allocate(0, 5)
    with pytest.raises(ValueError, match="already"):
        pool.allocate(0, 1)
    with pytest.raises(ValueError, match="shrink"):
        pool.extend(0, 1)
    with pytest.raises(KeyError):
        pool.extend(7, 1)
    pool.release(0)
    with pytest.raises(KeyError):
        pool.release(0)
    assert pool.pages_for(0) == 0 and pool.pages_for(5) == 2
