"""The roofline and MFU arithmetic on hand-worked shapes."""
import json

import pytest

import tiny
from benchkit.spec import BENCH_DIR
from roofline import model, peaks, work


def test_paged_work_by_hand():
    # rows of 1, 17 and 0 tokens, pages of 16, 4 pages a row: 18 counted
    # tokens, the empty row reads all 64 slots, 1 + 2 + 4 table entries
    assert work.paged_work([1, 17, 0], 16, 4) == (18, 64, 7)
    # a window of 8 over 17 tokens counts 8, on pages 0..1
    assert work.paged_work([17], 16, 4, window=8) == (8, 0, 2)


def test_paged_mla_decode_by_hand():
    nbytes, flops = work.paged_mla_decode([1, 17, 0], 16, 4, H=2, R=8, Dr=2)
    assert nbytes == 2 * (3 * 2 * 18 + 18 * 10 + 64 * 8) + 40 == 1640
    assert flops == (18 * 18 + 64 * 8) * 2 * 2 == 3344


def test_flash_by_hand():
    nbytes, flops = work.flash(BH=2, BHkv=1, T=3, D=4, Dv=4)
    assert nbytes == 2 * (2 * 3 * 8 + 3 * 8) == 144
    assert flops == 2 * (2 * 6) * 8 == 192
    _, full = work.flash(BH=2, BHkv=1, T=3, D=4, Dv=4, causal=False)
    assert full == 2 * (2 * 9) * 8


def test_bound():
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12, peaks.FP32_FLOP_PER_S) == pytest.approx(1.0)


def test_model_flops_tiny_by_hand():
    c = tiny.stablelm()          # d 64, 4 heads of 16, ff 128, 2 layers
    per_layer = 4 * 64 * 64 + 3 * 64 * 128
    assert model.matmul_params(c) == 2 * per_layer == 81920
    # scores and values: 2 * ctx * heads * (16 + 16) * layers
    assert model.decode_token_flops(c, 10) == \
        2 * 81920 + 2 * 10 * 4 * 32 * 2 + 2 * 64 * 512
    assert model.prefill_flops(c, 3) == \
        2 * 81920 * 3 + 2 * 6 * 4 * 32 * 2 + 2 * 64 * 512


def _cfg(name):
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_model_params_published():
    """stablelm's layers hold 1.23 B product weights (24 x (4 d^2 + 3 d
    ff)); deepseek-v2-lite activates 2.4 B of its 15.7 B a token: 2.24 B
    in the layers' products and 0.21 B in the head."""
    s = _cfg("stablelm-1.6b")
    assert model.matmul_params(s) == 24 * (4 * 2048 ** 2 + 3 * 2048 * 5632)
    d = _cfg("deepseek-v2-lite-16b")
    assert 2.2e9 < model.matmul_params(d) < 2.3e9
    assert 2.35e9 < model.matmul_params(d) + 2048 * 102400 < 2.5e9
