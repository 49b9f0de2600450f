"""On the card only: the kernel names the per-layer readers match
(``KERNELS`` in bench/metrics/*_roofline.py) are the names the profiler
records for the port's kernels, so a roofline cannot go silent by a
rename.  Skips without a CUDA device (decided inside the fixture)."""
import pytest
import torch

from benchkit import program  # noqa: F401  (puts the port on the path)
from benchkit.devtrace import DeviceTrace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program.load_kernels()
    return torch.device("cuda")


def _names(fn):
    t = DeviceTrace()
    t.start()
    fn()
    t.stop()
    return [n for n, _, _ in t.summary().kernels]


def _patterns(metric):
    import importlib.util
    from benchkit.spec import BENCH_DIR
    spec = importlib.util.spec_from_file_location(
        "m", BENCH_DIR / "metrics" / f"{metric}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.KERNELS


@pytest.mark.cuda
def test_kernel_names_match(card):
    from repro_torch.kernels import ops
    g = torch.Generator(device=card).manual_seed(0)
    bf = dict(device=card, dtype=torch.bfloat16)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, **bf)

    B, D, ps, P = 4, 64, 16, 8
    bt = torch.arange(B * P, device=card, dtype=torch.int32).view(B, P)
    lens = torch.full((B,), 100, device=card, dtype=torch.int32)
    cases = {
        "paged_mla_decode_roofline": lambda: ops.paged_mla_decode_attention(
            rnd(B, 16, 512), rnd(B, 16, 64), rnd(B * P + 1, ps, 512),
            rnd(B * P + 1, ps, 64), bt, lens, scale=0.07),
        "flash_train_roofline": lambda: ops.flash_attention(
            rnd(8, 256, D), rnd(8, 256, D), rnd(8, 256, D), causal=True),
        "fedavg_reduce_roofline": lambda: ops.fedavg_reduce(
            rnd(2, 4096), torch.ones(2, device=card)),
    }
    for metric, call in cases.items():
        names = _names(call)
        assert any(p in n for n in names for p in _patterns(metric)), \
            (metric, names)
