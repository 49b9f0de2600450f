"""The rest of a run without the look for a chip, at a tiny size on the
CPU: sound, it comes out correct; with the timed path broken underneath
(``benchkit/faults.py``: a token altered where it is produced, the decode
attention left out, the router picking other experts; a training step
returning its state unchanged, half of the batch left out, the sync
between the clusters left out) ``correct`` comes out false.  The limits
are the cells' own."""
import json
import time

import pytest

import tiny
from benchkit import cell_serve, cell_train, faults
from benchkit.spec import BENCH_DIR, Cell

SEED = 2 ** 31 + 5


def _cell(make, mix, name):
    with open(BENCH_DIR / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name=name, config=make(), traffic=mix(), limits=limits,
                chips=1, end_to_end=[], per_layer=[])


SERVE = {"deepseek": (tiny.deepseek, "deepseek-v2-lite-16b.decode-long")}
# the training cell's limits hold bf16 at full width; at this width the
# program trains in float32, so a sound run reads ~1e-6
TRAIN = (lambda: tiny.stablelm("float32"), "stablelm-1.6b.hfl-train")


def _serve(name):
    make, cell = SERVE[name]
    return cell_serve.run(_cell(make, tiny.mix, cell), SEED, 4.0, False,
                          "cpu", time.perf_counter())


def _train():
    return cell_train.run(_cell(TRAIN[0], tiny.train_mix, TRAIN[1]), SEED,
                          1.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", sorted(SERVE))
def test_sound_serving_run_is_correct(name):
    out = _serve(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["run"].log.calls


@pytest.mark.parametrize("name,fault", [
    ("deepseek", "altered_token"), ("deepseek", "no_decode_attention"),
    ("deepseek", "other_experts")])
def test_serving_fault_is_caught(name, fault):
    plant = {**faults.SERVING, **faults.MOE}[fault]
    with faults.planted(plant):
        out = _serve(name)
    assert not out["correct"], out["checks"]


def test_sound_training_run_is_correct():
    out = _train()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_caught(fault):
    with faults.planted(faults.TRAINING[fault]):
        out = _train()
    assert not out["correct"], out["checks"]


def test_faults_are_undone():
    from repro_torch.serving import engine
    before = engine._argmax
    with faults.planted(faults.altered_token):
        assert engine._argmax is not before
    assert engine._argmax is before
