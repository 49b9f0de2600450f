"""The port keeps its own copies of the JAX package's numpy-only config
and latency modules; these tests keep the copies in step."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import base as jax_base  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.routing import latency as jax_latency  # noqa: E402
from repro.serving.engine import EngineMeasurement as JaxMeasurement  # noqa: E402
from repro_torch.configs import base, get_config  # noqa: E402
from repro_torch.routing import latency  # noqa: E402
from repro_torch.serving.engine import EngineMeasurement  # noqa: E402

CLASSES = ["MLAConfig", "AttentionConfig", "MoEConfig", "SSMConfig",
           "XLSTMConfig", "FrontendConfig", "ModelConfig", "InputShape",
           "RunConfig", "ArchConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_dataclasses_have_the_same_fields(name):
    def fields(cls):
        return [(f.name, str(f.type), f.default) for f in
                dataclasses.fields(cls)]
    assert fields(getattr(base, name)) == fields(getattr(jax_base, name))


@pytest.mark.parametrize("reduced", [False, True])
def test_gru_traffic_config_is_the_same(reduced):
    j, t = jax_get_config("gru-traffic"), get_config("gru-traffic")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()


@pytest.mark.parametrize("reduced", [False, True])
def test_stablelm_config_is_the_same(reduced):
    j, t = jax_get_config("stablelm-1.6b"), get_config("stablelm-1.6b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()
    if not reduced:
        m = t.model
        assert (m.num_layers, m.d_model, m.d_ff, m.padded_vocab) == \
            (24, 2048, 5632, 100_352)
        assert m.param_count() == 1_644_167_168


def test_registry_knows_only_ported_configs():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("xlstm-125m")


def test_engine_measurement_has_the_same_fields():
    assert ([f.name for f in dataclasses.fields(EngineMeasurement)]
            == [f.name for f in dataclasses.fields(JaxMeasurement)])


@pytest.mark.parametrize("sweep", [False, True])
def test_calibrated_latency_model_is_the_same(sweep):
    occ = ((1, 0.5), (4, 0.9), (16, 2.5)) if sweep else ()
    meas = {"device": (0.3, 1), "edge": (0.4, 4), "cloud": (0.6, 16)}
    tm = {t: EngineMeasurement(p, 0.1, b, 12, 0, occ)
          for t, (p, b) in meas.items()}
    jm = {t: JaxMeasurement(p, 0.1, b, 12, 0, occ)
          for t, (p, b) in meas.items()}
    kw = dict(decode_tokens=4 if sweep else 0, cloud_speedup=0.3)
    t_lat = latency.LatencyModel.from_measurements(tm, **kw)
    j_lat = jax_latency.LatencyModel.from_measurements(jm, **kw)
    occupancy = np.arange(0, 40, 0.5)
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for tier in ("device", "edge", "cloud"):
        assert t_lat.infer_ms(tier, 3.0) == j_lat.infer_ms(tier, 3.0)
        assert np.array_equal(t_lat.infer_ms_array(tier, occupancy),
                              j_lat.infer_ms_array(tier, occupancy))
        assert (t_lat.flat_service_slots(tier)
                == j_lat.flat_service_slots(tier))
        assert np.array_equal(t_lat.rtt(tier, rng_t, 5),
                              j_lat.rtt(tier, rng_j, 5))
