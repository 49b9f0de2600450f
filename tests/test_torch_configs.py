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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_configs_are_the_same(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()
    assert t.model.active_param_count() == j.model.active_param_count()


@pytest.mark.parametrize("arch", ["gemma3-1b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_dense_configs_are_the_same(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()


def test_gemma3_config_is_the_published_shape():
    m = get_config("gemma3-1b").model
    a = m.attention
    assert (m.family, m.num_layers, m.d_model, m.d_ff, m.padded_vocab,
            m.act, m.tie_embeddings, m.embed_scale) == \
        ("dense", 26, 1152, 6912, 262_144, "gelu", True, True)
    assert (a.kind, a.num_heads, a.num_kv_heads, a.head_dim, a.window,
            a.local_global_ratio, a.rope_theta, a.rope_theta_local,
            a.qk_norm, a.logit_soft_cap) == \
        ("local_global", 4, 1, 256, 512, 5, 1e6, 1e4, True, 0.0)
    assert m.param_count() == 792_723_456


def test_deepseek_config_is_the_published_shape():
    m = get_config("deepseek-v2-lite-16b").model
    a, mo = m.attention, m.moe
    assert (m.family, m.num_layers, m.d_model, m.vocab_size) == \
        ("moe", 27, 2048, 102_400)
    assert (a.kind, a.num_heads, a.mla.kv_lora_rank, a.mla.q_lora_rank,
            a.mla.qk_nope_head_dim, a.mla.qk_rope_head_dim,
            a.mla.v_head_dim) == ("mla", 16, 512, 0, 128, 64, 128)
    assert (mo.num_experts, mo.top_k, mo.d_expert, mo.num_shared,
            mo.d_shared, mo.first_dense_layers, mo.dense_d_ff,
            mo.capacity_factor) == (64, 6, 1408, 2, 2816, 1, 10_944, 1.25)
    assert m.param_count() == 15_706_357_760
    # the reduced variant the CPU tests run
    r = get_config("deepseek-v2-lite-16b").reduced().model
    assert (r.num_layers, r.d_model, r.moe.num_experts, r.moe.top_k,
            r.attention.mla.kv_lora_rank) == (2, 256, 4, 2, 32)


@pytest.mark.parametrize("reduced", [False, True])
def test_zamba2_config_is_the_same(reduced):
    j, t = jax_get_config("zamba2-1.2b"), get_config("zamba2-1.2b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()


def test_zamba2_config_is_the_published_shape():
    m = get_config("zamba2-1.2b").model
    a, s = m.attention, m.ssm
    assert (m.family, m.num_layers, m.d_model, m.d_ff, m.padded_vocab,
            m.shared_attn_every, m.tie_embeddings) == \
        ("hybrid", 38, 2048, 8192, 32_000, 6, True)
    assert (a.kind, a.num_heads, a.num_kv_heads, a.head_dim, a.window) == \
        ("full", 32, 32, 64, 4096)
    assert (s.state_dim, s.head_dim, s.expand, s.conv_width, s.chunk,
            s.ngroups) == (64, 64, 2, 4, 128, 1)
    # the reduced variant the CPU tests run: ArchConfig.reduced() cuts
    # ssm and shared_attn_every as the JAX one does
    r = get_config("zamba2-1.2b").reduced().model
    assert (r.num_layers, r.d_model, r.ssm.state_dim, r.ssm.head_dim,
            r.ssm.chunk, r.shared_attn_every) == (2, 256, 16, 16, 32, 2)
    assert (r.attention.num_heads, r.attention.num_kv_heads,
            r.attention.head_dim, r.attention.window) == (4, 2, 32, 64)


def _tree_size(tree) -> int:
    from repro_torch.params import flatten_with_path
    return sum(int(np.prod(x.shape)) for _, x in flatten_with_path(tree))


def test_zamba2_tree_size():
    """``param_count()`` is coarse for the hybrid: the JAX tree at full
    width holds 1,104,937,856 weights (38 Mamba2 layers of 25,586,496,
    the shared block's 67,112,960, the tied embedding and the final
    norm), and the port's tree is the JAX tree leaf for leaf (the reduced
    tree counted here; chip_smoke.py counts the full one on the card)."""
    import jax
    import torch
    from repro.models import make_model as jax_make_model
    from repro_torch.models import make_model

    def jax_size(cfg):
        shapes = jax.eval_shape(
            lambda k: jax_make_model(cfg).init_params(k)[0],
            jax.random.key(0))
        return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))

    full = jax_get_config("zamba2-1.2b")
    assert jax_size(full) == 1_104_937_856
    assert full.model.param_count() == 1_109_666_816
    cfg = get_config("zamba2-1.2b").reduced()
    tree = make_model(cfg).init_params(torch.Generator().manual_seed(0),
                                       "cpu")
    assert _tree_size(tree) == jax_size(jax_get_config("zamba2-1.2b")
                                        .reduced())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b",
                                  "qwen2-moe-a2.7b", "gemma3-1b",
                                  "h2o-danube-1.8b"])
def test_tree_counts_param_count_plus_norms(arch):
    """The port's tree holds ``param_count()`` weights plus the norms'
    scales (and LayerNorm biases, MLA's kv_norm, and QK-norm's per-layer
    q_norm and k_norm), which the count leaves out: the check
    chip_smoke.py makes at full width."""
    import torch
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    cfg = get_config(arch).reduced()
    m = cfg.model
    tree = make_model(cfg).init_params(torch.Generator().manual_seed(0),
                                       "cpu")
    norms = (2 * m.num_layers + 1) * m.d_model * (
        2 if m.norm == "layernorm" else 1)
    if m.attention.kind == "mla":
        norms += m.num_layers * m.attention.mla.kv_lora_rank
    if m.attention.qk_norm:
        norms += 2 * m.num_layers * m.attention.head_dim
    assert sum(x.numel() for _, x in flatten_with_path(tree)) == \
        m.param_count() + norms


def test_registry_knows_only_ported_configs():
    """Every architecture of the JAX registry is ported: the same names
    in the same order, each with a model in the port."""
    import torch
    from repro.configs.registry import _MODULES as JAX_MODULES
    from repro_torch.configs.registry import _MODULES
    from repro_torch.models import make_model
    assert list(_MODULES) == list(JAX_MODULES)
    assert {n: m.replace("repro_torch.", "repro.", 1)
            for n, m in _MODULES.items()} == JAX_MODULES
    for name in _MODULES:
        cfg = get_config(name).reduced()
        make_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-small",
                                  "internvl2-76b", "llama3-405b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_last_family_configs_are_the_same(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.param_count() == j.model.param_count()
    assert t.model.sub_quadratic == j.model.sub_quadratic


@pytest.mark.parametrize("paper_model", [False, True])
def test_all_configs_and_shapes_are_the_jax_ones(paper_model):
    from repro.configs import all_configs as jax_all
    from repro.configs import applicable_shapes as jax_shapes
    from repro_torch.configs import ASSIGNED, all_configs, applicable_shapes
    from repro.configs import ASSIGNED as JAX_ASSIGNED
    assert ASSIGNED == JAX_ASSIGNED
    t, j = all_configs(paper_model), jax_all(paper_model)
    assert list(t) == list(j)
    for name in t:
        assert dataclasses.asdict(t[name]) == dataclasses.asdict(j[name])
        assert ([dataclasses.asdict(x) for x in applicable_shapes(t[name])]
                == [dataclasses.asdict(x) for x in jax_shapes(j[name])])


def test_last_family_configs_are_the_published_shapes():
    x = get_config("xlstm-125m").model
    assert (x.family, x.num_layers, x.d_model, x.vocab_size,
            x.attention.kind, x.xlstm.num_heads, x.xlstm.slstm_layers) == \
        ("ssm", 12, 768, 50_304, "none", 4, (3, 9))
    w = get_config("whisper-small").model
    assert (w.family, w.num_layers, w.encoder_layers, w.d_model, w.d_ff,
            w.attention.num_heads, w.attention.head_dim,
            w.attention.rope_theta, w.frontend.num_positions) == \
        ("audio", 12, 12, 768, 3072, 12, 64, 0.0, 1500)
    v = get_config("internvl2-76b").model
    assert (v.family, v.num_layers, v.d_model, v.frontend.kind) == \
        ("vlm", 80, 8192, "vision_patches")
    ll = get_config("llama3-405b").model
    assert (ll.family, ll.num_layers, ll.d_model, ll.attention.kind) == \
        ("dense", 126, 16_384, "full")


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
