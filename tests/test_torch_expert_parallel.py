"""Expert-parallel MoE on a real mesh: four gloo ranks on the CPU as
(data 2, model 2), reduced deepseek-v2-lite (MLA, 4 experts top-2, a
shared expert, the first layer dense) and reduced qwen2-moe in fp32,
every parameter a DTensor laid out by its logical axes under three rule
sets:

- ``EXPERT_PARALLEL_RULES``: experts over ``model``, where each rank
  holds whole rows of its data shard; each rank runs its two experts'
  slots of the dispatch and the output is a partial sum over ``model``
  (no all-to-all);
- the override ``expert=("data",)`` over ``DEFAULT_RULES``: experts over
  ``data``, which also splits the rows, so the dispatch is an all-to-all
  over ``data`` and back, with the FFN width split over ``model``;
- ``DEFAULT_RULES`` (experts whole, the FFN width over ``model``): the
  gradients of this path were wrong until the partial sums over the FFN
  split were declared as such (ROADMAP Queue 3); its cases pin that.

Capacity is per rank's tokens, the port's named deviation (the
reference's one program takes it over the global batch), so the layer is
held against JAX's ``apply_moe`` called once per data shard (at the
config's capacity and at factor 0.25, which drops assignments), the loss
against the mean of JAX's losses of the data shards, and the gradients
(expert weights gathered to full) against the unsharded port's mean over
the shards, all within fp32 3e-5, on every rank.  A deepseek variant
with 3 experts, which no 2-wide axis divides, keeps its experts whole
and matches too.  The trace counter sees an all-to-all only where
experts and rows share ``data``.

One spawn of the four ranks runs the three rule sets.  The rank body
lives in this module, which imports no JAX at module level: the spawned
ranks import it."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402
from repro_torch.launch.shardings import EXPERT_PARALLEL_RULES  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.params import from_numpy_tree  # noqa: E402

TOL = 3e-5
B, S = 4, 16
DATA = 2
ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
#: rule set -> overrides of DEFAULT_RULES (as ``rules_overrides`` takes them)
RULES = {"expert_parallel": tuple(EXPERT_PARALLEL_RULES.items()),
         "expert_over_data": (("expert", ("data",)),),
         "default": ()}
#: the configs' factor (1.25), and one small enough to drop assignments
CAPACITY = (None, 0.25)
#: the fallback variant's experts: no 2-wide axis divides them
FALLBACK_EXPERTS = 3


def _cut(cfg, **moe):
    m = cfg.model
    if moe:
        m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, **moe))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, dtype="float32", param_dtype="float32"))


def _moe_layer(params):
    """The first MoE layer's parameters (the stacked ``layers``' first)."""
    from repro_torch.models.common import layer_slice
    return layer_slice(params["layers"], 0)["moe"]


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor().detach().numpy()


def ep_rank(rank, results, cases, fallback):
    """One rank: :func:`ep_rules` under each rule set of RULES."""
    # four ranks of small ops: more threads a rank only contend
    torch.set_num_threads(1)
    mesh = make_test_mesh("cpu", (DATA, 2), ("data", "model"))
    return {name: ep_rules(mesh, overrides, cases, fallback)
            for name, overrides in RULES.items()}


def ep_rules(mesh, overrides, cases, fallback):
    """One rank under one rule set: per arch the layer at each capacity,
    the loss and the gradients (gathered), the expert weights'
    placements and the collectives the trace counter saw; the fallback
    variant's layer."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as sh
    from repro_torch.launch.roofline import TraceCounter
    from repro_torch.models.common import logical_sharding
    from repro_torch.models.moe import apply_moe
    from repro_torch.training.train_step import value_and_grad
    rules = sh.rules_for(None, mesh, overrides)

    def setup(cfg, npp, axes_seed=0):
        api = make_model(cfg)
        params = from_numpy_tree(npp, "cpu")
        _, axes = api.init_params(torch.Generator().manual_seed(axes_seed),
                                  "cpu", with_axes=True)
        return api, sh.distribute_tree(
            params, mesh, sh.params_shardings(axes, params, mesh, rules))

    def layer(cfg, dparams, x):
        m = cfg.model
        dx = sh.distribute_tree(torch.as_tensor(x), mesh, sh.placements_for(
            mesh, rules, ("batch", "seq", "embed_act"), x.shape))
        out, counts = [], {}
        for cf in CAPACITY:
            moe = m.moe if cf is None else dataclasses.replace(
                m.moe, capacity_factor=cf)
            trace = TraceCounter()
            with torch.no_grad(), logical_sharding(mesh, rules), \
                    implicit_replication(), trace:
                y, aux = apply_moe(_moe_layer(dparams), moe, dx, m.act,
                                   with_aux=True)
            out.append((y.full_tensor().numpy(), float(aux.full_tensor())))
            for k, n in trace.coll.count_by_kind.items():
                counts[k] = counts.get(k, 0) + n
        return out, counts

    res = {}
    for arch, (cfg, npp, tokens, x) in cases.items():
        api, dparams = setup(cfg, npp)
        layers, counts = layer(cfg, dparams, x)
        batch = {"tokens": torch.as_tensor(tokens),
                 "labels": torch.as_tensor(tokens)}
        dbatch = sh.distribute_tree(batch, mesh,
                                    sh.batch_shardings(batch, mesh, rules))
        with logical_sharding(mesh, rules), implicit_replication():
            loss, grads = value_and_grad(api.loss, dparams, dbatch)
        moe = _moe_layer(dparams)
        res[arch] = {
            "layer": layers, "collectives": counts,
            "loss": float(loss.full_tensor()), "grads": _full(grads),
            # the tensor dim each mesh dim splits (None: whole)
            "placements": {k: tuple(p.dim if p.is_shard() else None
                                    for p in v.placements)
                           for k, v in moe.items() if k != "shared"},
            "local_experts": moe["wo"].to_local().shape[0]}
    cfg, npp, x = fallback
    _, dparams = setup(cfg, npp)
    res["fallback"] = {
        "layer": layer(cfg, dparams, x)[0][0],
        "split": any(p.is_shard(0)
                     for p in _moe_layer(dparams)["wo"].placements)}
    return res


def o1_scores(tree):
    """The query and key projections (``wq``, ``wk``, MLA's ``w_uk``:
    (..., fan-in, H, hd)) rescaled from JAX's fan-in over the heads to
    one over their input, as the family tests do: with JAX's the reduced
    fp32 softmax is ill-conditioned, and the gradients of two summation
    orders part by up to 2e-4 of their scale."""
    import jax

    def f(path, x):
        if path[-1].key in ("wq", "wk", "w_uk") and x.ndim >= 3:
            return (x * np.float32(np.sqrt(x.shape[-2] / x.shape[-3]))
                    ).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def _jax_setup(arch, experts=None):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import make_model as jax_model
    kw = {} if experts is None else {"num_experts": experts}
    jcfg = _cut(jax_config(arch).reduced(), **kw)
    jparams, _ = jax_model(jcfg).init_params(jax.random.key(0))
    return (jcfg, _cut(get_config(arch).reduced(), **kw),
            o1_scores(jax.tree.map(np.array, jparams)))


def _jax_layer(jcfg, npp, x, capacity_factor=None):
    """JAX's apply_moe of the first MoE layer, once per data shard: the
    outputs concatenated and the mean aux loss."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import apply_moe
    m = jcfg.model
    moe = m.moe if capacity_factor is None else dataclasses.replace(
        m.moe, capacity_factor=capacity_factor)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), npp["layers"]["moe"])
    outs, auxes = [], []
    for xs in np.split(x, DATA):
        y, aux = apply_moe(p, moe, jnp.asarray(xs), m.act)
        outs.append(np.asarray(y))
        auxes.append(float(aux))
    return np.concatenate(outs), float(np.mean(auxes))


def _shards(batch):
    return [{k: v[i * B // DATA:(i + 1) * B // DATA] for k, v in
             batch.items()} for i in range(DATA)]


@pytest.fixture(scope="module")
def refs():
    """Per arch: the inputs, JAX's layer per data shard at each capacity,
    JAX's loss and the unsharded port's gradients, each the mean over
    the data shards; whether capacity 0.25 drops assignments; and the
    fallback variant's inputs and JAX layer."""
    import jax.numpy as jnp
    from repro.models import make_model as jax_model
    from repro_torch.kernels import ops
    from repro_torch.models import moe as tmoe
    from repro_torch.training.train_step import value_and_grad
    out = {"cases": {}}
    for arch in ARCHS:
        jcfg, cfg, npp = _jax_setup(arch)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.model.vocab_size, (B, S)).astype(
            np.int32)
        x = rng.normal(size=(B, S, cfg.model.d_model)).astype(np.float32)
        batch = {"tokens": tokens, "labels": tokens}
        want = float(np.mean([float(jax_model(jcfg).loss(
            npp, {k: jnp.asarray(v) for k, v in b.items()}))
            for b in _shards(batch)]))
        api, params = make_model(cfg), from_numpy_tree(npp, "cpu")
        grads = [value_and_grad(api.loss, params, {
            k: torch.as_tensor(v) for k, v in b.items()})[1]
            for b in _shards(batch)]
        # assignments an expert gets beyond its capacity at factor 0.25
        m = cfg.model
        moe = dataclasses.replace(m.moe, capacity_factor=0.25)
        router = torch.as_tensor(npp["layers"]["moe"]["router"][0])
        over = 0
        for xs in np.split(x, DATA):
            t = xs.shape[0] * xs.shape[1]
            _, idx = ops.topk_router(
                torch.as_tensor(xs.reshape(t, -1)) @ router, moe.top_k)
            counts = np.bincount(idx.numpy().ravel(),
                                 minlength=moe.num_experts)
            over += int(np.maximum(counts - tmoe._capacity(t, moe), 0).sum())
        out["cases"][arch] = (cfg, npp, tokens, x)
        out[arch] = {"layer": [_jax_layer(jcfg, npp, x, cf)
                               for cf in CAPACITY],
                     "loss": want, "dropped": over,
                     "grads": _mean_tree(grads)}
    jcfg, cfg, npp = _jax_setup(ARCHS[0], FALLBACK_EXPERTS)
    x = np.random.default_rng(1).normal(
        size=(B, S, cfg.model.d_model)).astype(np.float32)
    out["fallback"] = (cfg, npp, x)
    out["fallback_layer"] = _jax_layer(jcfg, npp, x)
    return out


def _mean_tree(trees):
    if isinstance(trees[0], dict):
        return {k: _mean_tree([t[k] for t in trees]) for k in trees[0]}
    return (sum(trees) / len(trees)).detach().numpy()


@pytest.fixture(scope="module")
def runs(refs):
    return run_ranks(ep_rank, 4, backend="gloo", device="cpu", timeout=240,
                     args=(refs["cases"], refs["fallback"]))


@pytest.fixture(params=list(RULES))
def ranks(request, runs):
    """(rule set, each rank's results under it)."""
    return request.param, [r[request.param] for r in runs]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_equals_jax_per_data_shard(ranks, refs, arch):
    """At the config's capacity and at factor 0.25 (which drops)."""
    _, got = ranks
    for r in got:
        for (y, aux), (want, jaux) in zip(r[arch]["layer"],
                                          refs[arch]["layer"]):
            np.testing.assert_allclose(y, want, atol=TOL, rtol=TOL)
            assert abs(aux - jaux) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_small_capacity_drops_assignments(refs, arch):
    assert refs[arch]["dropped"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_equals_jax(ranks, refs, arch):
    _, got = ranks
    for r in got:
        assert abs(r[arch]["loss"] - refs[arch]["loss"]) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_equal_the_unsharded(ranks, refs, arch):
    """Every leaf, the expert weights gathered to full."""
    _, got = ranks
    want = dict(_leaves(refs[arch]["grads"]))
    for r in got:
        for path, g in _leaves(r[arch]["grads"]):
            np.testing.assert_allclose(g, want[path], atol=TOL, rtol=TOL,
                                       err_msg=path)


#: the first MoE layer's wi_up (E, d, ff) and wo (E, ff, d) on (data,
#: model), and the experts a rank holds, by rule set
SPLITS = {"expert_parallel": ((1, 0), (2, 0), 2),
          "expert_over_data": ((0, 2), (0, 1), 2),
          "default": ((1, 2), (2, 1), 4)}


@pytest.mark.parametrize("arch", ARCHS)
def test_experts_split_as_the_rules_say(ranks, arch):
    """Experts over model and d over data (EXPERT_PARALLEL_RULES: the
    FFN width whole), experts over data and the FFN width over model (the
    override: d whole, data is taken), or experts whole (DEFAULT_RULES)."""
    name, got = ranks
    wi_up, wo, local = SPLITS[name]
    for r in got:
        pl = r[arch]["placements"]
        assert (pl["wi_up"], pl["wo"], r[arch]["local_experts"]) == (
            wi_up, wo, local)


def test_fallback_keeps_experts_whole_and_matches(ranks, refs):
    _, got = ranks
    want, jaux = refs["fallback_layer"]
    for r in got:
        assert not r["fallback"]["split"]
        y, aux = r["fallback"]["layer"]
        np.testing.assert_allclose(y, want, atol=TOL, rtol=TOL)
        assert abs(aux - jaux) <= TOL


def test_all_to_all_only_where_experts_and_rows_share_an_axis(ranks):
    name, got = ranks
    for r in got:
        for arch in ARCHS:
            n = r[arch]["collectives"].get("all-to-all", 0)
            # two a layer (dispatch and return) at each capacity
            assert n == (4 if name == "expert_over_data" else 0), (arch, n)
