"""The port's models on a real mesh: four gloo ranks on the CPU as
(data 2, model 2) under ``DEFAULT_RULES``, every parameter a DTensor laid
out by its logical axes, the batch split over ``data``, the loss run
under ``logical_sharding`` (``shard`` redistributes the activations; the
attention runs on each rank's batch rows and heads through
``models/sharded.py``).  Reduced stablelm-1.6b (4 heads, 2 kv heads:
both split) and gemma3-1b's 6-layer cut (4 heads, one kv head: the kv
heads fall back to replicated and are repeated per query head) give
JAX's loss on the same weights within fp32 3e-5, on every rank; so do
their gradients' global norms against the unsharded port's.  Paged
decode on DTensors (the paged kernels' call sites through
``local_map``; each rank writes its rows' K/V or latents into its copy
of the page pool): two decode steps of reduced stablelm (kv heads split
over model) and reduced deepseek-v2-lite (MLA latent pages, MoE) after
an unsharded paged prefill give the unsharded steps' logits within
the same fp32 3e-5 (tensor-parallel partial sums add in another order).
Dense decode with the cache split along its slots over model (the
reference's ``kv_seq`` rule, ``cache_shardings``; each rank's share
through the dense decode's partial instance, merged across the ranks):
two steps of the same two models from a cache drawn from a seed, with
rows whose tokens all lie in one half, span both, have wrapped the
ring, or are none at all, give JAX's unsharded ``decode_step`` (a row at
a time: its positions are one a call) on the same weights and cache
within fp32 3e-5.

The rank body lives in this module, which imports no JAX at module
level: the spawned ranks import it."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    KVCache, map_kv_caches, ring_positions)
from repro_torch.params import from_numpy_tree  # noqa: E402

TOL = 3e-5
B, S = 4, 16


def _cut(cfg, layers=None):
    m = cfg.model
    kw = {"num_layers": layers} if layers else {}
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, dtype="float32", param_dtype="float32", **kw))


CASES = {"stablelm-1.6b": None, "gemma3-1b": 6}


PAGED = ("stablelm-1.6b", "deepseek-v2-lite-16b")


#: the split decode: ring caches of SPLIT_LEN slots (a windowed layer's
#: fewer), halved over model; tokens cached a row before the first step:
#: all in rank 0's half, both halves, a wrapped ring, none
SPLIT_LEN = 32
SPLIT_T = (5, 24, 70, 0)
SPLIT_STEPS = 2


def sharded_loss_rank(rank, results, cases):
    """One rank: every case's result on the (data 2, model 2) mesh."""
    mesh = make_test_mesh("cpu", (2, 2), ("data", "model"))
    out = {arch: _sharded_loss(mesh, *case) for arch, case in cases.items()}
    out["paged"] = {arch: _sharded_paged(mesh, _cut(get_config(arch)
                                                     .reduced()))
                    for arch in PAGED}
    out["split"] = {arch: _sharded_split(mesh, cfg, npp)
                    for arch, (cfg, npp, _) in cases.items()}
    return out


def split_case(cfg):
    """The split decode's inputs, from seed 2: per cache leaf (the
    port's ``init_cache`` tree) numpy K/V, positions and indices; the
    tokens of each step (B, SPLIT_STEPS)."""
    cache = make_model(cfg).init_cache(len(SPLIT_T), SPLIT_LEN, "cpu")
    r = np.random.default_rng(2)

    def fill(c):
        C = c.k.shape[-3]
        lead = c.k.shape[:-4]
        pos = np.stack([ring_positions(C, t).numpy() for t in SPLIT_T])
        return type(c)(
            k=r.normal(size=c.k.shape).astype(np.float32),
            v=r.normal(size=c.v.shape).astype(np.float32),
            pos=np.broadcast_to(pos, lead + pos.shape).copy(),
            index=np.broadcast_to(np.asarray(SPLIT_T, np.int32),
                                  lead + (len(SPLIT_T),)).copy())

    out = map_kv_caches(fill, cache)
    tokens = r.integers(0, cfg.model.vocab_size,
                        (len(SPLIT_T), SPLIT_STEPS))
    return out, tokens


def _sharded_split(mesh, cfg, npp):
    """SPLIT_STEPS dense decode steps on DTensors, the cache laid out by
    ``cache_shardings`` under ``DEFAULT_RULES`` (rows over data, slots
    over model): the logits (B, SPLIT_STEPS, V) and whether every ring
    leaf was split along its slots."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as sh
    from repro_torch.models.common import logical_sharding
    api = make_model(cfg)
    params = from_numpy_tree(npp, "cpu")
    _, axes = api.init_params(torch.Generator().manual_seed(0), "cpu",
                              with_axes=True)
    rules = sh.DEFAULT_RULES
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    cache, tokens = split_case(cfg)
    cache = map_kv_caches(lambda c: KVCache(*map(torch.as_tensor, c)), cache)
    dcache = sh.distribute_tree(cache, mesh,
                                sh.cache_shardings(cache, mesh, rules))
    split = []
    map_kv_caches(lambda c: split.append(c.k.placements[-1] == Shard(
        c.k.ndim - 3)), dcache)
    logits = []
    for step in range(SPLIT_STEPS):
        tok = torch.as_tensor(tokens[:, step:step + 1])
        pos = torch.as_tensor(SPLIT_T) + step
        dtok = sh.distribute_tree(tok, mesh, sh.batch_shardings(
            {"tokens": tok}, mesh, rules)["tokens"])
        with torch.no_grad(), logical_sharding(mesh, rules), \
                implicit_replication():
            got, dcache = api.decode_step(dparams, dtok, pos, dcache)
        logits.append(got.full_tensor()[:, 0].numpy())
    return {"logits": np.stack(logits, 1), "slots_split": all(split)}


def _sharded_paged(mesh, cfg):
    """The largest gap between two paged decode steps' logits on
    DTensors and unsharded, after one unsharded paged prefill."""
    import copy

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as sh
    from repro_torch.models.common import logical_sharding
    api = make_model(cfg)
    params, axes = api.init_params(torch.Generator().manual_seed(1), "cpu",
                                   with_axes=True)
    rules = sh.DEFAULT_RULES
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.model.vocab_size, (B, 10)))
    bt = torch.arange(2 * B).reshape(B, 2)
    cache = api.init_paged_cache(2 * B, 8, "cpu")
    with torch.no_grad():
        _, cache = api.paged_prefill(params, toks[:, :8], cache, bt)
    dcache = copy.deepcopy(cache)
    # pages whole on data (a rank writes and reads its rows' pages), kv
    # heads split over model where they divide
    split = cfg.model.attention.kind != "mla" and         cfg.model.attention.num_kv_heads % 2 == 0
    pl = lambda x: (Replicate(), Shard(x.ndim - 2) if split else Replicate())
    dcache = {"lead": {k: type(c)(*(sh.distribute_tree(t, mesh, pl(t))
                                    for t in c))
                       for k, c in dcache["lead"].items()},
              "layers": type(dcache["layers"])(*(
                  sh.distribute_tree(t, mesh, pl(t))
                  for t in dcache["layers"]))}
    gap = 0.0
    for step in (8, 9):
        tok = toks[:, step:step + 1]
        pos = torch.full((B,), step)
        with torch.no_grad():
            want, cache = api.paged_decode_step(params, tok, pos, cache, bt)
            dtok = sh.distribute_tree(tok, mesh, sh.batch_shardings(
                {"tokens": tok}, mesh, rules)["tokens"])
            with logical_sharding(mesh, rules), implicit_replication():
                got, dcache = api.paged_decode_step(dparams, dtok, pos,
                                                    dcache, bt)
        gap = max(gap, float((got.full_tensor() - want).abs().max()))
    return gap


def _sharded_loss(mesh, cfg, npp, tokens):
    """The loss and the gradients' global norm of ``cfg``, and this
    rank's shard of ``wq``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as sh
    from repro_torch.models.common import logical_sharding
    from repro_torch.training.train_step import value_and_grad
    api = make_model(cfg)
    params = from_numpy_tree(npp, "cpu")
    _, axes = api.init_params(torch.Generator().manual_seed(0), "cpu",
                              with_axes=True)
    rules = sh.DEFAULT_RULES
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(tokens)}
    dbatch = sh.distribute_tree(batch, mesh,
                                sh.batch_shardings(batch, mesh, rules))
    with logical_sharding(mesh, rules), implicit_replication():
        loss, grads = value_and_grad(api.loss, dparams, dbatch)
        sq = sum((g.float() ** 2).sum() for g in _leaves(grads))
    wq = dparams["layers"]["attn"]["wq"]
    return {"loss": float(loss.full_tensor()),
            "grad_norm": float(sq.full_tensor()) ** 0.5,
            "wq_local": tuple(wq.to_local().shape),
            "wq_split": wq.placements == (Shard(1), Shard(2))}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import make_model as jax_model
    from repro_torch.training.train_step import value_and_grad
    out, cases, jcfgs = {}, {}, {}
    for arch, layers in CASES.items():
        jcfg = jcfgs[arch] = _cut(jax_config(arch).reduced(), layers)
        cfg = _cut(get_config(arch).reduced(), layers)
        jparams, _ = jax_model(jcfg).init_params(jax.random.key(0))
        npp = jax.tree.map(np.asarray, jparams)
        tokens = np.random.default_rng(0).integers(
            0, cfg.model.vocab_size, (B, S)).astype(np.int32)
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
        want = float(jax_model(jcfg).loss(jparams, jb))
        batch = {"tokens": torch.as_tensor(tokens),
                 "labels": torch.as_tensor(tokens)}
        plain, grads = value_and_grad(make_model(cfg).loss,
                                      from_numpy_tree(npp, "cpu"), batch)
        norm = float(sum((g.float() ** 2).sum()
                         for g in _leaves(grads))) ** 0.5
        cases[arch] = (cfg, npp, tokens)
        out[arch] = (want, float(plain), norm, cfg)
    ranks = run_ranks(sharded_loss_rank, 4, backend="gloo", device="cpu",
                      timeout=240, args=(cases,))
    res = {arch: (want, plain, norm, [r[arch] for r in ranks], cfg)
           for arch, (want, plain, norm, cfg) in out.items()}
    res["paged"] = [r["paged"] for r in ranks]
    res["split"] = {arch: ([r["split"][arch] for r in ranks],
                           _jax_split(jax_model(jcfgs[arch]), cfg, npp))
                    for arch, (cfg, npp, _) in cases.items()}
    return res


def _jax_split(api, cfg, npp):
    """JAX's unsharded decode_step (``api``, its model) over
    :func:`split_case`, a row at a time (its decode takes one position a
    call): logits (B, SPLIT_STEPS, V)."""
    import jax
    import jax.numpy as jnp
    params = jax.tree.map(jnp.asarray, npp)
    cache, tokens = split_case(cfg)
    rows = []
    for b, t in enumerate(SPLIT_T):
        template = api.init_cache(1, SPLIT_LEN)

        def row(c, j):
            return type(j)(k=jnp.asarray(c.k[..., b:b + 1, :, :, :]),
                           v=jnp.asarray(c.v[..., b:b + 1, :, :, :]),
                           pos=jnp.asarray(c.pos[..., b:b + 1, :]),
                           index=jnp.asarray(c.index[..., b]))

        layers = cache["layers"]
        jc = {"lead": {k: row(c, template["lead"][k])
                       for k, c in cache["lead"].items()},
              "layers": ({k: row(c, template["layers"][k])
                          for k, c in layers.items()}
                         if isinstance(layers, dict)
                         else row(layers, template["layers"]))}
        out = []
        for step in range(SPLIT_STEPS):
            logit, jc = api.decode_step(
                params, jnp.asarray(tokens[b:b + 1, step:step + 1]),
                jnp.int32(t + step), jc)
            out.append(np.asarray(logit)[0, 0])
        rows.append(np.stack(out))
    return np.stack(rows)


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_loss_equals_jax(runs, arch):
    want, plain, _, ranks, _ = runs[arch]
    assert abs(plain - want) <= TOL
    for r in ranks:
        assert abs(r["loss"] - want) <= TOL, (r["loss"], want)


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_gradients_equal_the_unsharded(runs, arch):
    _, _, norm, ranks, _ = runs[arch]
    for r in ranks:
        assert r["grad_norm"] == pytest.approx(norm, rel=1e-4)


@pytest.mark.parametrize("arch", PAGED)
def test_sharded_paged_decode_equals_the_unsharded(runs, arch):
    for r in runs["paged"]:
        assert r[arch] <= TOL, r[arch]


@pytest.mark.parametrize("arch", list(CASES))
def test_split_slot_decode_equals_jax_unsharded(runs, arch):
    ranks, want = runs["split"][arch]
    for r in ranks:
        assert r["slots_split"]
        np.testing.assert_allclose(r["logits"], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", list(CASES))
def test_weights_are_split_by_their_logical_axes(runs, arch):
    """wq (layers, d, H, hd): embed over data, heads over model."""
    *_, ranks, cfg = runs[arch]
    m = cfg.model
    L = m.num_layers
    want = (L, m.d_model // 2, m.attention.num_heads // 2,
            m.attention.head_dim)
    for r in ranks:
        assert r["wq_local"] == want
        assert r["wq_split"]
