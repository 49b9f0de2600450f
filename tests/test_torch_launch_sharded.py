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


def sharded_loss_rank(rank, results, cases):
    """One rank: every case's result on the (data 2, model 2) mesh."""
    mesh = make_test_mesh("cpu", (2, 2), ("data", "model"))
    out = {arch: _sharded_loss(mesh, *case) for arch, case in cases.items()}
    out["paged"] = {arch: _sharded_paged(mesh, _cut(get_config(arch)
                                                     .reduced()))
                    for arch in PAGED}
    return out


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
    out, cases = {}, {}
    for arch, layers in CASES.items():
        jcfg = _cut(jax_config(arch).reduced(), layers)
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
    return res


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
