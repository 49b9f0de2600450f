"""The autograd boundary of the port's kernel wrappers
(``repro_torch/kernels/_grad.py``).

A CUDA kernel fills its output by a ctypes launch, which cuts the graph.
``with_grad`` keeps the kernel's forward and differentiates the plain
version in the backward.  On the CPU a stand-in "kernel", the plain
version called under ``torch.no_grad()``, cuts the graph exactly as a
launch does: through the helper, its gradients must equal the plain
version's for each of the nine wrappers' signatures (same ops, same
order: exact).  The cases marked ``cuda`` run each wrapper's kernel
route on the card, with the launch counter as proof that the forward was
the kernel's, and the smallest loss of the port's main path (the reduced
GRU) against the CPU; they skip here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _grad, ops, ref  # noqa: E402

#: bf16 kernel outputs differ from the plain version's by rounding; the
#: gradients are the plain version's on both routes, recomputed from the
#: same inputs
TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


def _normal(r, shape, scale=1.0):
    return torch.as_tensor(r.normal(size=shape) * scale, dtype=torch.float32)


def signatures(dtype=torch.float32):
    """Per wrapper: (name, plain version over tensors, tensor inputs,
    which of them are differentiable), at small shapes."""
    r = np.random.default_rng(0)
    n = lambda *s, scale=1.0: _normal(r, s, scale).to(dtype)  # noqa: E731
    f32 = lambda *s, scale=1.0: _normal(r, s, scale)  # noqa: E731
    B, Pseq, ps = 3, 3, 4
    bt = torch.as_tensor(r.permutation(B * Pseq + 2)[:B * Pseq]
                         .reshape(B, Pseq), dtype=torch.int32)
    lengths = torch.tensor([0, 5, 12], dtype=torch.int32)
    pool = B * Pseq + 2
    valid = torch.as_tensor(r.uniform(size=(2, 16)) < 0.7)
    valid[1] = False
    return [
        ("gru_seq", ref.gru_seq_ref,
         (f32(2, 5, 3 * 8), f32(2, 8), f32(8, 3 * 8, scale=0.3)), (1, 1, 1)),
        ("fedavg_reduce", ref.fedavg_reduce_ref,
         (n(4, 33), torch.as_tensor(r.uniform(0.5, 2.0, 4),
                                    dtype=torch.float32)), (1, 1)),
        ("flash_attention",
         lambda q, k, v: ref.flash_attention_ref(q, k, v, window=5),
         (n(4, 9, 8), n(2, 9, 8), n(2, 9, 8)), (1, 1, 1)),
        ("decode_attention",
         lambda *t: ref.decode_attention_ref(*t, soft_cap=5.0),
         (n(2, 4, 8), n(2, 16, 2, 8), n(2, 16, 2, 8), valid), (1, 1, 1, 0)),
        ("paged_decode_attention",
         lambda *t: ref.paged_decode_attention_ref(*t, soft_cap=5.0,
                                                   window=6),
         (n(B, 4, 8), n(pool, ps, 2, 8), n(pool, ps, 2, 8), bt, lengths),
         (1, 1, 1, 0, 0)),
        ("paged_mla_decode_attention",
         lambda *t: ref.paged_mla_decode_attention_ref(*t, scale=0.2),
         (n(B, 4, 16), n(B, 4, 8), n(pool, ps, 16), n(pool, ps, 8), bt,
          lengths), (1, 1, 1, 1, 0, 0)),
        ("topk_router", lambda x: ref.topk_router_ref(x, 3),
         (f32(5, 8),), (1,)),
        ("mamba_chunk_scan",
         lambda *t: ref.mamba_chunk_scan_ref(*t, 8),
         (n(1, 16, 2, 4), torch.as_tensor(r.uniform(0.01, 0.2, (1, 16, 2)),
                                         dtype=torch.float32),
          -torch.as_tensor(r.uniform(0.5, 2.0, 2), dtype=torch.float32),
          n(1, 16, 4), n(1, 16, 4)), (1, 1, 1, 1, 1)),
        ("decode_attention_partial",
         lambda *t: ref.decode_attention_partial_ref(*t, soft_cap=5.0),
         (n(2, 4, 8), n(2, 16, 2, 8), n(2, 16, 2, 8), valid), (1, 1, 1, 0)),
    ]


SIGNATURES = [s[0] for s in signatures()]


def split_signatures(dtype=torch.float32):
    """The three GQA decode wrappers at shapes whose walk the kernels
    split over blocks (:func:`decode_splits` > 1 on any card of 8 to 264
    SMs): 2 rows of 600 dense slots, 2 of 40 pages of 16."""
    r = np.random.default_rng(1)
    n = lambda *s: _normal(r, s).to(dtype)  # noqa: E731
    valid = torch.as_tensor(r.uniform(size=(2, 600)) < 0.7)
    valid[1] = False
    bt = torch.as_tensor(r.permutation(81)[:80].reshape(2, 40),
                         dtype=torch.int32)
    lengths = torch.tensor([0, 517], dtype=torch.int32)
    return [
        ("decode_attention",
         lambda *t: ref.decode_attention_ref(*t, soft_cap=5.0),
         (n(2, 4, 8), n(2, 600, 2, 8), n(2, 600, 2, 8), valid), (1, 1, 1, 0)),
        ("paged_decode_attention",
         lambda *t: ref.paged_decode_attention_ref(*t, soft_cap=5.0),
         (n(2, 4, 8), n(81, 16, 2, 8), n(81, 16, 2, 8), bt, lengths),
         (1, 1, 1, 0, 0)),
        ("decode_attention_partial",
         lambda *t: ref.decode_attention_partial_ref(*t, soft_cap=5.0),
         (n(2, 4, 8), n(2, 600, 2, 8), n(2, 600, 2, 8), valid), (1, 1, 1, 0)),
    ]


def _splits(name, inputs, sms):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    q = inputs[0]
    B, H, D = q.shape
    if name == "paged_decode_attention":
        P, ps, Hkv, _ = inputs[1].shape
        G = H // Hkv
        return da.decode_splits(B, Hkv, G, da.heads_per_block(G, D, D),
                                pda.longest_walk(ps, inputs[3].shape[1], 0),
                                sms, warps=da.PAGED_WARPS)
    Hkv = inputs[1].shape[2]
    G = H // Hkv
    return da.decode_splits(B, Hkv, G, da.heads_per_block(G, D, D),
                            inputs[1].shape[1], sms)


@pytest.mark.parametrize("sms", [8, 132, 264])
def test_split_shapes_split_and_the_small_ones_do_not(sms):
    """The ``cuda`` gradient cases below run the split walk; the ones at
    :func:`signatures`' shapes run one block a row."""
    for name, _, inputs, _ in split_signatures():
        assert _splits(name, inputs, sms) > 1, name
    for name, _, inputs, _ in signatures():
        if name in ("decode_attention", "paged_decode_attention",
                    "decode_attention_partial"):
            assert _splits(name, inputs, sms) == 1, name


def _signature(name, dtype=torch.float32, device="cpu"):
    for sig in signatures(dtype):
        if sig[0] == name:
            _, plain, inputs, diff = sig
            return plain, [t.to(device) for t in inputs], diff


def _leaves(inputs, diff):
    return [t.detach().clone().requires_grad_(bool(d)) for t, d in
            zip(inputs, diff)]


def _grads(fn, inputs, diff, seed=1):
    """Gradients of a fixed random weighting of ``fn``'s floating outputs
    with respect to its differentiable inputs."""
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    r = np.random.default_rng(seed)
    loss = sum((o.float() * torch.as_tensor(
        r.normal(size=tuple(o.shape)), dtype=torch.float32,
        device=o.device)).sum() for o in outs if o.is_floating_point())
    wrt = [t for t, d in zip(inputs, diff) if d]
    return out, torch.autograd.grad(loss, wrt)


def _stand_in(plain):
    """The plain version with the graph cut, as a kernel launch cuts it."""
    def kernel(*t):
        with torch.no_grad():
            return plain(*t)
    return kernel


@pytest.mark.parametrize("name", SIGNATURES)
def test_stand_in_kernel_cuts_the_graph(name):
    plain, inputs, diff = _signature(name)
    out = _stand_in(plain)(*_leaves(inputs, diff))
    outs = out if isinstance(out, tuple) else (out,)
    assert not any(o.requires_grad for o in outs)


@pytest.mark.parametrize("name", SIGNATURES)
def test_helper_gradients_equal_the_plain_versions(name):
    plain, inputs, diff = _signature(name)
    want_out, want = _grads(plain, _leaves(inputs, diff), diff)
    got_out, got = _grads(
        lambda *t: _grad.with_grad(_stand_in(plain), plain, *t),
        _leaves(inputs, diff), diff)
    outs = got_out if isinstance(got_out, tuple) else (got_out,)
    wants = want_out if isinstance(want_out, tuple) else (want_out,)
    for o, w in zip(outs, wants):
        assert torch.equal(o, w)
        # integer outputs (the router's indices) stay out of the graph
        assert o.requires_grad == o.is_floating_point()
    assert len(got) == sum(diff)
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)
        assert g.abs().max() > 0


@pytest.mark.parametrize("name", ["mamba_chunk_scan", "topk_router"])
def test_helper_takes_one_output_of_a_pair(name):
    """A loss of only the first output: the second gets no gradient."""
    plain, inputs, diff = _signature(name)
    leaves = _leaves(inputs, diff)
    first = _grad.with_grad(_stand_in(plain), plain, *leaves)[0]
    got = torch.autograd.grad(first.sum(), leaves[0])[0]
    again = _leaves(inputs, diff)
    want = torch.autograd.grad(plain(*again)[0].sum(), again[0])[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", SIGNATURES)
def test_helper_is_not_entered_without_grad(monkeypatch, name):
    def refuse(*args):
        raise AssertionError("KernelGrad entered")
    monkeypatch.setattr(_grad.KernelGrad, "apply", refuse)
    plain, inputs, diff = _signature(name)
    calls = []

    def kernel(*t):
        calls.append(1)
        return _stand_in(plain)(*t)

    # grad mode off, inputs requiring grad
    with torch.no_grad():
        _grad.with_grad(kernel, plain, *_leaves(inputs, diff))
    # grad mode on, no input requiring grad
    _grad.with_grad(kernel, plain, *inputs)
    assert len(calls) == 2
    assert not _grad.needs_graph(*inputs)
    with torch.no_grad():
        assert not _grad.needs_graph(*_leaves(inputs, diff))
    assert _grad.needs_graph(*_leaves(inputs, diff))


def jax_cases():
    """(port wrapper, JAX ref, float inputs, integer inputs) for the
    edges where PyTorch's and JAX's autodiff could part: a zero-length
    paged row (every score -1e30, the uniform mean), a soft cap and a
    window; MLA's zero-length row; flash with a window."""
    from repro.kernels import ref as jref
    r = np.random.default_rng(3)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    B, Pseq, ps, pool = 3, 3, 4, 11
    bt = r.permutation(pool)[:B * Pseq].reshape(B, Pseq).astype(np.int32)
    lengths = np.array([0, 5, 12], np.int32)
    return {
        "paged_decode_attention": (
            lambda *t: ops.paged_decode_attention(*t, soft_cap=5.0,
                                                  window=6),
            lambda *t: jref.paged_decode_attention_ref(*t, soft_cap=5.0,
                                                       window=6),
            (f(B, 4, 8), f(pool, ps, 2, 8), f(pool, ps, 2, 8)),
            (bt, lengths)),
        "paged_mla_decode_attention": (
            lambda *t: ops.paged_mla_decode_attention(*t, scale=0.2),
            lambda *t: jref.paged_mla_decode_attention_ref(*t, scale=0.2),
            (f(B, 4, 16), f(B, 4, 8), f(pool, ps, 16), f(pool, ps, 8)),
            (bt, lengths)),
        "flash_attention": (
            lambda *t: ops.flash_attention(*t, window=5),
            lambda *t: jref.flash_attention_ref(*t, window=5),
            (f(3, 9, 8), f(3, 9, 8), f(3, 9, 8)), ()),
    }


@pytest.mark.parametrize("name", ["paged_decode_attention",
                                  "paged_mla_decode_attention",
                                  "flash_attention"])
def test_plain_gradients_match_jax(name):
    """``jax.grad`` of the JAX ref against the port's gradients, through
    the public wrapper (the plain version here) and through the helper
    around a graph-cutting stand-in (the backward the card runs), fp32
    within 3e-5."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    wrapper, jax_ref, floats, ints = jax_cases()[name]
    weight = np.random.default_rng(4).normal(
        size=tuple(wrapper(*(torch.as_tensor(a) for a in floats + ints))
                   .shape)).astype(np.float32)
    want = jax.grad(
        lambda *x: (jax_ref(*x, *map(jnp.asarray, ints))
                    * jnp.asarray(weight)).sum(),
        argnums=tuple(range(len(floats))))(*map(jnp.asarray, floats))
    stand_in = _stand_in(wrapper)
    for fn in (wrapper, lambda *t: _grad.with_grad(stand_in, wrapper, *t)):
        leaves = [torch.as_tensor(a).requires_grad_() for a in floats]
        out = fn(*leaves, *(torch.as_tensor(a) for a in ints))
        got = torch.autograd.grad((out * torch.as_tensor(weight)).sum(),
                                  leaves)
        for g, w in zip(got, want):
            assert g.abs().max() > 0
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                       rtol=3e-5)


# ---------------------------------------------------------------------------
# on the card: each wrapper's kernel route against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


WRAPPERS = {
    "gru_seq": lambda *t: ops.gru_seq(*t),
    "fedavg_reduce": lambda *t: ops.fedavg_reduce(*t),
    "flash_attention": lambda *t: ops.flash_attention(*t, window=5),
    "decode_attention": lambda *t: ops.decode_attention(*t, soft_cap=5.0),
    "paged_decode_attention": lambda *t: ops.paged_decode_attention(
        *t, soft_cap=5.0, window=6),
    "paged_mla_decode_attention": lambda *t: ops.paged_mla_decode_attention(
        *t, scale=0.2),
    "topk_router": lambda x: ops.topk_router(x, 3),
    "mamba_chunk_scan": lambda *t: ops.mamba_chunk_scan(*t, chunk=8),
    "decode_attention_partial": lambda *t: ops.decode_attention_partial(
        *t, soft_cap=5.0),
}
#: the wrappers that take bf16 inputs on the card
BF16 = ["fedavg_reduce", "flash_attention", "decode_attention",
        "paged_decode_attention", "paged_mla_decode_attention",
        "mamba_chunk_scan", "decode_attention_partial"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype",
                         [(n, torch.float32) for n in SIGNATURES]
                         + [(n, torch.bfloat16) for n in BF16])
def test_kernel_route_gradients_match_the_plain_version(cuda_device, name,
                                                        dtype):
    plain, inputs, diff = _signature(name, dtype, cuda_device)
    if name == "mamba_chunk_scan":      # dt and A stay fp32
        inputs[1:3] = [t.float() for t in inputs[1:3]]
    if name == "fedavg_reduce":         # weights stay fp32
        inputs[1] = inputs[1].float()
    kernel = getattr(ops, name)
    before = kernel.launches
    got_out, got = _grads(WRAPPERS[name], _leaves(inputs, diff), diff)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want_out, want = _grads(plain, _leaves(inputs, diff), diff)
    outs = got_out if isinstance(got_out, tuple) else (got_out,)
    wants = want_out if isinstance(want_out, tuple) else (want_out,)
    for o, w in zip(outs, wants):
        assert o.requires_grad == o.is_floating_point()
        tol = TOL[dtype] if o.is_floating_point() else dict(atol=0, rtol=0)
        torch.testing.assert_close(o.float(), w.float(), **tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
        assert g.abs().max() > 0


@pytest.mark.cuda
def test_kernel_route_without_grad_builds_no_graph(cuda_device):
    plain, inputs, diff = _signature("flash_attention", device=cuda_device)
    before = ops.flash_attention.launches
    with torch.no_grad():
        out = WRAPPERS["flash_attention"](*_leaves(inputs, diff))
    assert out.grad_fn is None
    assert ops.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_reduced_gru_loss_differentiates_on_the_card(cuda_device, B):
    """The smallest case of the fault this boundary repairs: the reduced
    gru-traffic's loss on the card has a nonzero gradient at every leaf,
    equal to the CPU's within 1e-4, with the forward in ``gru_seq``."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path, tree_map
    cfg = get_config("gru-traffic").reduced()
    api = make_model(cfg)
    cpu = api.init_params(torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(2)
    batch = {"windows": r.normal(size=(B, 12, 1)),
             "targets": r.normal(size=(B, 1))}
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = tree_map(lambda x: x.to(dev).requires_grad_(), cpu)
        leaves = [x for _, x in flatten_with_path(params)]
        b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        before = ops.gru_seq.launches
        g = torch.autograd.grad(api.loss(params, b), leaves)
        if dev.type == "cuda":
            assert ops.gru_seq.launches == before + cfg.model.rnn_layers
        grads[dev.type] = [x.cpu() for x in g]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the LM training step through the boundary
# ---------------------------------------------------------------------------

def _lm_case(arch, k, device="cpu"):
    """fp32 reduced ``arch`` at ``microbatches = k``: (api, cfg, params,
    batch) from seed 0."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import tree_map
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       param_dtype="float32"),
        run=dataclasses.replace(cfg.run, microbatches=k))
    api = make_model(cfg)
    params = tree_map(lambda x: x.to(device), api.init_params(
        torch.Generator().manual_seed(0), "cpu"))
    r = np.random.default_rng(5)
    batch = {key: torch.as_tensor(r.integers(0, cfg.model.vocab_size,
                                             (4, 8)), device=device)
             for key in ("tokens", "labels")}
    return api, cfg, params, batch


@pytest.mark.parametrize("arch,k,kernels", [
    ("gemma3-1b", 1, ("flash_attention",)),
    ("deepseek-v2-lite-16b", 2, ("flash_attention", "topk_router"))])
def test_train_step_through_the_boundary_equals_the_plain_one(
        monkeypatch, arch, k, kernels):
    """The LM train step (``repro_torch.training``) with each kernel the
    path reaches replaced by a graph-cutting stand-in behind
    ``with_grad`` (the card's route: kernel forward, plain backward):
    the updated parameters equal the plain route's (the same ops; only
    the order autograd sums a leaf's contributions in may differ), and
    every forward went through the stand-ins.  Attention takes the card's
    dispatch (``_flash``) on both routes; on the CPU the model runs its
    own ``_sdpa``."""
    from repro_torch.models import attention
    from repro_torch.params import flatten_with_path
    from repro_torch.training import SGD, make_train_step
    monkeypatch.setattr(attention, "_attention",
                        lambda q, k, v, q_pos, k_pos, causal, window:
                        attention._flash(q, k, v, causal, window))
    api, cfg, params, batch = _lm_case(arch, k)
    opt = SGD(lr=1e-2)
    want, _, want_loss = make_train_step(api, cfg, opt)(
        params, opt.init(params), batch)
    calls = {name: 0 for name in kernels}

    def routed(name):
        wrapper = getattr(ops, name)

        def call(*args, **kw):
            n = next((i for i, a in enumerate(args)
                      if not torch.is_tensor(a)), len(args))

            def plain(*t):
                return wrapper(*t, *args[n:], **kw)

            def kernel(*t):
                calls[name] += 1
                return _stand_in(plain)(*t)
            return _grad.with_grad(kernel, plain, *args[:n])
        return call

    for name in kernels:
        monkeypatch.setattr(ops, name, routed(name))
    got, _, got_loss = make_train_step(api, cfg, opt)(
        params, opt.init(params), batch)
    assert float(got_loss) == float(want_loss)
    # one flash a layer a microbatch, and one more a layer of the stack
    # (all but the lead dense layers) that the config's remat checkpoints:
    # its backward runs the layer's forward again
    m = cfg.model
    lead = m.moe.first_dense_layers if m.moe else 0
    again = 0 if cfg.run.remat == "none" else m.num_layers - lead
    assert cfg.run.remat == "layer"
    assert calls["flash_attention"] == (m.num_layers + again) * k
    if "topk_router" in calls:
        assert calls["topk_router"] > 0
    for (p, g), (_, w), (_, o) in zip(flatten_with_path(got),
                                      flatten_with_path(want),
                                      flatten_with_path(params)):
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6, msg=str(p))
    assert any(not torch.equal(g, o) for (_, g), (_, o) in zip(
        flatten_with_path(got), flatten_with_path(params)))


@pytest.mark.cuda
def test_lm_hfl_step_and_sync_on_the_card(cuda_device):
    """The reduced fp32 gemma3's HFL step at 2 clusters on the card
    against the CPU: the same losses (3e-5 relative) and SGD updates
    (1e-3 of the leaf's largest), ``flash_attention`` launched once a
    layer and cluster, and once more where the config checkpoints each
    layer (its backward runs the layer's forward again), and
    ``global_sync`` one ``fedavg_reduce``."""
    from repro_torch.fl.collectives import global_sync, stack_for_clusters
    from repro_torch.params import flatten_with_path
    from repro_torch.training import (SGD, init_hfl_opt_state,
                                      make_hfl_train_step)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        api, cfg, params, batch = _lm_case("gemma3-1b", 1, dev)
        stacked = stack_for_clusters(params, 2)
        batch = {key: torch.stack([v, v.flip(0)]) for key, v in
                 batch.items()}
        opt = SGD(lr=1e-2)
        before = dict(ops.launch_counts())
        stacked, _, losses = make_hfl_train_step(api, cfg, opt)(
            stacked, init_hfl_opt_state(opt, stacked), batch)
        synced = global_sync(stacked)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = ops.launch_counts()
            again = 0 if cfg.run.remat == "none" else 1
            assert after["flash_attention"] - before["flash_attention"] \
                == 2 * cfg.model.num_layers * (1 + again)
            assert after["fedavg_reduce"] - before["fedavg_reduce"] == 1
        out[dev.type] = (losses.cpu(), [x.cpu() for _, x in
                                        flatten_with_path(synced)],
                         [x.cpu() for _, x in flatten_with_path(params)])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=3e-5,
                               atol=0)
    for g, w, o in zip(*out["cuda"][1:2], out["cpu"][1], out["cpu"][2]):
        du, dw = g - o, w - o
        tol = 1e-3 * max(1e-2, float(dw.abs().max()))
        assert float((du - dw).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "decode_attention_partial"])
def test_split_kernel_route_gradients_match_the_plain_version(cuda_device,
                                                              name, dtype):
    """The GQA decode kernels with their walks split over blocks: one
    launch a call, the outputs and the plain version's gradients."""
    for sig in split_signatures(dtype):
        if sig[0] == name:
            _, plain, inputs, diff = sig
    inputs = [t.to(cuda_device) for t in inputs]
    assert _splits(name, inputs, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count) > 1
    kernel = getattr(ops, name)
    before = kernel.launches
    got_out, got = _grads(WRAPPERS[name] if name != "paged_decode_attention"
                          else lambda *t: ops.paged_decode_attention(
                              *t, soft_cap=5.0),
                          _leaves(inputs, diff), diff)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want_out, want = _grads(plain, _leaves(inputs, diff), diff)
    outs = got_out if isinstance(got_out, tuple) else (got_out,)
    wants = want_out if isinstance(want_out, tuple) else (want_out,)
    # the partial statistics at fp32's tolerance whatever the dtype
    tol = TOL[torch.float32 if name == "decode_attention_partial" else dtype]
    for o, w in zip(outs, wants):
        torch.testing.assert_close(o.float(), w.float(), **tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


def flash_split_inputs(dtype, device="cpu"):
    """Cross attention from 8 tokens to 600 keys (10 key tiles) over 2
    heads: a walk ``flash_splits`` splits on any card of 8 to 264 SMs."""
    r = np.random.default_rng(2)
    return [_normal(r, s).to(device, dtype)
            for s in ((2, 8, 16), (2, 600, 16), (2, 600, 16))]


@pytest.mark.parametrize("sms", [8, 132, 264])
def test_flash_split_shape_splits(sms):
    from repro_torch.kernels import flash_attention as fa
    assert fa.flash_splits(2, 2, 8, 600, False, 0, 16, 16, sms) > 1


@pytest.mark.cuda
def test_split_flash_route_gradients_match_the_plain_version(cuda_device):
    """flash_attention with its walk split over blocks (bf16: the TMA
    instance): one launch and one merge a call, the output and the plain
    version's gradients."""
    from repro_torch.kernels import flash_attention as fa
    inputs = flash_split_inputs(torch.bfloat16, cuda_device)
    assert fa.splits(*inputs, False, 0) > 1
    diff = (1, 1, 1)
    before = (ops.flash_attention.launches, ops.flash_attention.merges)
    got_out, got = _grads(lambda *t: ops.flash_attention(*t, causal=False),
                          _leaves(inputs, diff), diff)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches, ops.flash_attention.merges) == (
        before[0] + 1, before[1] + 1)
    want_out, want = _grads(
        lambda *t: ref.flash_attention_ref(*t, causal=False),
        _leaves(inputs, diff), diff)
    torch.testing.assert_close(got_out.float(), want_out.float(),
                               **TOL[torch.bfloat16])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])
