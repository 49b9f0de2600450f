"""The port's MoE and MLA kernels against the JAX package's:
``topk_router`` and ``paged_mla_decode_attention``, and
``flash_attention`` at the MLA prefill's head dims (score 192, value
128).

On the CPU the wrappers run their kernels' plain versions; those are held
against ``repro.kernels.ref`` and ``repro.kernels.ops`` (Pallas, interpret
mode) on the same numpy inputs, at the sweep shapes and tolerances of
``tests/test_kernels.py`` (router weights 1e-6 with identical indices;
attention fp32 3e-5, bf16 3e-2).  The cases marked ``cuda`` hold each
CUDA kernel against its plain version on the card, at the sweep shapes
and at the deepseek-v2-lite serving path's shapes, and the reduced
deepseek's serving engines on the card against the CPU; they skip here.
The JAX package is imported inside the tests that use it, so the
``cuda`` cases also run where only PyTorch is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_mla_decode_attention)
from repro_torch.kernels.topk_router import topk_router  # noqa: E402

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = ["float32", "bfloat16"]
#: tests/test_kernels.py sweeps: (T, E, k, bt) and (H, R, Dr, ps, Pseq)
ROUTER = [(64, 16, 4, 32), (128, 60, 4, 64), (32, 64, 6, 32)]
MLA = [(8, 64, 16, 16, 4), (4, 128, 32, 8, 3)]
#: deepseek-v2-lite's serving shapes: router over 64 experts, top 6, at
#: the prefill bucket (64 tokens) and at 32 and 1 decode rows; MLA decode
#: at 16 heads, R 512, Dr 64, 16-token pages, 1, 4 and 32 rows
ROUTER_PATH = [(64, 64, 6), (32, 64, 6), (1, 64, 6)]
MLA_PATH = [(1, 16, 512, 64, 16, 16), (4, 16, 512, 64, 16, 16),
            (32, 16, 512, 64, 16, 16)]
#: flash at MLA prefill: 16 heads of the 64-token bucket, D 192, Dv 128
FLASH_MLA = [(16, 64, 192, 128), (2, 100, 192, 128), (4, 77, 256, 64),
             (2, 8, 192, 128), (2, 100, 200, 72)]


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _normal(r, shape):
    return r.normal(size=shape).astype(np.float32)


def _tensor(a, dtype, device="cpu"):
    return torch.as_tensor(a).to(device, getattr(torch, dtype))


def _to_np(t):
    return t.float().cpu().numpy()


def router_logits(T, E, seed=0, tie_row=False):
    """Normal logits; with ``tie_row`` row 0 holds equal logits (every
    probability ties, so the picks are 0..k-1) and row 1 a tie for the
    top two experts at the highest indices."""
    x = _normal(np.random.default_rng(seed), (T, E))
    if tie_row:
        x[0] = 0.5
        x[1, -2:] = x[1].max() + 1.0
    return x


def rounding_tie_logits(T, E, seed=0):
    """Normal logits whose row 0 has two top logits with different
    exponentials but one probability: expert 0 at -2^-24 (exp 1 - 2^-24),
    expert 1 at 0 (exp 1), nine at fp32(-3 ln 2) (exp 1/8), the rest at
    -200 (exp 0).  Every partial sum of those exponentials rounds to one
    total, 3.125, in any order, and 1 / 3.125 and (1 - 2^-24) / 3.125
    round to one fp32 value: the tie goes to expert 0, while a choice on
    the exponentials would take expert 1."""
    x = _normal(np.random.default_rng(seed), (T, E))
    x[0] = -200.0
    x[0, 0] = -2.0 ** -24
    x[0, 1] = 0.0
    x[0, 2:11] = np.float32(-3 * np.log(2))
    return x


def mla_inputs(H, R, Dr, ps, Pseq, B=2, seed=0, lengths=None):
    """Distinct page ids per (row, page): a permutation of the pool (two
    spare pages), so the gather meets genuinely scattered pages."""
    r = np.random.default_rng(seed)
    num_pages = B * Pseq + 2
    bt = r.permutation(num_pages)[:B * Pseq].reshape(B, Pseq)
    if lengths is None:
        lengths = r.integers(1, Pseq * ps + 1, (B,))
    return (_normal(r, (B, H, R)), _normal(r, (B, H, Dr)),
            _normal(r, (num_pages, ps, R)), _normal(r, (num_pages, ps, Dr)),
            bt.astype(np.int32), np.asarray(lengths, np.int32))


def flash_inputs(BH, T, D, Dv, seed=0):
    r = np.random.default_rng(seed)
    return (_normal(r, (BH, T, D)), _normal(r, (BH, T, D)),
            _normal(r, (BH, T, Dv)))


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------

def test_rounding_tie_row_ties_only_after_the_division():
    """The premise of the rounding-tie row, in the plain version's fp32
    arithmetic: the two exponentials differ, their probabilities do not,
    and the lower index is picked first."""
    x = torch.as_tensor(rounding_tie_logits(2, 60))
    e = torch.exp(x[0] - x[0].max())
    p = e / e.sum()
    assert e[0] < e[1] and p[0] == p[1] and e.sum().item() == 3.125
    _, i = topk_router(x, 4)
    assert i[0, :2].tolist() == [0, 1]


@pytest.mark.parametrize("T,E,k", [(1, 60, 4), (33, 60, 4), (64, 64, 6)])
def test_topk_router_plain_matches_jax_on_a_rounding_tie(T, E, k):
    jnp, jops, _ = _jax()
    x = rounding_tie_logits(T, E)
    w, i = topk_router(torch.as_tensor(x), k)
    wk, ik = jops.topk_router(jnp.asarray(x), k, bt=T)
    assert_allclose(w.numpy(), np.asarray(wk), atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik))


@pytest.mark.parametrize("T,E,k,bt", ROUTER)
@pytest.mark.parametrize("tie_row", [False, True])
def test_topk_router_plain_matches_jax(T, E, k, bt, tie_row):
    jnp, jops, jref = _jax()
    x = router_logits(T, E, tie_row=tie_row)
    w, i = topk_router(torch.as_tensor(x), k)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    assert w.shape == i.shape == (T, k)
    wk, ik = jops.topk_router(jnp.asarray(x), k, bt=bt)
    assert_allclose(w.numpy(), np.asarray(wk), atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik))
    # the XLA oracle (lax.top_k) agrees wherever no two probabilities tie
    wr, ir = jref.topk_router_ref(jnp.asarray(x), k)
    rows = slice(2, None) if tie_row else slice(None)
    assert_allclose(w.numpy(), np.asarray(wr), atol=1e-6)
    np.testing.assert_array_equal(i.numpy()[rows], np.asarray(ir)[rows])


def test_topk_router_ties_go_to_the_lowest_index():
    x = router_logits(4, 8, tie_row=True)
    w, i = topk_router(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(i[0].numpy(), [0, 1, 2])
    assert_allclose(w[0].numpy(), np.full(3, 1 / 8), atol=1e-7)
    np.testing.assert_array_equal(i[1, :2].numpy(), [6, 7])
    assert w[1, 0] == w[1, 1]


@pytest.mark.parametrize("H,R,Dr,ps,Pseq", MLA)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_mla_decode_attention_plain_matches_jax(H, R, Dr, ps, Pseq,
                                                      dtype):
    jnp, jops, jref = _jax()
    qc, qr, ckv, kr, bt, ln = mla_inputs(H, R, Dr, ps, Pseq)
    scale = 1.0 / np.sqrt(R + Dr)
    out = paged_mla_decode_attention(
        *(_tensor(a, dtype) for a in (qc, qr, ckv, kr)), torch.as_tensor(bt),
        torch.as_tensor(ln), scale=scale)
    assert out.shape == (2, H, R) and out.dtype == getattr(torch, dtype)
    args = tuple(jnp.asarray(a, getattr(jnp, dtype))
                 for a in (qc, qr, ckv, kr)) + (jnp.asarray(bt),
                                                jnp.asarray(ln))
    for fn in (jref.paged_mla_decode_attention_ref,
               jops.paged_mla_decode_attention):
        w = fn(*args, scale=scale)
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])


def empty_row_lengths(ps, Pseq):
    """Rows the paged kernels treat apart: no token (every score -1e30,
    so the mean of the latents over all the row's gathered slots), a last
    page partly filled, and a full table."""
    return [0, Pseq * ps - ps // 2 - 1, Pseq * ps]


@pytest.mark.parametrize("H,R,Dr,ps,Pseq", MLA)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_mla_decode_attention_plain_matches_jax_on_empty_rows(
        H, R, Dr, ps, Pseq, dtype):
    """A row with lengths 0 is the uniform mean of the c_kv latents over
    all its gathered slots in the JAX oracle and the Pallas kernel, and
    so here."""
    jnp, jops, jref = _jax()
    qc, qr, ckv, kr, bt, ln = mla_inputs(
        H, R, Dr, ps, Pseq, B=3, lengths=empty_row_lengths(ps, Pseq))
    scale = 1.0 / np.sqrt(R + Dr)
    out = paged_mla_decode_attention(
        *(_tensor(a, dtype) for a in (qc, qr, ckv, kr)), torch.as_tensor(bt),
        torch.as_tensor(ln), scale=scale)
    args = tuple(jnp.asarray(a, getattr(jnp, dtype))
                 for a in (qc, qr, ckv, kr)) + (jnp.asarray(bt),
                                                jnp.asarray(ln))
    for fn in (jref.paged_mla_decode_attention_ref,
               jops.paged_mla_decode_attention):
        w = fn(*args, scale=scale)
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])
    latents = _to_np(_tensor(ckv, dtype))[bt[0]].reshape(-1, R).mean(0)
    assert_allclose(_to_np(out)[0], np.broadcast_to(latents, (H, R)),
                    **TOL[dtype])


@pytest.mark.parametrize("BH,T,D,Dv", FLASH_MLA[:2])
def test_flash_attention_plain_takes_mla_head_dims(BH, T, D, Dv):
    jnp, _, jref = _jax()
    q, k, v = flash_inputs(BH, T, D, Dv)
    out = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)))
    assert out.shape == (BH, T, Dv)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)))
    assert_allclose(out.numpy(), np.asarray(want), **TOL["float32"])


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    topk_router(torch.as_tensor(router_logits(8, 16)), 2)
    paged_mla_decode_attention(
        *(torch.as_tensor(a) for a in mla_inputs(4, 32, 8, 4, 2)),
        scale=0.1)
    assert set(ops.launch_counts().values()) == {0}


def test_wrappers_check_shapes_and_dtypes():
    x = torch.as_tensor(router_logits(8, 16))
    with pytest.raises(ValueError, match="k <= E"):
        topk_router(x, 17)
    with pytest.raises(ValueError, match="k <= E"):
        topk_router(x, 0)
    with pytest.raises(ValueError, match="logits"):
        topk_router(x[None], 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_router(x.to("meta"), 2)
    qc, qr, ckv, kr, bt, ln = (torch.as_tensor(a)
                               for a in mla_inputs(4, 32, 8, 4, 2))
    with pytest.raises(TypeError, match="int32"):
        paged_mla_decode_attention(qc, qr, ckv, kr, bt.long(), ln, scale=1.0)
    with pytest.raises(ValueError, match="do not agree"):
        paged_mla_decode_attention(qc, qr, ckv[..., :16], kr, bt, ln,
                                   scale=1.0)
    with pytest.raises(ValueError, match="do not agree"):
        paged_mla_decode_attention(qc, qr[:1], ckv, kr, bt, ln, scale=1.0)
    with pytest.raises(ValueError, match="different devices"):
        paged_mla_decode_attention(qc, qr, ckv, kr, bt, ln.to("meta"),
                                   scale=1.0)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _launched_once(fn, kernel):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k", [s[:3] for s in ROUTER] + ROUTER_PATH
                         + [(3, 300, 8), (5, 4096, 2), (1, 60, 4),
                            (33, 60, 4), (7, 200, 8), (2, 130, 3)])
@pytest.mark.parametrize("tie_row", [False, True])
def test_topk_router_kernel_matches_plain(cuda_device, T, E, k, tie_row):
    x = torch.as_tensor(router_logits(T, E, tie_row=tie_row and T > 1),
                        device=cuda_device)
    w, i = _launched_once(lambda: topk_router(x, k), topk_router)
    wr, ir = ref.topk_router_ref(x, k)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    assert_allclose(w.cpu().numpy(), wr.cpu().numpy(), atol=1e-6)
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k", [(1, 60, 4), (33, 60, 4), (64, 64, 6),
                                   (9, 200, 6)])
def test_topk_router_kernel_on_a_rounding_tie(cuda_device, T, E, k):
    """Row 0's top two probabilities are one fp32 value from two
    different exponentials: the kernel, like the plain version, picks
    the lower index first."""
    x = torch.as_tensor(rounding_tie_logits(T, E), device=cuda_device)
    w, i = _launched_once(lambda: topk_router(x, k), topk_router)
    wr, ir = ref.topk_router_ref(x, k)
    assert i[0, :2].tolist() == [0, 1]
    assert_allclose(w.cpu().numpy(), wr.cpu().numpy(), atol=1e-6)
    np.testing.assert_array_equal(i.cpu().numpy(), ir.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("E", [60, 64, 200, 300])
def test_topk_router_kernel_keeps_nan_rows(cuda_device, E):
    """A row with a NaN logit has only NaN probabilities: the kernel
    records -inf and index E in every round, as it always has (the plain
    version's argmax would pick the NaN); the other rows are unharmed."""
    x = router_logits(5, E)
    x[1, 3] = np.nan
    x[3, :] = np.nan
    xt = torch.as_tensor(x, device=cuda_device)
    w, i = _launched_once(lambda: topk_router(xt, 4), topk_router)
    for row in (1, 3):
        assert torch.equal(w[row].cpu(), torch.full((4,), -np.inf))
        assert i[row].tolist() == [E] * 4
    keep = [0, 2, 4]
    wr, ir = ref.topk_router_ref(xt[keep], 4)
    assert_allclose(w[keep].cpu().numpy(), wr.cpu().numpy(), atol=1e-6)
    np.testing.assert_array_equal(i[keep].cpu().numpy(), ir.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,R,Dr,ps,Pseq", [(2, *s) for s in MLA]
                         + MLA_PATH + [(3, 20, 96, 0, 8, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_mla_decode_attention_kernel_matches_plain(
        cuda_device, B, H, R, Dr, ps, Pseq, dtype):
    qc, qr, ckv, kr, bt, ln = mla_inputs(H, R, Dr, ps, Pseq, B=B)
    qc, qr, ckv, kr = (_tensor(a, dtype, cuda_device)
                       for a in (qc, qr, ckv, kr))
    bt, ln = (torch.as_tensor(a, device=cuda_device) for a in (bt, ln))
    scale = 1.0 / np.sqrt(R + Dr + 128)
    out = _launched_once(
        lambda: paged_mla_decode_attention(qc, qr, ckv, kr, bt, ln,
                                           scale=scale),
        paged_mla_decode_attention)
    want = ref.paged_mla_decode_attention_ref(qc, qr, ckv, kr, bt, ln,
                                              scale=scale)
    assert out.dtype == qc.dtype
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: the zero-length, partly filled and full rows of ``empty_row_lengths``,
#: pages scattered over the pool; (20, 96, 0, 8, 5) has two head groups,
#: (4, 40, 8, 4, 3) takes the CUDA-core kernel in bf16 too (R no multiple
#: of 16).  On a 132-SM card the tensor-core kernel splits a row over 4
#: blocks at B 3 (2 where the table has 2 or 3 chunks) and over none at
#: B 48.
@pytest.mark.cuda
@pytest.mark.parametrize("H,R,Dr,ps,Pseq", MLA + [MLA_PATH[0][1:],
                                                  (20, 96, 0, 8, 5),
                                                  (4, 40, 8, 4, 3)])
@pytest.mark.parametrize("B", [3, 48])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_mla_decode_attention_kernel_on_empty_rows(
        cuda_device, H, R, Dr, ps, Pseq, B, dtype):
    qc, qr, ckv, kr, bt, ln = mla_inputs(
        H, R, Dr, ps, Pseq, B=B,
        lengths=np.resize(empty_row_lengths(ps, Pseq), B))
    qc, qr, ckv, kr = (_tensor(a, dtype, cuda_device)
                       for a in (qc, qr, ckv, kr))
    bt, ln = (torch.as_tensor(a, device=cuda_device) for a in (bt, ln))
    scale = 1.0 / np.sqrt(R + Dr + 128)
    want = ref.paged_mla_decode_attention_ref(qc, qr, ckv, kr, bt, ln,
                                              scale=scale)
    out = _launched_once(
        lambda: paged_mla_decode_attention(qc, qr, ckv, kr, bt, ln,
                                           scale=scale),
        paged_mla_decode_attention)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,D,Dv", FLASH_MLA)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_takes_mla_head_dims(cuda_device, BH, T, D,
                                                    Dv, dtype):
    q, k, v = (_tensor(a, dtype, cuda_device)
               for a in flash_inputs(BH, T, D, Dv))
    out = _launched_once(lambda: flash_attention(q, k, v), flash_attention)
    assert out.shape == (BH, T, Dv)
    assert_allclose(_to_np(out), _to_np(ref.flash_attention_ref(q, k, v)),
                    **TOL[dtype])


@pytest.mark.cuda
def test_cuda_moe_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((4, 16), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        topk_router(x.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        topk_router(torch.zeros((16, 4), device=cuda_device).T, 2)
    with pytest.raises(ValueError, match="experts"):
        topk_router(torch.zeros((2, 5000), device=cuda_device), 2)
    qc, qr, ckv, kr, bt, ln = (torch.as_tensor(a, device=cuda_device)
                               for a in mla_inputs(4, 32, 8, 4, 2))
    with pytest.raises(TypeError):
        paged_mla_decode_attention(qc.half(), qr.half(), ckv.half(),
                                   kr.half(), bt, ln, scale=1.0)
    with pytest.raises(TypeError):
        paged_mla_decode_attention(qc, qr.bfloat16(), ckv, kr, bt, ln,
                                   scale=1.0)
    wide = torch.zeros((2, 4, 600), device=cuda_device)
    pages = torch.zeros((6, 4, 600), device=cuda_device)
    with pytest.raises(ValueError, match="R in"):
        paged_mla_decode_attention(wide, qr, pages, kr, bt, ln, scale=1.0)
    big = torch.zeros((2, 8, 260), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(big, big, torch.zeros((2, 8, 128),
                                              device=cuda_device))


@pytest.mark.cuda
def test_reduced_deepseek_engines_on_the_card_match_the_cpu(cuda_device):
    """Both engines of the reduced deepseek (fp32, one lead and one MoE
    layer) through the kernels on the card, against the CPU's plain
    versions: identical greedy tokens and the exact launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import PagedServeEngine, ServeEngine
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))
    params = make_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         "cpu")
    prompt = np.random.default_rng(6).integers(0, 1024, (3, 13))
    out = {}
    for dev in (cuda_device, "cpu"):
        ops.reset_launches()
        for name, eng in (
                ("dense", ServeEngine(cfg, params, batch_size=3, max_len=64,
                                      device=dev)),
                ("paged", PagedServeEngine(cfg, params, max_seqs=3,
                                           page_size=8, max_len=64,
                                           device=dev))):
            out[(name, str(dev))] = eng.generate(prompt, 6).cpu()
        counts = ops.launch_counts()
        if dev == "cpu":
            assert set(counts.values()) == {0}
        else:
            # 3 admissions and 5 steps per engine; 1 MoE layer of 2
            assert counts["topk_router"] == 2 * (3 + 5)
            assert counts["flash_attention"] == 2 * 2 * 3
            assert counts["paged_mla_decode_attention"] == 2 * 5
            assert counts["decode_attention"] == 0
    for name in ("dense", "paged"):
        assert torch.equal(out[(name, str(cuda_device))], out[(name, "cpu")])
