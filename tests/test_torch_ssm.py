"""The port's Mamba2 block against ``repro.models.ssm`` and its kernel
against ``repro.kernels``: ``mamba_chunk_scan``'s plain version against
the JAX oracle (``ref.mamba_chunk_ref``) and the Pallas kernel in
interpret mode, the plain SSD scan with an initial state and with two
groups, and one Mamba2 layer's forward and decode steps, on the same
numpy inputs.

Tolerances: the kernel sweeps use ``tests/test_kernels.py``'s 5e-4; the
model functions are fp32 on both sides and differ only in the order the
two frameworks sum products, 1e-4.  The cases marked ``cuda`` hold the
CUDA kernel against its plain version on the card (fp32 5e-4, bf16 3e-2
for ``y``) and skip here; the JAX package is imported inside the tests
that use it, so they also run where only PyTorch is installed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_chunk_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.params import from_numpy_tree  # noqa: E402

#: tests/test_kernels.py's sweep (L, H, P, N, chunk) and its tolerance
SWEEP = [(128, 4, 16, 8, 32), (64, 2, 32, 16, 64), (96, 8, 8, 8, 32)]
KERNEL_TOL = dict(atol=5e-4, rtol=5e-4)
#: the reduced zamba2's layer (H 32, P 16, N 16, chunk 32) at L 64, and
#: the full-width forward's (H 64, P 64, N 64, chunk 128) cut to L 256
MODEL_SHAPES = [(64, 32, 16, 16, 32), (256, 64, 64, 64, 128)]
#: fp32 on both sides; the frameworks sum products in other orders
TOL = dict(atol=1e-4, rtol=1e-4)
#: the reduced zamba2's SSM block at d_model 256: H 32 heads of P 16
SSM = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                chunk=32, ngroups=1)
D_MODEL = 256


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import ssm as jssm
    return jnp, jops, jref, jssm


def scan_inputs(B, L, H, P, N, G=None, seed=0, dt_hi=0.2):
    """tests/test_kernels.py's draws: normal x, B, C; dt uniform in
    [0.01, dt_hi); A in -[0.5, 2).  ``G`` adds a group axis to B/C."""
    r = np.random.default_rng(seed)
    bc = (B, L, N) if G is None else (B, L, G, N)
    return (r.normal(size=(B, L, H, P)).astype(np.float32),
            r.uniform(0.01, dt_hi, (B, L, H)).astype(np.float32),
            (-r.uniform(0.5, 2.0, H)).astype(np.float32),
            r.normal(size=bc).astype(np.float32),
            r.normal(size=bc).astype(np.float32))


def mamba_params(d_model, s, seed=0):
    """One Mamba2 layer in the JAX tree, fan-in normal weights, and
    A_log, D, dt_bias, conv_b and norm_scale drawn away from their
    zeros/ones init so every term shows."""
    dd = ssm.mamba_dims(d_model, s)
    d_in, H, N, G, ch = dd["d_in"], dd["H"], dd["N"], dd["G"], dd["conv_ch"]
    r = np.random.default_rng(seed)

    def draw(shape, std):
        return (r.normal(size=shape) * std).astype(np.float32)
    e = 2 * d_in + 2 * G * N + H
    return {"in_proj": draw((d_model, e), d_model ** -0.5),
            "conv_w": draw((s.conv_width, ch), 0.5),
            "conv_b": draw((ch,), 0.1),
            "A_log": draw((H,), 0.5),
            "D": 1.0 + draw((H,), 0.2),
            "dt_bias": draw((H,), 0.5),
            "norm_scale": 1.0 + draw((d_in,), 0.1),
            "out_proj": draw((d_in, d_model), d_in ** -0.5)}


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _np(t):
    return t.float().cpu().numpy()


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,H,P,N,chunk", SWEEP + MODEL_SHAPES[:1])
def test_mamba_chunk_scan_plain_matches_jax(L, H, P, N, chunk):
    jnp, jops, jref, _ = _jax()
    x, dt, A, Bm, Cm = scan_inputs(2, L, H, P, N)
    y, s = mamba_chunk_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    assert y.shape == (2, L, H, P) and s.shape == (2, H, N, P)
    assert y.dtype == s.dtype == torch.float32
    yr, sr = jref.mamba_chunk_ref(*(jnp.asarray(a) for a in (x, dt, A)),
                                  jnp.asarray(Bm)[:, :, None, :],
                                  jnp.asarray(Cm)[:, :, None, :], chunk)
    yk, sk = jops.mamba_chunk_scan(*(jnp.asarray(a)
                                     for a in (x, dt, A, Bm, Cm)),
                                   chunk=chunk)
    for want_y, want_s in ((yr, sr), (yk, sk)):
        assert_allclose(y.numpy(), np.asarray(want_y), **KERNEL_TOL)
        assert_allclose(s.numpy(), np.asarray(want_s), **KERNEL_TOL)


def test_mamba_chunk_scan_plain_is_the_models_scan():
    x, dt, A, Bm, Cm = _t(*scan_inputs(2, 96, 8, 8, 8))
    y, s = mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=32)
    y2, s2 = ssm.ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], 32)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    y3, s3 = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, 32)
    assert torch.equal(y, y3) and torch.equal(s, s3)


def test_mamba_chunk_scan_plain_chunking_is_invariant():
    """The chunk only regroups the sum: one chunk, two and six agree."""
    x, dt, A, Bm, Cm = _t(*scan_inputs(1, 96, 4, 8, 8, seed=3))
    outs = [mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=c) for c in (96, 48, 16)]
    for y, s in outs[1:]:
        assert_allclose(y.numpy(), outs[0][0].numpy(), **KERNEL_TOL)
        assert_allclose(s.numpy(), outs[0][1].numpy(), **KERNEL_TOL)


def test_mamba_chunk_scan_plain_survives_exp_overflow():
    """A chunk's log decay falls far enough that exp(cum_i - cum_j) for
    i < j is past fp32's range; the masked entries stay out of the sum
    (JAX's ``where`` drops its inf the same way)."""
    jnp, _, jref, _ = _jax()
    x, dt, A, Bm, Cm = scan_inputs(1, 64, 2, 8, 8, seed=5)
    dt = dt * 0 + 3.0                 # cum reaches -3 * 2 * 64 = -384
    A = A * 0 - 2.0
    y, s = mamba_chunk_scan(*_t(x, dt, A, Bm, Cm), chunk=64)
    assert bool(y.isfinite().all()) and bool(s.isfinite().all())
    yr, sr = jref.mamba_chunk_ref(*(jnp.asarray(a) for a in (x, dt, A)),
                                  jnp.asarray(Bm)[:, :, None, :],
                                  jnp.asarray(Cm)[:, :, None, :], 64)
    assert_allclose(y.numpy(), np.asarray(yr), **KERNEL_TOL)
    assert_allclose(s.numpy(), np.asarray(sr), **KERNEL_TOL)


def recurrence_f64(x, dt, A, Bm, Cm):
    """The SSD recurrence step by step in fp64 numpy: Bm/Cm (B,L,N)."""
    B, L, H, P = x.shape
    S = np.zeros((B, H, Bm.shape[-1], P))
    y = np.zeros((B, L, H, P))
    for t in range(L):
        a = np.exp(dt[:, t] * A)
        u = x[:, t] * dt[:, t, :, None]
        S = a[..., None, None] * S + Bm[:, t, None, :, None] * u[:, :, None, :]
        y[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], S)
    return y, S


def precision_inputs():
    """Decays steep enough that a 128-token chunk's prefix sums of dt * A
    reach -200 to -600: their difference, JAX's ``cum_i - cum_j``, keeps
    only ~1e-6 of y (1.4e-6 here); segment sums keep ~1e-7."""
    r = np.random.default_rng(21)
    return (r.normal(size=(1, 256, 2, 4)), r.uniform(1.0, 3.0, (1, 256, 2)),
            -np.array([1.5, 0.5]), r.normal(size=(1, 256, 4)),
            r.normal(size=(1, 256, 4)))


#: fp32 relative to the largest |y| and |state|: a few ulps
PRECISION_TOL = 1e-6


def test_ssd_chunked_decays_keep_fp32_precision():
    x, dt, A, Bm, Cm = precision_inputs()
    yr, sr = recurrence_f64(x, dt, A, Bm, Cm)
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (x, dt, A, Bm, Cm)]
    y, s = mamba_chunk_scan(*t, chunk=128)
    assert np.abs(y.numpy() - yr).max() <= PRECISION_TOL * np.abs(yr).max()
    assert np.abs(s.numpy() - sr).max() <= PRECISION_TOL * np.abs(sr).max()


def _split_bf16(v, terms=2):
    """An fp32 operand as the tensor-core kernel feeds it: hi = bf16(v),
    lo = bf16(v - hi), both rounded to nearest even, as fp32 values
    (``terms=1``: hi alone)."""
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float())[:terms]


def kernel_arithmetic(x, dt, A, Bm, Cm, chunk, terms=2):
    """The bf16 tensor-core instance of ``csrc/mamba_chunk_scan.cu``, its
    arithmetic in plain torch: the kernel's chunk (``kernel_chunk``), per
    chunk C.B^T of the bf16 values (exact products, fp32 sums); the local
    state B^T (w o x) with w_j = exp(seg(j, Q-1]) dt_j folded into B and
    split into hi and lo bf16 terms; the state pass S <- exp(seg(-1, Q-1])
    S + local over the chunks; y = exp(seg(-1, i]) C . (S_hi + S_lo) +
    (scores_hi + scores_lo) . x with scores = C.B^T o exp(seg(j, i]) o
    dt_j.  Every product has one operand that is bf16 as stored and one
    that is a bf16 term, so it is exact in fp32, as in the tensor cores;
    only the order of the fp32 sums differs from the kernel's.  ``terms=1``
    rounds each fp32 operand to bf16 once instead."""
    from repro_torch.kernels.mamba_scan import kernel_chunk
    B, L, H, P = x.shape
    Q = kernel_chunk(chunk)
    c = L // Q
    xf, Bf, Cf = (t.float() for t in (x, Bm, Cm))
    la = (dt * A).reshape(B, c, Q, H)
    seg = ssm._segsum(la)                          # (B, c, i, j, H)
    decay = torch.exp(seg).permute(0, 1, 4, 2, 3)  # (B, c, H, i, j)
    dtc = dt.reshape(B, c, Q, H).permute(0, 1, 3, 2)       # (B, c, H, j)
    xc = xf.reshape(B, c, Q, H, P).permute(0, 1, 3, 2, 4)  # (B, c, H, j, P)
    Bc, Cc = Bf.reshape(B, c, Q, -1), Cf.reshape(B, c, Q, -1)
    # the state pass: B o w as hi and lo terms against x
    w = decay[..., -1, :] * dtc                              # (B, c, H, j)
    local = sum(torch.einsum("bchjn,bchjp->bchnp", t, xc)
                for t in _split_bf16(Bc[:, :, None] * w[..., None], terms))
    a_chunk = torch.exp(la.sum(dim=2))                       # (B, c, H)
    s = torch.zeros_like(local[:, 0])
    enter = []
    for k in range(c):
        enter.append(s)
        s = a_chunk[:, k, :, None, None] * s + local[:, k]
    enter = torch.stack(enter, dim=1)                        # (B, c, H, N, P)
    # the outputs: C . S_enter, then the causal scores against x
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    inter = sum(torch.einsum("bcin,bchnp->bchip", Cc, t)
                for t in _split_bf16(enter, terms))
    cum = torch.exp(torch.cumsum(la, dim=2)).permute(0, 1, 3, 2)
    scores = cb[:, :, None] * decay * dtc[..., None, :]
    intra = sum(torch.einsum("bchij,bchjp->bchip", t, xc)
                for t in _split_bf16(scores, terms))
    y = cum[..., None] * inter + intra                       # (B, c, H, i, P)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, L, H, P)
    return y.to(x.dtype), s


@pytest.mark.parametrize("L,H,P,N,chunk",
                         SWEEP + [(256, 4, 64, 64, 128), (512, 2, 64, 64, 256)])
def test_tensor_core_arithmetic_meets_the_gates(L, H, P, N, chunk):
    """The bf16 tensor-core recipe (hi / lo bf16 terms of every fp32
    operand) on bf16 inputs, against the JAX oracle and the Pallas kernel
    in interpret mode on the same (bf16-rounded) values: y within bf16's
    3e-2, the fp32 state within 5e-4, the gates chip_smoke.py holds the
    kernel to.  The sweep shapes and zamba2's widths (P 64, N 64, chunk
    128, two chunks; and a 256-row chunk, which the kernel halves)."""
    jnp, jops, jref, _ = _jax()
    x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in
                        scan_inputs(2, L, H, P, N, seed=4))
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    y, s = kernel_arithmetic(x, dt, A, Bm, Cm, chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    args = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, Bm, Cm)]
    wants = [jref.mamba_chunk_ref(*args[:3], args[3][:, :, None],
                                  args[4][:, :, None], chunk)]
    if L <= 128:
        wants.append(jops.mamba_chunk_scan(*args, chunk=chunk))
    for want_y, want_s in wants:
        assert_allclose(_np(y), np.asarray(want_y), atol=3e-2, rtol=3e-2)
        assert_allclose(s.numpy(), np.asarray(want_s), **KERNEL_TOL)


def test_tensor_core_arithmetic_is_closer_than_the_gates():
    """The recipe keeps ~16 bits of each fp32 operand: at zamba2's widths
    its state lies within 2e-5 (relative to the largest entry) of the
    plain fp32 scan on the same bf16 inputs, 25x inside the 5e-4 gate;
    rounding the fp32 operands to bf16 once (hi alone) does not."""
    x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in
                        scan_inputs(1, 256, 4, 64, 64, seed=6))
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    _, sr = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, 128)
    scale = sr.abs().max().item()
    errs = [(kernel_arithmetic(x, dt, A, Bm, Cm, 128, terms)[1] - sr)
            .abs().max().item() / scale for terms in (2, 1)]
    assert errs[0] <= 2e-5 < errs[1]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(G, with_init):
    jnp, _, _, jssm = _jax()
    B, L, H, P, N = 2, 64, 4, 8, 16
    x, dt, A, Bm, Cm = scan_inputs(B, L, H, P, N, G=G, seed=G)
    s0 = (np.random.default_rng(9).normal(size=(B, H, N, P))
          .astype(np.float32) if with_init else None)
    y, s = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), 32,
                           s_init=None if s0 is None else torch.as_tensor(s0))
    yj, sj = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              32, s_init=None if s0 is None
                              else jnp.asarray(s0))
    assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    assert_allclose(s.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("G", [2, 4])
def test_scan_per_group_on_the_plain_version_equals_ssd_chunked(G):
    """The card's split of G groups into G one-group scans (heads
    ``g*H/G : (g+1)*H/G`` on ``B[:, :, g]``, ``C[:, :, g]``), each run
    on ``mamba_chunk_scan``'s plain version, equals the scan with the
    group axis, JAX's ``repeat(rep)`` mapping."""
    x, dt, A, Bm, Cm = _t(*scan_inputs(2, 64, 8, 8, 16, G=G, seed=G))
    got = ssm.scan_per_group(
        lambda *t: ref.mamba_chunk_scan_ref(*t, 32)[0], x, dt, A, Bm, Cm)
    want, _ = ssm.ssd_chunked(x, dt, A, Bm, Cm, 32)
    assert got.shape == want.shape == x.shape
    assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    # a wrong mapping (head h on group h % G) is told apart
    wrong = ssm.ssd_chunked(x, dt, A, Bm[:, :, torch.arange(8) % G],
                            Cm[:, :, torch.arange(8) % G], 32)[0]
    assert not np.allclose(wrong.numpy(), want.numpy(), atol=1e-3)


def test_ssd_chunked_s_init_continues_a_split_sequence():
    """Scanning the second half from the first half's final state gives
    the whole sequence's second half and final state."""
    x, dt, A, Bm, Cm = _t(*scan_inputs(2, 64, 4, 8, 8, G=1, seed=4))
    y, s = ssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
    _, s1 = ssm.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32],
                            Cm[:, :32], 16)
    y2, s2 = ssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:],
                             Cm[:, 32:], 16, s_init=s1)
    assert_allclose(y2.numpy(), y[:, 32:].numpy(), **TOL)
    assert_allclose(s2.numpy(), s.numpy(), **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_forward_layer_matches_jax(G):
    jnp, _, _, jssm = _jax()
    s = dataclasses.replace(SSM, ngroups=G)
    tree = mamba_params(D_MODEL, s)
    x = np.random.default_rng(1).normal(size=(2, 64, D_MODEL)).astype(
        np.float32)
    out = ssm.mamba2_forward(from_numpy_tree(tree, "cpu"), D_MODEL, s,
                             torch.as_tensor(x))
    want = jssm.mamba2_forward({k: jnp.asarray(v) for k, v in tree.items()},
                               D_MODEL, s, jnp.asarray(x))
    assert out.shape == (2, 64, D_MODEL)
    assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_mamba2_forward_chunk_is_capped_by_the_sequence():
    """L < chunk runs one chunk of L; L not a multiple raises, as in
    JAX."""
    tree = from_numpy_tree(mamba_params(D_MODEL, SSM), "cpu")
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 12, D_MODEL)).astype(np.float32))
    assert ssm.mamba2_forward(tree, D_MODEL, SSM, x).shape == (1, 12, D_MODEL)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.mamba2_forward(tree, D_MODEL, SSM, torch.cat([x] * 4, dim=1)[:, :40])


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_decode_layer_matches_jax(G):
    """Eight decode steps of one layer from a fresh state: every output
    and the final conv ring and SSD state."""
    jnp, _, _, jssm = _jax()
    s = dataclasses.replace(SSM, ngroups=G)
    tree = mamba_params(D_MODEL, s, seed=3)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = from_numpy_tree(tree, "cpu")
    x = np.random.default_rng(4).normal(size=(2, 8, D_MODEL)).astype(
        np.float32)
    st = ssm.init_ssm_state(2, D_MODEL, s, device="cpu")
    jst = jssm.init_ssm_state(2, D_MODEL, s)
    assert st.conv.dtype == st.s.dtype == torch.float32
    assert tuple(st.conv.shape) == jst.conv.shape
    assert tuple(st.s.shape) == jst.s.shape
    for t in range(8):
        out, st2 = ssm.mamba2_decode(tp, D_MODEL, s,
                                     torch.as_tensor(x[:, t:t + 1]), st)
        assert st2 is st                     # written in place
        want, jst = jssm.mamba2_decode(jp, D_MODEL, s,
                                       jnp.asarray(x[:, t:t + 1]), jst)
        assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **TOL)
    assert_allclose(st.s.numpy(), np.asarray(jst.s), **TOL)


def test_mamba2_decode_steps_reproduce_the_forward():
    """The recurrence and the chunked scan compute one function: decode
    steps from a fresh state give the forward's outputs (the 2e-3 of
    tests/test_decode_consistency.py)."""
    tp = from_numpy_tree(mamba_params(D_MODEL, SSM, seed=5), "cpu")
    x = torch.as_tensor(np.random.default_rng(6).normal(
        size=(2, 32, D_MODEL)).astype(np.float32))
    full = ssm.mamba2_forward(tp, D_MODEL, SSM, x)
    st = ssm.init_ssm_state(2, D_MODEL, SSM, device="cpu")
    steps = [ssm.mamba2_decode(tp, D_MODEL, SSM, x[:, t:t + 1], st)[0]
             for t in range(32)]
    assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=2e-3,
                    rtol=2e-3)


def test_bf16_forward_rounds_where_jax_rounds():
    """A bf16 layer against JAX's bf16 layer on the same bf16 weights:
    the conv taps, y + x * D and the projections round in bf16 on both
    sides (bf16's 3e-2 of tests/test_kernels.py)."""
    jnp, _, _, jssm = _jax()
    tree = mamba_params(D_MODEL, SSM, seed=7)
    f32 = ("A_log", "D", "dt_bias")
    jp = {k: jnp.asarray(v, jnp.float32 if k in f32 else jnp.bfloat16)
          for k, v in tree.items()}
    tp = from_numpy_tree({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    assert tp["in_proj"].dtype == torch.bfloat16
    assert tp["A_log"].dtype == torch.float32
    x = np.random.default_rng(8).normal(size=(2, 64, D_MODEL))
    xj = jnp.asarray(x, jnp.bfloat16)
    out = ssm.mamba2_forward(tp, D_MODEL, SSM, torch.as_tensor(
        np.array(xj.astype(jnp.float32))).bfloat16())
    want = jssm.mamba2_forward(jp, D_MODEL, SSM, xj)
    assert out.dtype == torch.bfloat16
    assert_allclose(_np(out), np.asarray(want, np.float32), atol=3e-2,
                    rtol=3e-2)


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    mamba_chunk_scan(*_t(*scan_inputs(1, 32, 2, 4, 4)), chunk=16)
    ssm.mamba2_forward(from_numpy_tree(mamba_params(D_MODEL, SSM), "cpu"),
                       D_MODEL, SSM, torch.zeros((1, 32, D_MODEL)))
    assert set(ops.launch_counts().values()) == {0}


def test_wrapper_checks_shapes():
    x, dt, A, Bm, Cm = _t(*scan_inputs(1, 32, 2, 4, 4))
    with pytest.raises(ValueError, match="does not divide"):
        mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=12)
    with pytest.raises(ValueError, match="do not agree"):
        mamba_chunk_scan(x, dt[:, :16], A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="do not agree"):
        mamba_chunk_scan(x, dt, A, Bm[:, :, None], Cm[:, :, None], chunk=16)
    with pytest.raises(ValueError, match="x \\(B,L,H,P\\)"):
        mamba_chunk_scan(x[0], dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mamba_chunk_scan(*(t.to("meta") for t in (x, dt, A, Bm, Cm)),
                         chunk=16)
    with pytest.raises(ValueError, match="different devices"):
        mamba_chunk_scan(x, dt, A.to("meta"), Bm, Cm, chunk=16)


def test_kernel_limits_fit_shared_memory():
    """The full-width zamba2 shape (Q 128, N 64, P 64) fits a block's
    shared memory on Hopper in fp32 and bf16, with room for the largest P
    at its N; the kernel runs a 256-row chunk as two of 128, so the
    largest N and P fit in bf16 but not in fp32, and the wrapper checks
    it."""
    from repro_torch.kernels import mamba_scan as ms
    assert [ms.kernel_chunk(q) for q in (1, 50, 128, 130, 256, 129, 258)] \
        == [1, 50, 128, 65, 128, 0, 0]
    for itemsize in (4, 2):
        assert ms.smem_bytes(128, 64, 64, itemsize) < ms.MAX_SMEM_BYTES
        assert ms.smem_bytes(128, 64, 128, itemsize) < ms.MAX_SMEM_BYTES
    assert ms.smem_bytes(128, 128, 128, 2) < ms.MAX_SMEM_BYTES
    assert ms.smem_bytes(128, 128, 128, 4) > ms.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _on(dev, arrays, dtype=torch.float32):
    """x, dt, A, Bm, Cm on ``dev``; x, Bm and Cm in ``dtype``."""
    x, dt, A, Bm, Cm = (torch.as_tensor(a, device=dev) for a in arrays)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,chunk",
                         [(2, *s) for s in SWEEP + MODEL_SHAPES]
                         + [(1, 12, 3, 5, 7, 12), (3, 100, 2, 128, 16, 50),
                            (1, 512, 2, 64, 32, 256)]
                         # one chunk; H off the kernel's 4-head tile; N 8
                         # and P 16 / 40 (40: the tensor cores' P); the
                         # zamba2 forward's shape at B 1
                         + [(2, 128, 4, 64, 64, 128), (1, 256, 6, 64, 64, 128),
                            (2, 256, 1, 64, 64, 128), (2, 128, 3, 16, 8, 64),
                            (2, 256, 3, 40, 32, 128), (1, 96, 5, 40, 24, 48),
                            (1, 1024, 64, 64, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_chunk_scan_kernel_matches_plain(cuda_device, B, L, H, P, N,
                                               chunk, dtype):
    dt_ = getattr(torch, dtype)
    x, dt, A, Bm, Cm = _on(cuda_device, scan_inputs(B, L, H, P, N), dt_)
    before = mamba_chunk_scan.launches
    y, s = mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba_chunk_scan.launches == before + 1
    yr, sr = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)
    assert y.dtype == dt_ and s.dtype == torch.float32
    tol = KERNEL_TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    assert_allclose(_np(y), _np(yr), **tol)
    # the state is fp32 from the same bf16-rounded inputs either way:
    # only the order of fp32 sums differs
    assert_allclose(_np(s), _np(sr), **KERNEL_TOL)


@pytest.mark.cuda
def test_mamba_chunk_scan_kernel_survives_exp_overflow(cuda_device):
    x, dt, A, Bm, Cm = scan_inputs(1, 256, 4, 64, 64, seed=5)
    x, dt, A, Bm, Cm = _on(cuda_device, (x, dt * 0 + 3.0, A * 0 - 2.0, Bm,
                                         Cm))
    y, s = mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=128)
    yr, sr = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, 128)
    assert bool(y.isfinite().all()) and bool(s.isfinite().all())
    assert_allclose(_np(y), _np(yr), **KERNEL_TOL)
    assert_allclose(_np(s), _np(sr), **KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_chunk_scan_kernel_keeps_fp32_precision(cuda_device, dtype):
    """The kernel's decays are segment sums too: against the fp64
    recurrence on the same (bf16-rounded, for bf16) inputs, the state
    stays within a few fp32 ulps, and so does y before its rounding to
    the output dtype (fp32 only)."""
    dt_ = getattr(torch, dtype)
    xt, dtt, At, Bt, Ct = _on(cuda_device, [a.astype(np.float32)
                                            for a in precision_inputs()],
                              dt_)
    yr, sr = recurrence_f64(*(t.double().cpu().numpy()
                              for t in (xt, dtt, At, Bt, Ct)))
    y, s = mamba_chunk_scan(xt, dtt, At, Bt, Ct, chunk=128)
    assert np.abs(_np(s) - sr).max() <= PRECISION_TOL * np.abs(sr).max()
    if dtype == "float32":
        assert np.abs(_np(y) - yr).max() <= PRECISION_TOL * np.abs(yr).max()


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    x, dt, A, Bm, Cm = _on(cuda_device, scan_inputs(1, 64, 2, 8, 8))
    with pytest.raises(TypeError, match="one dtype"):
        mamba_chunk_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="one dtype"):
        mamba_chunk_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(TypeError, match="float32 dt"):
        mamba_chunk_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_chunk_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                         A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="chunk <= 256"):
        mamba_chunk_scan(*_on(cuda_device, scan_inputs(1, 512, 1, 8, 8)),
                         chunk=512)
    with pytest.raises(ValueError, match="N <= 128"):
        mamba_chunk_scan(*_on(cuda_device, scan_inputs(1, 32, 1, 8, 160)),
                         chunk=32)


@pytest.mark.cuda
def test_mamba2_forward_on_the_card_takes_groups(cuda_device):
    """ngroups 2: one ``mamba_chunk_scan`` a group on its half of the
    heads, against ``ssd_chunked`` with the group axis on the CPU."""
    s = dataclasses.replace(SSM, ngroups=2)
    tree = mamba_params(D_MODEL, s, seed=13)
    x = np.random.default_rng(14).normal(size=(2, 64, D_MODEL)).astype(
        np.float32)
    before = mamba_chunk_scan.launches
    out = ssm.mamba2_forward(from_numpy_tree(tree, cuda_device), D_MODEL, s,
                             torch.as_tensor(x, device=cuda_device))
    torch.cuda.synchronize()
    assert mamba_chunk_scan.launches == before + 2
    want = ssm.mamba2_forward(from_numpy_tree(tree, "cpu"), D_MODEL, s,
                              torch.as_tensor(x))
    assert_allclose(_np(out), want.numpy(), **TOL)


@pytest.mark.cuda
def test_mamba2_forward_on_the_card_matches_the_cpu(cuda_device):
    tree = mamba_params(D_MODEL, SSM, seed=11)
    x = np.random.default_rng(12).normal(size=(2, 64, D_MODEL)).astype(
        np.float32)
    before = mamba_chunk_scan.launches
    out = ssm.mamba2_forward(from_numpy_tree(tree, cuda_device), D_MODEL,
                             SSM, torch.as_tensor(x, device=cuda_device))
    torch.cuda.synchronize()
    assert mamba_chunk_scan.launches == before + 1
    want = ssm.mamba2_forward(from_numpy_tree(tree, "cpu"), D_MODEL, SSM,
                              torch.as_tensor(x))
    assert_allclose(_np(out), want.numpy(), **TOL)


@pytest.mark.cuda
def test_reduced_zamba2_on_the_card_matches_the_cpu(cuda_device):
    """The reduced zamba2 (fp32; A_log, dt_bias and D drawn away from
    their init) through the kernels on the card against the CPU's plain
    versions: forward logits within 1e-4, the dense engine's greedy
    tokens identical, and the exact launch counts: per forward one
    mamba_chunk_scan per Mamba2 layer and one flash_attention per
    complete segment; serving one decode_attention per complete segment
    per prompt token and per step, and neither of the others."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("zamba2-1.2b").reduced()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))
    api = make_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(13)
    mb = params["mamba_layers"]["mamba"]
    for k, std, base in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                         ("D", 0.2, 1.0)):
        mb[k] = torch.as_tensor(base + r.normal(size=mb[k].shape) * std,
                                dtype=torch.float32)
    toks = r.integers(0, 1024, (2, 64))
    prompt = r.integers(0, 1024, (3, 13))
    logits, out = {}, {}
    for dev in (cuda_device, "cpu"):
        tp = from_numpy_tree(params, dev)
        ops.reset_launches()
        logits[str(dev)] = api.forward(tp, {"tokens": torch.as_tensor(
            toks, device=dev)})[0].cpu()
        fwd = ops.launch_counts()
        ops.reset_launches()
        out[str(dev)] = ServeEngine(cfg, params, batch_size=3, max_len=64,
                                    device=dev).generate(prompt, 6).cpu()
        serve = ops.launch_counts()
        if dev == "cpu":
            assert set(fwd.values()) == set(serve.values()) == {0}
        else:
            assert fwd["mamba_chunk_scan"] == 2
            assert fwd["flash_attention"] == 1
            assert sum(fwd.values()) == 3
            assert serve["decode_attention"] == 3 * 13 + 5
            assert sum(serve.values()) == serve["decode_attention"]
    assert_allclose(logits[str(cuda_device)].numpy(), logits["cpu"].numpy(),
                    **TOL)
    assert torch.equal(out[str(cuda_device)], out["cpu"])
