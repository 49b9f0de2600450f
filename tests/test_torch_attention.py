"""The port's attention kernels against the JAX package's.

On the CPU the wrappers run their kernels' plain versions; those are held
against ``repro.kernels.ref`` and ``repro.kernels.ops`` (Pallas, interpret
mode) on the same numpy inputs, at the sweep shapes and tolerances of
``tests/test_kernels.py`` (fp32 3e-5, bf16 3e-2).  The cases marked
``cuda`` hold each CUDA kernel against its plain version on the card, at
the sweep shapes and at the LM serving path's shapes, and skip here.
The JAX package is imported inside the tests that use it, so the
``cuda`` cases also run where only PyTorch is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention)

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = ["float32", "bfloat16"]

#: tests/test_kernels.py sweeps, plus cases only the port takes: a T that
#: is no multiple of the TPU blocks, and GQA heads passed once (BHkv < BH)
FLASH = [(2, 2, 128, 64), (2, 2, 256, 32), (2, 2, 256, 128), (2, 2, 100, 64),
         (8, 4, 77, 32)]
DECODE = [(8, 2, 256), (4, 4, 128), (16, 2, 512)]
#: decode rows the kernel treats apart: no valid slot (the mean of every
#: slot's V), only the last slot valid; at G = 1, 4, 8 and 16, and B = 1
DECODE_EDGE = [(2, 4, 4, 256), (2, 8, 2, 256), (2, 16, 2, 256),
               (2, 32, 2, 256), (1, 32, 32, 256), (3, 8, 2, 77)]
#: flash shapes of the tensor-core kernel's edges: head dims no multiple
#: of 16 (zero-padded), T below one 64-row tile, and the zamba2 forward's
#: T 1024 (window 64 there crosses many tiles)
FLASH_EDGE = [(2, 2, 100, 40), (4, 2, 8, 32), (2, 2, 8, 40)]
PAGED = [(8, 2, 16, 4), (4, 4, 8, 6)]
PAGED_OPTS = [(0.0, None), (30.0, None), (0.0, 20)]
#: the paged engine's decode at full width (B = 32, 16-token pages)
PAGED_PATH = (32, 32, 16, 16)


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


def flash_inputs(BH, BHkv, T, D, seed=0):
    r = np.random.default_rng(seed)
    return _normal(r, (BH, T, D)), _normal(r, (BHkv, T, D)), \
        _normal(r, (BHkv, T, D))


def decode_inputs(H, Hkv, C, B=2, D=64, seed=0):
    r = np.random.default_rng(seed)
    valid = r.uniform(size=(B, C)) < 0.8
    valid[:, 0] = True                  # at least one valid slot
    return (_normal(r, (B, H, D)), _normal(r, (B, C, Hkv, D)),
            _normal(r, (B, C, Hkv, D)), valid)


def edge_valid(B, C):
    """Row b: no valid slot (b % 3 == 0), only slot C - 1 (b % 3 == 1), or
    80% of the slots at random."""
    r = np.random.default_rng(1)
    valid = np.zeros((B, C), bool)
    for b in range(B):
        if b % 3 == 1:
            valid[b, -1] = True
        elif b % 3 == 2:
            valid[b] = r.uniform(size=C) < 0.8
    return valid


def paged_inputs(H, Hkv, ps, Pseq, B=2, D=64, seed=0):
    """Distinct page ids per (row, page): a permutation of the pool, so
    the gather meets genuinely scattered pages."""
    r = np.random.default_rng(seed)
    num_pages = B * Pseq + 3
    bt = r.permutation(num_pages)[:B * Pseq].reshape(B, Pseq)
    lengths = r.integers(1, Pseq * ps + 1, (B,))
    return (_normal(r, (B, H, D)), _normal(r, (num_pages, ps, Hkv, D)),
            _normal(r, (num_pages, ps, Hkv, D)), bt.astype(np.int32),
            lengths.astype(np.int32))


def empty_row_lengths(ps, Pseq):
    """Rows the paged kernels treat apart: no token (every score -1e30,
    so the mean of V over all the row's gathered slots), a last page
    partly filled, and a full table."""
    return np.array([0, Pseq * ps - ps // 2 - 1, Pseq * ps], np.int32)


def mean_of_gathered_v(vp, bt_row, G):
    """(H, Dv): the uniform mean of V over a row's gathered slots."""
    Hkv, Dv = vp.shape[2], vp.shape[3]
    mean = vp[bt_row].reshape(-1, Hkv, Dv).mean(0)
    return np.repeat(mean, G, axis=0)


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,BHkv,T,D", FLASH)
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_jax(BH, BHkv, T, D, window, dtype):
    jnp, jops, jref = _jax()
    q, k, v = flash_inputs(BH, BHkv, T, D)
    out = flash_attention(*(_tensor(a, dtype) for a in (q, k, v)),
                          causal=True, window=window)
    assert out.shape == (BH, T, D) and out.dtype == getattr(torch, dtype)
    G = BH // BHkv
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype))
                  for a in (q, np.repeat(k, G, 0), np.repeat(v, G, 0)))
    want = [jref.flash_attention_ref(qj, kj, vj, causal=True, window=window)]
    blk = 64 if T % 64 == 0 else T
    want.append(jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                     bq=blk, bk=blk))
    for w in want:
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("H,Hkv,C", DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_jax(H, Hkv, C, dtype):
    jnp, jops, jref = _jax()
    q, k, v, valid = decode_inputs(H, Hkv, C)
    out = decode_attention(*(_tensor(a, dtype) for a in (q, k, v)),
                           torch.as_tensor(valid))
    assert out.shape == (2, H, 64) and out.dtype == getattr(torch, dtype)
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    for w in (jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid)),
              jops.decode_attention(qj, kj, vj, jnp.asarray(valid),
                                    bk=min(128, C))):
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("BH,BHkv,T,D", FLASH_EDGE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_jax_at_edge_shapes(BH, BHkv, T, D,
                                                          dtype):
    jnp, jops, jref = _jax()
    q, k, v = flash_inputs(BH, BHkv, T, D)
    out = flash_attention(*(_tensor(a, dtype) for a in (q, k, v)))
    G = BH // BHkv
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype))
                  for a in (q, np.repeat(k, G, 0), np.repeat(v, G, 0)))
    for w in (jref.flash_attention_ref(qj, kj, vj),
              jops.flash_attention(qj, kj, vj, bq=T, bk=T)):
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B,H,Hkv,C", DECODE_EDGE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_jax_on_edge_rows(B, H, Hkv, C, dtype):
    """A row with no valid slot is the uniform mean of its V in the JAX
    oracle and the Pallas kernel (every score -1e30), and so here."""
    jnp, jops, jref = _jax()
    q, k, v, _ = decode_inputs(H, Hkv, C, B=B)
    valid = edge_valid(B, C)
    out = decode_attention(*(_tensor(a, dtype) for a in (q, k, v)),
                           torch.as_tensor(valid))
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    bk = 128 if C % 128 == 0 else C
    for w in (jref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid)),
              jops.decode_attention(qj, kj, vj, jnp.asarray(valid), bk=bk)):
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])
    mean_v = v[0].reshape(C, Hkv, 1, 64).mean(0).repeat(H // Hkv, 1)
    assert_allclose(_to_np(out)[0], mean_v.reshape(H, 64), **TOL[dtype])


@pytest.mark.parametrize("H,Hkv,ps,Pseq", PAGED)
@pytest.mark.parametrize("soft_cap,window", PAGED_OPTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_plain_matches_jax(H, Hkv, ps, Pseq, soft_cap,
                                                  window, dtype):
    jnp, jops, jref = _jax()
    q, kp, vp, bt, lengths = paged_inputs(H, Hkv, ps, Pseq)
    out = paged_decode_attention(
        *(_tensor(a, dtype) for a in (q, kp, vp)), torch.as_tensor(bt),
        torch.as_tensor(lengths), soft_cap=soft_cap, window=window)
    assert out.shape == (2, H, 64) and out.dtype == getattr(torch, dtype)
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, kp, vp))
    args = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(lengths))
    for fn in (jref.paged_decode_attention_ref, jops.paged_decode_attention):
        w = fn(*args, soft_cap=soft_cap, window=window)
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("H,Hkv,ps,Pseq", PAGED)
@pytest.mark.parametrize("soft_cap,window", PAGED_OPTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_plain_matches_jax_on_empty_rows(
        H, Hkv, ps, Pseq, soft_cap, window, dtype):
    """A row with lengths 0 is the uniform mean of V over all its
    gathered slots in the JAX oracle and the Pallas kernel, and so
    here; beside it a partly filled last page and a full table."""
    jnp, jops, jref = _jax()
    q, kp, vp, bt, _ = paged_inputs(H, Hkv, ps, Pseq, B=3)
    lengths = empty_row_lengths(ps, Pseq)
    out = paged_decode_attention(
        *(_tensor(a, dtype) for a in (q, kp, vp)), torch.as_tensor(bt),
        torch.as_tensor(lengths), soft_cap=soft_cap, window=window)
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, kp, vp))
    args = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(lengths))
    for fn in (jref.paged_decode_attention_ref, jops.paged_decode_attention):
        w = fn(*args, soft_cap=soft_cap, window=window)
        assert_allclose(_to_np(out), np.asarray(w, np.float32), **TOL[dtype])
    vq = _to_np(_tensor(vp, dtype))
    assert_allclose(_to_np(out)[0], mean_of_gathered_v(vq, bt[0], H // Hkv),
                    **TOL[dtype])


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    flash_attention(*(torch.as_tensor(a) for a in flash_inputs(2, 2, 8, 4)))
    q, k, v, valid = decode_inputs(4, 2, 8, D=8)
    decode_attention(*(torch.as_tensor(a) for a in (q, k, v, valid)))
    paged_decode_attention(*(torch.as_tensor(a)
                             for a in paged_inputs(4, 2, 4, 2, D=8)))
    assert set(ops.launch_counts().values()) == {0}


def test_wrappers_check_shapes_and_dtypes():
    q, k, v = (torch.as_tensor(a) for a in flash_inputs(4, 4, 8, 16))
    with pytest.raises(ValueError, match="do not agree"):
        flash_attention(q, k[:3], v[:3])                   # 3 does not divide 4
    with pytest.raises(ValueError, match="do not agree"):
        flash_attention(q, k[:, :5], v[:, :5])
    q, k, v, valid = (torch.as_tensor(a) for a in decode_inputs(4, 2, 8))
    with pytest.raises(TypeError, match="bool"):
        decode_attention(q, k, v, valid.int())
    with pytest.raises(ValueError, match="do not agree"):
        decode_attention(q, k, v, valid[:, :4])
    q, kp, vp, bt, ln = (torch.as_tensor(a)
                         for a in paged_inputs(4, 2, 4, 2, D=8))
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q, kp, vp, bt.long(), ln)
    with pytest.raises(ValueError, match="do not agree"):
        paged_decode_attention(q, kp, vp, bt[:1], ln)
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(q, kp, vp, bt, ln, window=0)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(*(torch.as_tensor(a) for a in
                          flash_inputs(2, 2, 8, 4)[:2]),
                        torch.zeros((2, 8, 4), device="meta"))


def test_every_attention_entry_point_is_bound():
    text = "".join(p.read_text() for p in build.sources() + build.headers())
    for kernel in ("flash_attention", "decode_attention",
                   "paged_decode_attention"):
        assert f"{kernel}.cu" in {p.name for p in build.sources()}
        for t in ("f32", "bf16"):
            assert f'extern "C" int {kernel}_{t}(' in text
            assert f"{kernel}_{t}" in build.SIGNATURES
        # each source names the TPU kernel it replaces
        assert f"src/repro/kernels/{kernel}.py:\n// {kernel} " in text


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


#: + the serving path's shapes: prefill of full-width stablelm (32 heads,
#: 64-token bucket, head_dim 64) and of the reduced model (GQA 4/2)
@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,T,D", FLASH + [(32, 32, 64, 64),
                                                 (4, 2, 8, 32)]
                         + FLASH_EDGE[::2] + [(8, 8, 1024, 64)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_matches_plain(cuda_device, BH, BHkv, T, D,
                                              window, dtype):
    q, k, v = (_tensor(a, dtype, cuda_device)
               for a in flash_inputs(BH, BHkv, T, D))
    out = _launched_once(lambda: flash_attention(q, k, v, window=window),
                         flash_attention)
    want = ref.flash_attention_ref(q, k, v, window=window)
    assert out.dtype == q.dtype
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: + the dense engine's decode at full width (B = 1/4/8, C = 256)
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,C", [(2, *s) for s in DECODE]
                         + [(1, 32, 32, 256), (8, 32, 32, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_matches_plain(cuda_device, B, H, Hkv, C,
                                               dtype):
    q, k, v, valid = decode_inputs(H, Hkv, C, B=B)
    q, k, v = (_tensor(a, dtype, cuda_device) for a in (q, k, v))
    valid = torch.as_tensor(valid, device=cuda_device)
    out = _launched_once(lambda: decode_attention(q, k, v, valid),
                         decode_attention)
    assert_allclose(_to_np(out), _to_np(ref.decode_attention_ref(q, k, v,
                                                                 valid)),
                    **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,T,D,Dv", [(4, 2, 100, 64, 64),
                                            (2, 2, 77, 40, 24),
                                            (2, 1, 130, 192, 128)])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_without_causal_mask(cuda_device, BH, BHkv, T,
                                                    D, Dv, window, dtype):
    r = np.random.default_rng(3)
    q, k, v = (_tensor(_normal(r, s), dtype, cuda_device)
               for s in ((BH, T, D), (BHkv, T, D), (BHkv, T, Dv)))
    out = _launched_once(
        lambda: flash_attention(q, k, v, causal=False, window=window),
        flash_attention)
    want = ref.flash_attention_ref(q, k, v, causal=False, window=window)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: whisper's shapes (12 heads of dim 64: the encoder's 1500 frames, the
#: decoder's cross attention from 16 or 64 tokens to them) and edge ones
@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,T,Tk,D", [(24, 24, 1500, 1500, 64),
                                            (24, 24, 16, 1500, 64),
                                            (24, 24, 64, 1500, 64),
                                            (4, 2, 100, 77, 40),
                                            (2, 1, 1, 130, 192)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_with_own_key_length(cuda_device, BH, BHkv,
                                                    T, Tk, D, dtype):
    r = np.random.default_rng(4)
    q, k, v = (_tensor(_normal(r, s), dtype, cuda_device)
               for s in ((BH, T, D), (BHkv, Tk, D), (BHkv, Tk, D)))
    out = _launched_once(lambda: flash_attention(q, k, v, causal=False),
                         flash_attention)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert out.shape == (BH, T, D)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,C", DECODE_EDGE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_on_edge_rows(cuda_device, B, H, Hkv, C,
                                              dtype):
    q, k, v, _ = decode_inputs(H, Hkv, C, B=B)
    q, k, v = (_tensor(a, dtype, cuda_device) for a in (q, k, v))
    valid = torch.as_tensor(edge_valid(B, C), device=cuda_device)
    out = _launched_once(lambda: decode_attention(q, k, v, valid),
                         decode_attention)
    assert_allclose(_to_np(out), _to_np(ref.decode_attention_ref(q, k, v,
                                                                 valid)),
                    **TOL[dtype])


#: head dims of the 16-byte loads (40, 96, 128) and of the one-element
#: variant (33; 36 in bf16 only), with Dv apart from D
@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", [(33, 33), (36, 36), (40, 40), (96, 96),
                                  (128, 128), (64, 128), (128, 24)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (16, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_takes_head_dims(cuda_device, D, Dv, H, Hkv,
                                                 dtype):
    r = np.random.default_rng(4)
    B, C = 3, 200
    q = _tensor(_normal(r, (B, H, D)), dtype, cuda_device)
    k = _tensor(_normal(r, (B, C, Hkv, D)), dtype, cuda_device)
    v = _tensor(_normal(r, (B, C, Hkv, Dv)), dtype, cuda_device)
    valid = torch.as_tensor(r.uniform(size=(B, C)) < 0.5, device=cuda_device)
    out = _launched_once(lambda: decode_attention(q, k, v, valid),
                         decode_attention)
    assert_allclose(_to_np(out), _to_np(ref.decode_attention_ref(q, k, v,
                                                                 valid)),
                    **TOL[dtype])


#: + the paged engine's decode at full width (B = 32, 16-token pages)
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,ps,Pseq", [(2, *s) for s in PAGED]
                         + [(32, 32, 32, 16, 16)])
@pytest.mark.parametrize("soft_cap,window", PAGED_OPTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_kernel_matches_plain(
        cuda_device, B, H, Hkv, ps, Pseq, soft_cap, window, dtype):
    q, kp, vp, bt, ln = paged_inputs(H, Hkv, ps, Pseq, B=B)
    q, kp, vp = (_tensor(a, dtype, cuda_device) for a in (q, kp, vp))
    bt, ln = (torch.as_tensor(a, device=cuda_device) for a in (bt, ln))
    out = _launched_once(
        lambda: paged_decode_attention(q, kp, vp, bt, ln, soft_cap=soft_cap,
                                       window=window), paged_decode_attention)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                          soft_cap=soft_cap, window=window)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: the zero-length, partly filled and full rows of ``empty_row_lengths``,
#: pages scattered over the pool
@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,ps,Pseq", PAGED + [PAGED_PATH])
@pytest.mark.parametrize("soft_cap,window", PAGED_OPTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_kernel_on_empty_rows(
        cuda_device, H, Hkv, ps, Pseq, soft_cap, window, dtype):
    q, kp, vp, bt, _ = paged_inputs(H, Hkv, ps, Pseq, B=3)
    ln = empty_row_lengths(ps, Pseq)
    q, kp, vp = (_tensor(a, dtype, cuda_device) for a in (q, kp, vp))
    bt, ln = (torch.as_tensor(a, device=cuda_device) for a in (bt, ln))
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                          soft_cap=soft_cap, window=window)
    out = _launched_once(
        lambda: paged_decode_attention(q, kp, vp, bt, ln, soft_cap=soft_cap,
                                       window=window),
        paged_decode_attention)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


@pytest.mark.cuda
def test_cuda_attention_wrappers_raise_instead_of_falling_back(cuda_device):
    half = torch.zeros((2, 8, 16), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(half, half, half)
    f32 = torch.zeros((2, 8, 16), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(f32, f32.bfloat16(), f32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(f32.transpose(0, 1).contiguous().transpose(0, 1),
                        f32, f32)
    big = torch.zeros((2, 8, 264), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(big, big, big)
    q = torch.zeros((2, 4, 16), dtype=torch.float16, device=cuda_device)
    kv = torch.zeros((2, 8, 2, 16), dtype=torch.float16, device=cuda_device)
    valid = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        decode_attention(q, kv, kv, valid)
    pages = torch.zeros((5, 4, 2, 16), dtype=torch.float16,
                        device=cuda_device)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        paged_decode_attention(q, pages, pages, bt, ln)


# ---------------------------------------------------------------------------
# head dim 256 (gemma3: 4 query heads on 1 kv head): on the card only
# ---------------------------------------------------------------------------

#: gemma3's prefill (56-token prompt in the 64 bucket; the long prompt's
#: 1024 bucket under a 512 window), T no multiple of a tile, Dv apart
#: from D, and a row no multiple of 16 bytes
FLASH_256 = [(4, 1, 64, 256, 256, 0), (4, 1, 1024, 256, 256, 512),
             (4, 1, 1024, 256, 256, 0), (8, 2, 130, 256, 256, 40),
             (2, 2, 100, 256, 200, 0), (2, 1, 77, 136, 256, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,T,D,Dv,window", FLASH_256)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_head_dim_256(cuda_device, BH, BHkv, T, D,
                                                Dv, window, dtype):
    r = np.random.default_rng(T)
    q, k, v = (_tensor(_normal(r, s), dtype, cuda_device)
               for s in ((BH, T, D), (BHkv, T, D), (BHkv, T, Dv)))
    out = _launched_once(lambda: flash_attention(q, k, v, window=window),
                         flash_attention)
    want = ref.flash_attention_ref(q, k, v, window=window)
    assert out.shape == (BH, T, Dv)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: gemma3's dense decode: B 1/4/8 rows of 57-64 valid slots in a 256-slot
#: ring, the long run's 512-slot local ring and 1024-slot global ring;
#: the edge rows; D apart from Dv; a row no multiple of 16 bytes
DECODE_256 = [(1, 4, 1, 256, 256, 256), (8, 4, 1, 256, 256, 256),
              (4, 4, 1, 512, 256, 256), (4, 4, 1, 1024, 256, 256),
              (3, 8, 2, 200, 256, 160), (2, 4, 4, 96, 136, 256),
              (2, 4, 1, 64, 250, 250)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,C,D,Dv", DECODE_256)
@pytest.mark.parametrize("soft_cap", [0.0, 1.0, 30.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_head_dim_256(cuda_device, B, H, Hkv, C,
                                                 D, Dv, soft_cap, dtype):
    r = np.random.default_rng(C)
    q = _tensor(_normal(r, (B, H, D)), dtype, cuda_device)
    k = _tensor(_normal(r, (B, C, Hkv, D)), dtype, cuda_device)
    v = _tensor(_normal(r, (B, C, Hkv, Dv)), dtype, cuda_device)
    valid = torch.as_tensor(edge_valid(B, C) if B == 3 else
                            r.uniform(size=(B, C)) < 0.25,
                            device=cuda_device)
    out = _launched_once(
        lambda: decode_attention(q, k, v, valid, soft_cap=soft_cap),
        decode_attention)
    want = ref.decode_attention_ref(q, k, v, valid, soft_cap=soft_cap)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])


#: gemma3's paged decode: B 4/16/32 rows of 16-token pages, and the long
#: run's 616-token rows under the local layers' 512 window
PAGED_256 = [(4, 16, 64, None), (32, 16, 64, None), (4, 16, 64, 20),
             (3, 16, 40, 512), (2, 8, 12, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,ps,Pseq,window", PAGED_256)
@pytest.mark.parametrize("soft_cap", [0.0, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_kernel_at_head_dim_256(
        cuda_device, B, ps, Pseq, window, soft_cap, dtype):
    r = np.random.default_rng(Pseq)
    num_pages = B * Pseq + 3
    bt = r.permutation(num_pages)[:B * Pseq].reshape(B, Pseq)
    lengths = r.integers(1, Pseq * ps + 1, (B,))
    lengths[0] = 0 if B > 2 else lengths[0]
    q = _tensor(_normal(r, (B, 4, 256)), dtype, cuda_device)
    kp, vp = (_tensor(_normal(r, (num_pages, ps, 1, 256)), dtype,
                      cuda_device) for _ in range(2))
    bt, ln = (torch.as_tensor(a.astype(np.int32), device=cuda_device)
              for a in (bt, lengths))
    kw = dict(soft_cap=soft_cap, window=window)
    out = _launched_once(
        lambda: paged_decode_attention(q, kp, vp, bt, ln, **kw),
        paged_decode_attention)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln, **kw)
    assert_allclose(_to_np(out), _to_np(want), **TOL[dtype])
