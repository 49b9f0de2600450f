"""A decode cache split along its slots: the dense decode kernel's
partial-statistics instance (``decode_attention_partial``) and its merge.

Each share of a row's slots gives (the unnormalised output, the row max,
the row sum); merged as ``models/sharded.py`` merges the ranks' shares
(m* = max m, sum o e^(m - m*) / sum l e^(m - m*)), the shares must give
the unsplit decode: the JAX kernel ``repro.kernels.ops.decode_attention``
(Pallas, interpret mode, as ``tests/test_kernels.py`` runs it) and its
oracle ``repro.kernels.ref.decode_attention_ref``, and with a soft cap
the reference model's own ``_sdpa`` with a key mask, which is what its
``gqa_decode`` computes (the JAX kernel has no cap).  fp32 within 3e-5,
at head dims 64 and 256, G 1 and 4, split points 0 and C among them, and
rows whose valid slots all lie in one share, rows with one valid slot
and rows with none at all.  The case marked ``cuda`` holds the kernel
against its plain version on the card and skips here; the JAX package is
imported inside the tests that use it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partial)

TOL = dict(atol=3e-5, rtol=3e-5)
C = 48
#: boundaries of the shares inside [0, C]: () is one share of all C
SPLITS = [(), (0,), (C,), (C // 2,), (5, 29), (0, C // 2, C)]


def _rows(r, B=6):
    """valid (B, C): random; only in [0, 8); only in [40, C); none; one
    slot (17); every slot."""
    valid = r.uniform(size=(B, C)) < 0.6
    valid[1] = np.arange(C) < 8
    valid[2] = np.arange(C) >= 40
    valid[3] = False
    valid[4] = np.arange(C) == 17
    valid[5] = True
    return valid


def _case(D, G, Hkv=2, seed=0):
    r = np.random.default_rng(seed)
    B = 6
    q = r.normal(size=(B, G * Hkv, D)).astype(np.float32)
    k, v = (r.normal(size=(B, C, Hkv, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, _rows(r, B)


def _shares(points):
    edges = [0, *points, C]
    return list(zip(edges[:-1], edges[1:]))


def merge(parts):
    """The shares' statistics merged as ``sharded.decode_attention``
    merges the ranks'."""
    o = torch.stack([p[0] for p in parts])
    m = torch.stack([p[1] for p in parts])
    s = torch.stack([p[2] for p in parts])
    w = torch.exp(m - m.amax(0, keepdim=True))
    return (o * w[..., None]).sum(0) / (s * w).sum(0)[..., None]


def split_decode(q, k, v, valid, points, soft_cap=0.0, fn=None):
    fn = fn or decode_attention_partial
    return merge([fn(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                     valid[:, a:b].contiguous(), soft_cap=soft_cap)
                  for a, b in _shares(points)])


def normalised(o, m, s):
    return o / s[..., None], m, s


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("points", SPLITS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 256])
def test_split_merge_equals_the_jax_kernel(D, G, points):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    q, k, v, valid = _case(D, G)
    got = split_decode(*_torch(q, k, v, valid), points).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    for want in (jops.decode_attention(*args), jref.decode_attention_ref(*args)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("points", SPLITS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 256])
def test_split_merge_with_soft_cap_equals_jax_gqa_decode(D, G, points):
    """Soft cap 1: against ``repro.models.attention._sdpa`` with the
    key mask, as the reference's ``gqa_decode`` calls it, and against the
    port's unsplit plain version."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import attention as jattn
    q, k, v, valid = _case(D, G, seed=1)
    got = split_decode(*_torch(q, k, v, valid), points, soft_cap=1.0)
    zeros = jnp.zeros((C,), jnp.int32)
    want = jattn._sdpa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                       zeros[:1], zeros, causal=False, window=None,
                       soft_cap=1.0, k_valid=jnp.asarray(valid))[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    whole = ref.decode_attention_ref(*_torch(q, k, v, valid), soft_cap=1.0)
    torch.testing.assert_close(got, whole, **TOL)


@pytest.mark.parametrize("D", [64, 256])
def test_share_with_no_valid_slot(D):
    """m = -2e38, l = the share's slots, o = the sum of their V; a share
    of no slot: m = -2e38, zeros."""
    q, k, v, valid = _torch(*_case(D, 4))
    o, m, s = decode_attention_partial(q, k[:, :8], v[:, :8],
                                       torch.zeros_like(valid[:, :8]))
    assert torch.all(m == ref.PARTIAL_NEG_INF)
    assert torch.all(s == 8)
    vsum = v[:, :8].sum(1).repeat_interleave(4, dim=1)
    torch.testing.assert_close(o, vsum, **TOL)
    o, m, s = decode_attention_partial(q, k[:, :0], v[:, :0], valid[:, :0])
    assert torch.all(m == ref.PARTIAL_NEG_INF)
    assert not o.any() and not s.any()
    assert o.shape == (6, 8, D) and m.shape == s.shape == (6, 8)


def test_shares_of_a_row_with_none_merge_to_the_mean_of_v():
    """Row 3 has no valid slot: every share reports -2e38 and the merge
    gives the uniform mean of V, as the unsplit kernel does."""
    q, k, v, valid = _torch(*_case(64, 1))
    got = split_decode(q, k, v, valid, (5, 29))
    torch.testing.assert_close(got[3], v[3].mean(0), **TOL)


def test_partial_statistics_equal_the_model_softmax():
    """One share's o / l is the plain decode over that share, and its m
    the largest valid score."""
    q, k, v, valid = _torch(*_case(64, 4))
    o, m, s = decode_attention_partial(q, k, v, valid)
    torch.testing.assert_close(o / s[..., None],
                               ref.decode_attention_ref(q, k, v, valid), **TOL)
    scores = torch.einsum("bhd,bchd->bhc", q,
                          k.repeat_interleave(4, dim=2)) / 8.0
    scores = scores.masked_fill(~valid[:, None, :], -torch.inf)
    best = scores.amax(-1)
    torch.testing.assert_close(m[valid.any(1)], best[valid.any(1)], **TOL)


def test_the_wrapper_is_the_plain_version_on_the_cpu():
    ops.reset_launches()
    q, k, v, valid = _torch(*_case(64, 4))
    got = ops.decode_attention_partial(q, k, v, valid, soft_cap=2.0)
    want = ref.decode_attention_partial_ref(q, k, v, valid, soft_cap=2.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
    assert ops.launch_counts()["decode_attention_partial"] == 0


def test_bf16_inputs_give_fp32_statistics():
    q, k, v, valid = _torch(*_case(64, 4))
    got = decode_attention_partial(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   valid)
    want = decode_attention_partial(*(x.bfloat16().float()
                                      for x in (q, k, v)), valid)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("bad,error,match", [
    (lambda q, k, v, m: (q[0], k, v, m), ValueError, "takes q"),
    (lambda q, k, v, m: (q, k[:, :, :1], v, m), ValueError, "do not agree"),
    (lambda q, k, v, m: (q[:, :3], k, v, m), ValueError, "do not agree"),
    (lambda q, k, v, m: (q, k, v, m[:, 1:]), ValueError, "do not agree"),
    (lambda q, k, v, m: (q, k, v, m.int()), TypeError, "bool"),
    (lambda q, k, v, m: (q, k, v, m.to("meta")), ValueError,
     "different devices"),
    (lambda q, k, v, m: tuple(x.to("meta") for x in (q, k, v, m)),
     ValueError, "cpu or cuda"),
])
def test_wrapper_argument_errors(bad, error, match):
    args = bad(*_torch(*_case(64, 4)))
    with pytest.raises(error, match=match):
        decode_attention_partial(*args)


def test_negative_soft_cap_raises():
    with pytest.raises(ValueError, match="soft_cap"):
        decode_attention_partial(*_torch(*_case(64, 4)), soft_cap=-1.0)


# ---------------------------------------------------------------------------
# on the card: the partial instance against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G", [(64, 1), (64, 4), (256, 4), (40, 2)])
@pytest.mark.parametrize("points", [(C // 2,), (0, 5, 29, C)])
def test_partial_kernel_matches_plain(cuda_device, dtype, D, G, points):
    """Each share through the kernel (one launch a share with a slot),
    its statistics and the merge against the plain version's within
    fp32's 3e-5 whatever q's dtype: both sides compute in fp32 from the
    same inputs and return fp32 (bf16's 3e-2 would pass a share with no
    valid slot whose o were zeros); D 40 takes the one-element loads."""
    tol = TOL["atol"]
    q, k, v, valid = (x.to(cuda_device) for x in _torch(*_case(D, G)))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    ops.reset_launches()
    got = split_decode(q, k, v, valid, points, soft_cap=1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_partial"] == sum(
        b > a for a, b in _shares(points))
    want = split_decode(q, k, v, valid, points, soft_cap=1.0,
                        fn=ref.decode_attention_partial_ref)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    for a, b in _shares(points):
        if b == a:
            continue
        share = [x[:, a:b].contiguous() for x in (k, v, valid)]
        got = decode_attention_partial(q, *share)
        want = ref.decode_attention_partial_ref(q, *share)
        assert {g.dtype for g in got} == {torch.float32}
        # o as o / l, as the merge uses it: o's elements cancel, so its
        # rounding scales with l
        for g, w in zip(normalised(*got), normalised(*want)):
            torch.testing.assert_close(g, w, atol=tol, rtol=tol)
