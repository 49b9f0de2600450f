"""The cluster instance of ``csrc/gru_seq.cu``, emulated on the CPU.

A CUDA kernel cannot run here, so its decomposition is replayed in plain
torch: per cluster of S blocks and bb rows, each block forms the r, z
and n columns of its own units only; lane l of a unit's 8 lanes sums
its KC rows of W_h with one fused multiply-add at a time (fp32 rounding
after each, from float64 products), the 8 lanes' partials are added in
the kernel's butterfly tree (lane pairs l ^ 4, then ^ 2, ^ 1); the
new state of every block's units is then exchanged before the next step.
The emulation is held against JAX's ``gru_seq`` in Pallas interpret mode
and against ``repro/kernels/ref.py`` within the GRU tolerance, 2e-5, and
the wrapper's instance rule and cluster shapes against what the kernel
takes."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels import gru_cell, ref  # noqa: E402

GRU_TOL = dict(atol=2e-5, rtol=2e-5)
LANES = 8
MAX_THREADS = 512


def _inputs(B, T, h, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, 3 * h)).astype(np.float32),
            r.normal(size=(B, h)).astype(np.float32),
            (r.normal(size=(h, 3 * h)) * 0.1).astype(np.float32))


def _k_per_lane(h):
    """``kc_for``: rows of W_h a lane holds, the least of 2, 4, 8, 16
    with 8 * KC >= h."""
    return next(kc for kc in (2, 4, 8, 16) if h <= LANES * kc)


def _threads(h, S):
    """``threads_for``: whole warps of four units."""
    per_warp = 32 // LANES
    return 32 * math.ceil(math.ceil(h / S) / per_warp)


def _lane_rows(h):
    """(8, KC) row indices k of W_h that each lane holds, in the order its
    FMA chain takes them: k = j*8*G + l*G + q (G = min(KC, 4))."""
    kc = _k_per_lane(h)
    g = min(kc, 4)
    return np.array([[j * LANES * g + lane * g + q for j in range(kc // g)
                      for q in range(g)] for lane in range(LANES)])


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def emulate_cluster_kernel(xw, h0, w_h):
    """The cluster instance's arithmetic on (B,T,3h), (B,h), (h,3h) float32
    tensors, at the shape ``gru_cell.cluster_shape`` picks."""
    B, T, h3 = xw.shape
    h = h3 // 3
    S, bb = gru_cell.cluster_shape(B, h)
    U = math.ceil(h / S)
    rows = _lane_rows(h)
    hp = rows.size                      # padded state width, 8 * KC
    w_pad = torch.zeros(hp, h3, dtype=torch.float64)
    w_pad[:h] = w_h.double()
    out = torch.empty(B, T, h)
    for row0 in range(0, B, bb):
        n = min(bb, B - row0)
        x = torch.zeros(bb, T, h3)
        x[:n] = xw[row0:row0 + n]
        state = torch.zeros(bb, hp)      # rows past B stay zero inputs
        state[:n, :h] = h0[row0:row0 + n]
        for t in range(T):
            new = state.clone()
            for rank in range(S):        # each block: its units only
                units = list(range(rank * U, min(rank * U + U, h)))
                if not units:
                    continue
                cols = [g * h + u for g in range(3) for u in units]
                hk = state[:, rows].double()              # (bb, 8, KC)
                wk = w_pad[rows][:, :, cols]              # (8, KC, cols)
                acc = torch.zeros(bb, LANES, len(cols))
                for i in range(rows.shape[1]):            # fmaf chain
                    acc = (acc.double() + hk[:, :, i, None]
                           * wk[None, :, i, :]).float()
                while acc.shape[1] > 1:                   # xor 4, 2, 1
                    half = acc.shape[1] // 2
                    acc = acc[:, :half] + acc[:, half:]
                hr, hz, hn = acc[:, 0].reshape(bb, 3, len(units)).unbind(1)
                xr, xz, xn = x[:, t].reshape(bb, 3, h)[:, :, units].unbind(1)
                r = _sigmoid(xr + hr)
                z = _sigmoid(xz + hz)
                cand = torch.tanh(xn + r * hn)
                new[:, units] = (1.0 - z) * cand + z * state[:, units]
            state = new                  # the exchange, then the barrier
            out[row0:row0 + n, t] = state[:n, :h]
    return out


@pytest.mark.parametrize("B,T,h", [(1, 12, 128), (4, 12, 128), (16, 12, 128),
                                   (6, 24, 64), (8, 12, 32)])
def test_cluster_decomposition_matches_jax(B, T, h):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    xw, h0, wh = _inputs(B, T, h)
    got = emulate_cluster_kernel(*(torch.from_numpy(a) for a in (xw, h0, wh)))
    j_kernel = jops.gru_seq(jnp.asarray(xw), jnp.asarray(h0), jnp.asarray(wh))
    j_ref = jref.gru_seq_ref(jnp.asarray(xw), jnp.asarray(h0),
                             jnp.asarray(wh))
    assert_allclose(got.numpy(), np.asarray(j_kernel), **GRU_TOL)
    assert_allclose(got.numpy(), np.asarray(j_ref), **GRU_TOL)


@pytest.mark.parametrize("B,T,h", [(5, 12, 128), (17, 6, 128), (3, 1, 100),
                                   (2, 8, 20)])
def test_cluster_decomposition_matches_plain_on_ragged_shapes(B, T, h):
    """B no multiple of bb, T 1, h no multiple of S or of the 8 lanes: the
    padding adds nothing."""
    args = [torch.from_numpy(a) for a in _inputs(B, T, h, seed=B + h)]
    assert_allclose(emulate_cluster_kernel(*args).numpy(),
                    ref.gru_seq_ref(*args).numpy(), **GRU_TOL)


def test_instance_rule():
    assert gru_cell.CLUSTER_MAX_HIDDEN == 128
    for h in (1, 32, 64, 100, 128):
        assert gru_cell.instance(h) == "cluster"
    for h in (129, 256, 1024, gru_cell.MAX_HIDDEN):
        assert gru_cell.instance(h) == "general"
    # as the docstring of cluster_shape says, at the paper's width
    assert [gru_cell.cluster_shape(B, 128) for B in (1, 4, 16)] == [
        (8, 1), (8, 1), (8, 2)]
    assert gru_cell.cluster_shape(16, 32) == (4, 1)


@pytest.mark.parametrize("h", [1, 16, 20, 32, 33, 64, 100, 127, 128])
def test_cluster_shape_is_one_the_kernel_takes(h):
    """``cluster_takes`` of gru_seq.cu: S a power of two up to 8 (the
    portable cluster size), bb one up to 8 (one row a lane after the
    fold), at most 512 threads a block."""
    for B in list(range(1, 40)) + [256, 1000]:
        S, bb = gru_cell.cluster_shape(B, h)
        assert S in (1, 2, 4, 8) and bb in (1, 2, 4, 8)
        assert _threads(h, S) <= MAX_THREADS
        assert bb < 2 * B            # no cluster of empty rows only
