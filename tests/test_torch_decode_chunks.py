"""The GQA decode kernels' split walk: a long row's slots walked in S
chunks, a block each, the chunks' softmax statistics merged in the same
launch (``csrc/decode_rows.cuh``).

On the CPU: the host's rule for S (``decode_splits``: 1 at the serving
shapes, more at the long ones, chunks of whole 32-slot windows that
cover the walk), the chunks the device gives a row (``ref.walk_chunks``)
and a plain model of the split built from ``ref.walk_chunks``,
``ref.decode_attention_partial_ref`` and ``ref.combine_partials``: each
chunk through the partial plain version, a chunk with no counted slot in
a row that has one (or with no slot at all) as the kernel reports it
(o = 0, m = -2e38, l = 0), then the merge.  That model is held against
the JAX kernels ``decode_attention`` and ``paged_decode_attention``
(Pallas, interpret mode) and their oracles in fp32 within 3e-5, at S 1
to 8, head dims 64 and 256, G 1 and 4, on rows whose valid slots end
inside a chunk, whose only valid slot is in the last chunk, with none (or
length 0) beside long rows, under windows that start inside a chunk, and
over 200 slots, no multiple of 32 * S; and, merged as the partial
instance merges, against ``decode_attention_partial_ref`` over the whole
share.  The cases marked ``cuda`` hold the kernels against their plain
versions on the card at split shapes and skip here; the JAX package is
imported inside the tests that use it."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
#: an H100 SXM's SMs
H100_SMS = 132
SPLITS = list(range(1, 9))
HEADS = [(64, 1), (64, 4), (256, 1), (256, 4)]   # (D, G)
HKV = 2
#: slots of a dense row and of a paged table (ps 8 x 25 pages): no
#: multiple of 32 * S for any S
C = 200
PS, PSEQ = 8, 25
#: paged rows: ends inside a chunk, a full table, length 0, two more
LENGTHS = [77, 200, 0, 150, 131]
#: None; 1: only a row's last token counts; windows that start inside a
#: chunk
WINDOWS = [None, 1, 13, 50]


def dense_valid(r):
    """valid (5, C): slots [0, 77) (ending inside a chunk); only the last
    slot (in the last chunk); none; 60% at random; every slot."""
    valid = np.zeros((5, C), bool)
    valid[0, :77] = True
    valid[1, C - 1] = True
    valid[3] = r.uniform(size=C) < 0.6
    valid[4] = True
    return valid


@functools.lru_cache(maxsize=None)
def dense_case(D, G):
    r = np.random.default_rng(D + G)
    q = r.normal(size=(5, G * HKV, D)).astype(np.float32)
    k, v = (r.normal(size=(5, C, HKV, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dense_valid(r)


@functools.lru_cache(maxsize=None)
def paged_case(D, G):
    """q, the pages (a pool with one page more than the tables name) and
    the block tables: every entry a distinct page of the shuffled pool."""
    r = np.random.default_rng(100 + D + G)
    P = len(LENGTHS) * PSEQ + 1
    q = r.normal(size=(len(LENGTHS), G * HKV, D)).astype(np.float32)
    kp, vp = (r.normal(size=(P, PS, HKV, D)).astype(np.float32)
              for _ in range(2))
    bt = r.permutation(P)[:len(LENGTHS) * PSEQ].reshape(len(LENGTHS), PSEQ)
    return q, kp, vp, bt.astype(np.int32), np.asarray(LENGTHS, np.int32)


def paged_rows(lengths, window):
    """Per row the counted tokens (B, PSEQ * PS) and the walk [first,
    last) the kernel takes: from the 32-slot window of the first counted
    token to the last, or every slot of a row with none."""
    slots = PSEQ * PS
    t = np.arange(slots)[None, :]
    ln = np.asarray(lengths)[:, None]
    valid = t < ln
    if window is not None:
        valid &= ln - 1 - t < window
    walks = []
    for row in valid:
        idx = np.flatnonzero(row)
        walks.append((idx[0] & ~31, idx[-1] + 1) if len(idx) else (0, slots))
    return valid, walks


def split_model(q, k, v, valid, S, walks=None):
    """The plain model of an S-chunk split: per chunk the partial plain
    version over its slots (nothing where the chunk is empty, or has no
    counted slot in a row that has one), merged by combine_partials.
    Returns the merged (o, m, l)."""
    B, H = q.shape[:2]
    Dv = v.shape[-1]
    walks = walks or [(0, k.shape[1])] * B
    o = torch.zeros((S, B, H, Dv))
    m = torch.full((S, B, H), ref.PARTIAL_NEG_INF)
    l = torch.zeros((S, B, H))
    for b, (first, last) in enumerate(walks):
        for c, (lo, hi) in enumerate(ref.walk_chunks(first, last, S)):
            counted = valid[b, lo:hi]
            if hi <= lo or (valid[b].any() and not counted.any()):
                continue
            part = ref.decode_attention_partial_ref(
                q[b:b + 1], k[b:b + 1, lo:hi], v[b:b + 1, lo:hi],
                counted[None])
            o[c, b], m[c, b], l[c, b] = (x[0] for x in part)
    return ref.combine_partials(o, m, l)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def jax_dense(D, G):
    """The JAX kernel (interpret mode, 40-slot blocks) and its oracle."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    args = [jnp.asarray(a) for a in dense_case(D, G)]
    return (np.asarray(jops.decode_attention(*args, bk=40)),
            np.asarray(jref.decode_attention_ref(*args)))


@functools.lru_cache(maxsize=None)
def jax_paged(D, G, window):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    args = [jnp.asarray(a) for a in paged_case(D, G)]
    return tuple(np.asarray(fn(*args, window=window)) for fn in
                 (jops.paged_decode_attention,
                  jref.paged_decode_attention_ref))


def gathered(kp, vp, bt):
    B = bt.shape[0]
    k, v = (x[bt.long()].reshape(B, PSEQ * PS, HKV, x.shape[-1])
            for x in (kp, vp))
    return k, v


# ---------------------------------------------------------------------------
# the plain model of the split against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("D,G", HEADS)
def test_split_model_equals_the_jax_dense_kernel(D, G, S):
    q, k, v, valid = _torch(*dense_case(D, G))
    o, _, l = split_model(q, k, v, valid, S)
    got = (o / l[..., None]).numpy()
    for want in jax_dense(D, G):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("D,G", HEADS)
def test_split_model_equals_the_jax_paged_kernel(D, G, window, S):
    q, kp, vp, bt, lengths = _torch(*paged_case(D, G))
    valid, walks = paged_rows(LENGTHS, window)
    k, v = gathered(kp, vp, bt)
    o, _, l = split_model(q, k, v, torch.as_tensor(valid), S, walks)
    got = (o / l[..., None]).numpy()
    for want in jax_paged(D, G, window):
        np.testing.assert_allclose(got, want, **TOL)
    torch.testing.assert_close(
        o / l[..., None], ref.paged_decode_attention_ref(
            q, kp, vp, bt, lengths, window=window), **TOL)


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("D,G", HEADS)
def test_merged_chunks_are_the_partial_statistics_of_the_share(D, G, S):
    """The partial instance's merged (o, m, l) over the S chunks against
    the partial plain version over the whole share: o as o / l (its
    elements cancel over the slots), m, l."""
    q, k, v, valid = _torch(*dense_case(D, G))
    o, m, l = split_model(q, k, v, valid, S)
    wo, wm, wl = ref.decode_attention_partial_ref(q, k, v, valid)
    torch.testing.assert_close(o / l[..., None], wo / wl[..., None], **TOL)
    torch.testing.assert_close(m, wm, **TOL)
    torch.testing.assert_close(l, wl, **TOL)
    # the row with no valid slot: -2e38, every slot weighed once
    assert torch.all(m[2] == ref.PARTIAL_NEG_INF)
    assert torch.all(l[2] == C)


def test_a_chunk_with_nothing_counted_weighs_nothing():
    """Beside a chunk with a counted slot, a part reporting (0, -2e38, 0)
    changes nothing; where every part reports -2e38 each weighs 1."""
    r = np.random.default_rng(7)
    o = torch.as_tensor(r.normal(size=(1, 2, 3, 4)), dtype=torch.float32)
    m = torch.as_tensor(r.normal(size=(1, 2, 3)), dtype=torch.float32)
    l = torch.as_tensor(r.uniform(1, 2, size=(1, 2, 3)), dtype=torch.float32)
    empty = (torch.zeros_like(o), torch.full_like(m, ref.PARTIAL_NEG_INF),
             torch.zeros_like(l))
    merged = ref.combine_partials(*(torch.cat([a, e]) for a, e in
                                    zip((o, m, l), empty)))
    for got, want in zip(merged, (o[0], m[0], l[0])):
        assert torch.equal(got, want)
    none = ref.combine_partials(torch.ones(3, 2, 4),
                                torch.full((3, 2), ref.PARTIAL_NEG_INF),
                                torch.full((3, 2), 5.0))
    assert torch.all(none[0] == 3) and torch.all(none[2] == 15)
    assert torch.all(none[1] == ref.PARTIAL_NEG_INF)


def test_plain_decode_sums_fp64_inputs_in_fp64():
    """The plain version keeps fp64 inputs in fp64 (the card's split
    decode check uses it as an exact witness for its fp32 cuts)."""
    q, k, v, valid = (torch.as_tensor(a) for a in dense_case(64, 4))
    got = ref.decode_attention_ref(q.double(), k.double(), v.double(), valid)
    assert got.dtype == torch.float64
    s = torch.einsum("bhd,bchd->bhc", q.double(),
                     k.double().repeat_interleave(4, dim=2)) / 8.0
    p = torch.softmax(s.masked_fill(~valid[:, None, :], -1e30), -1)
    want = torch.einsum("bhc,bchd->bhd", p,
                        v.double().repeat_interleave(4, dim=2))
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_sharded_merge_is_combine_partials():
    """``models/sharded.py`` merges the ranks' shares through the same
    plain combine."""
    import inspect
    from repro_torch.models import sharded
    assert "ref.combine_partials(" in inspect.getsource(
        sharded.decode_attention)


# ---------------------------------------------------------------------------
# the host's rule for S and the chunks the device gives a row
# ---------------------------------------------------------------------------

def dense_splits(B, H, Hkv, Cs, D, sms=H100_SMS):
    G = H // Hkv
    return da.decode_splits(B, Hkv, G, da.heads_per_block(G, D, D), Cs, sms)


def paged_splits(B, H, Hkv, ps, Pseq, D, window, sms=H100_SMS):
    G = H // Hkv
    return da.decode_splits(B, Hkv, G, da.heads_per_block(G, D, D),
                            pda.longest_walk(ps, Pseq, window), sms,
                            warps=da.PAGED_WARPS)


#: the serving tiers' shapes: stablelm (32 heads on 32, D 64) and gemma3
#: (4 on 1, D 256), dense at B 1/4/8 over 256-slot rings, paged at B
#: 4/16/32 over 16 pages of 16
SERVING_DENSE = [(B, H, Hkv, 256, D) for B in (1, 4, 8)
                 for H, Hkv, D in ((32, 32, 64), (4, 1, 256))]
SERVING_PAGED = [(B, H, Hkv, 16, 16, D, 0) for B in (4, 16, 32)
                 for H, Hkv, D in ((32, 32, 64), (4, 1, 256))]
#: the long ones: gemma3's 512 and 1024 rings at B 2, the split decode's
#: 16,384-slot shares at B 3 (gemma3, stablelm), whisper's 1500 cross
#: rows at B 1/4/8, and gemma3's paged 616-token rows (64 pages of 16,
#: window 512)
LONG_DENSE = [(2, 4, 1, 512, 256), (2, 4, 1, 1024, 256),
              (3, 4, 1, 16384, 256), (3, 32, 32, 16384, 64),
              (1, 12, 12, 1500, 64), (4, 12, 12, 1500, 64),
              (8, 12, 12, 1500, 64), (3, 8, 2, 1000, 64),
              (3, 4, 1, 1000, 256)]
LONG_PAGED = [(2, 4, 1, 16, 64, 256, 512), (3, 8, 2, 16, 63, 64, 0),
              (3, 4, 1, 16, 63, 256, 300)]


@pytest.mark.parametrize("shape", SERVING_DENSE)
def test_serving_dense_shapes_are_not_split(shape):
    assert dense_splits(*shape) == 1


@pytest.mark.parametrize("shape", SERVING_PAGED)
def test_serving_paged_shapes_are_not_split(shape):
    assert paged_splits(*shape) == 1


def _check_chunks(first, last, S, min_chunk):
    chunks = ref.walk_chunks(first, last, S)
    assert len(chunks) == S
    size = chunks[0][1] - chunks[0][0]
    assert size % 32 == 0 and size >= min_chunk
    # consecutive, from first to last, each a whole number of windows
    # but the last non-empty one
    assert chunks[0][0] == first
    for (a, b), (c, d) in zip(chunks, chunks[1:]):
        assert b == c and (d == c or b - a == size)
    assert chunks[-1][1] == last


@pytest.mark.parametrize("shape", LONG_DENSE)
def test_long_dense_shapes_are_split_into_whole_windows(shape):
    S = dense_splits(*shape)
    assert S > 1
    _check_chunks(0, shape[3], S, da.SPLIT_MIN_CHUNK)


@pytest.mark.parametrize("shape", LONG_PAGED)
def test_long_paged_shapes_are_split_into_whole_windows(shape):
    S = paged_splits(*shape)
    assert S > 1
    ps, Pseq, window = shape[3], shape[4], shape[6]
    walk = pda.longest_walk(ps, Pseq, window)
    _check_chunks(0, walk, S, da.SPLIT_MIN_CHUNK)
    # a row's own walk (any start on a window) is covered too
    for first in (0, 32, 96):
        chunks = ref.walk_chunks(first, first + walk - 5, S)
        assert chunks[0][0] == first and chunks[-1][1] == first + walk - 5


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("B,Hkv,G,D", [(1, 1, 1, 64), (2, 1, 4, 256),
                                       (3, 2, 4, 64), (4, 8, 6, 64),
                                       (8, 32, 1, 128), (64, 8, 4, 64)])
@pytest.mark.parametrize("walk", [64, 256, 520, 1500, 16384])
@pytest.mark.parametrize("warps", [da.DENSE_WARPS, da.PAGED_WARPS])
def test_decode_splits_rule(B, Hkv, G, D, walk, sms, warps):
    """S = 1 where the blocks fill the SMs or the walk is short; else at
    most two blocks an SM, and no chunk shorter than 64 slots."""
    kGB = da.heads_per_block(G, D, D)
    base = Hkv * B * -(-G // kGB)
    S = da.decode_splits(B, Hkv, G, kGB, walk, sms, warps=warps)
    assert S >= 1
    if base >= sms or walk <= da.SPLIT_MIN_WALK:
        assert S == 1
        return
    assert base * S <= 2 * sms
    if S > 1:
        # chunks of whole windows, never fewer than 64 slots
        _check_chunks(0, walk, S, da.SPLIT_MIN_CHUNK)


@pytest.mark.parametrize("G,D,Dv,want", [(1, 64, 64, 1), (4, 64, 64, 4),
                                         (6, 64, 64, 8), (8, 64, 64, 8),
                                         (6, 128, 128, 4), (4, 64, 128, 4),
                                         (4, 256, 256, 1), (4, 64, 256, 1),
                                         (1, 256, 256, 1)])
def test_heads_per_block_mirrors_the_kernels_dispatch(G, D, Dv, want):
    assert da.heads_per_block(G, D, Dv) == want


def test_longest_walk_bounds_every_rows_walk():
    """With a window, a row walks from the 32-slot window of its first
    counted token: never more than longest_walk's slots."""
    for ps, Pseq in ((16, 64), (8, 25), (16, 16)):
        slots = ps * Pseq
        for window in (0, 1, 13, 31, 32, 33, 300, 512, 5000):
            most = pda.longest_walk(ps, Pseq, window)
            assert most <= slots
            for length in range(1, slots + 1):
                hi = length
                lo = max(0, length - window) if window else 0
                assert hi - (lo & ~31) <= most


def test_scratch_is_empty_unless_split():
    assert da.scratch(1, 3, 4, 256, "cpu").numel() == 0
    work = da.scratch(5, 3, 4, 256, "cpu")
    assert work.dtype == torch.float32 and work.numel() == 5 * 3 * 4 * 258


def test_the_wrappers_take_no_new_keyword():
    import inspect
    assert set(inspect.signature(da.decode_attention).parameters) == {
        "q", "k", "v", "valid", "soft_cap"}
    assert set(inspect.signature(da.decode_attention_partial).parameters) \
        == {"q", "k", "v", "valid", "soft_cap"}
    assert set(inspect.signature(pda.paged_decode_attention).parameters) \
        == {"q", "k_pages", "v_pages", "block_tables", "lengths",
            "soft_cap", "window"}


# ---------------------------------------------------------------------------
# on the card: the split kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def long_dense(D, G, dtype, device, Cs=1000):
    """B 3 over Cs slots: valid [0, 517) (ends inside a chunk); only the
    last slot; none."""
    r = np.random.default_rng(D + G)
    q, k, v = (torch.as_tensor(r.normal(size=s), dtype=torch.float32)
               .to(device, dtype) for s in ((3, G * HKV, D),
                                            (3, Cs, HKV, D),
                                            (3, Cs, HKV, D)))
    valid = np.zeros((3, Cs), bool)
    valid[0, :517] = True
    valid[1, -1] = True
    return q, k, v, torch.as_tensor(valid, device=device)


CUDA_DTYPES = [torch.float32, torch.bfloat16]
CUDA_TOL = {torch.float32: TOL, torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
@pytest.mark.parametrize("D,G", HEADS)
def test_split_dense_kernel_matches_plain(cuda_device, D, G, dtype):
    q, k, v, valid = long_dense(D, G, dtype, cuda_device)
    assert da.splits(3, G * HKV, HKV, 1000, D, D, cuda_device) > 1
    ops.reset_launches()
    got = da.decode_attention(q, k, v, valid, soft_cap=1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    want = ref.decode_attention_ref(q, k, v, valid, soft_cap=1.0)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
@pytest.mark.parametrize("D,G", HEADS)
def test_split_partial_kernel_matches_plain(cuda_device, D, G, dtype):
    """The merged statistics at fp32's 3e-5 whatever q's dtype (both
    sides fp32 from the same inputs), o as o / l."""
    q, k, v, valid = long_dense(D, G, dtype, cuda_device)
    ops.reset_launches()
    got = da.decode_attention_partial(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_partial"] == 1
    want = ref.decode_attention_partial_ref(q, k, v, valid)
    for g, w in zip((got[0] / got[2][..., None], *got[1:]),
                    (want[0] / want[2][..., None], *want[1:])):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("D,G", HEADS)
def test_split_paged_kernel_matches_plain(cuda_device, D, G, window, dtype):
    """B 3 of 63 pages of 16: 517 tokens, a full table, length 0; the
    window 300 starts inside a chunk."""
    r = np.random.default_rng(D + G)
    lengths = torch.tensor([517, 1008, 0], dtype=torch.int32,
                           device=cuda_device)
    P = 3 * 63 + 1
    q, kp, vp = (torch.as_tensor(r.normal(size=s), dtype=torch.float32)
                 .to(cuda_device, dtype) for s in ((3, G * HKV, D),
                                                   (P, 16, HKV, D),
                                                   (P, 16, HKV, D)))
    bt = torch.as_tensor(r.permutation(P)[:3 * 63].reshape(3, 63),
                         dtype=torch.int32, device=cuda_device)
    assert pda.splits(3, G * HKV, HKV, 16, 63, D, D, window or 0,
                      cuda_device) > 1
    ops.reset_launches()
    got = pda.paged_decode_attention(q, kp, vp, bt, lengths, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == 1
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lengths,
                                          window=window)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
def test_split_kernel_replays_in_a_cuda_graph(cuda_device):
    """The chunks' counters reset themselves: a captured split call
    replayed three times gives the eager output each time."""
    q, k, v, valid = long_dense(256, 4, torch.bfloat16, cuda_device)
    eager = da.decode_attention(q, k, v, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, v, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, valid)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_a_refused_launch_raises(cuda_device):
    """S 0 is refused by the entry point, and the wrapper's launch
    raises."""
    q, k, v, valid = long_dense(64, 1, torch.float32, cuda_device)
    out = torch.empty((3, HKV, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        build.launch("decode_attention_f32", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), valid.data_ptr(), out.data_ptr(), 0, 3,
                     HKV, HKV, 1000, 64, 64, 0, 0.0,
                     torch.cuda.current_stream().cuda_stream)
