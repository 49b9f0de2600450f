"""flash_attention's split over the keys: where the TMA instance's blocks
leave SMs idle, each block's walk over the key tiles is split into S
chunks, a block each, and a second kernel merges the chunks' softmax
statistics (``csrc/flash_attention.cu``).

On the CPU: the host's rule for S (``flash_splits``: 1 at the serving
shapes and where the grid fills the card, more at gemma3's 1024-token
prefill and whisper's cross attention), the chunks the device gives a
block (``ref.flash_walk``, ``ref.flash_chunks``: whole 64-key tiles that
cover the block's walk once, windows starting inside a tile, a key length
of 1500) and the plain model of the split (``ref.flash_split_partials``:
each chunk's fp32 (o, m, l), a row with no visible key in its chunk and
every row of an empty chunk as (0, -2e38, 0), merged by
``ref.combine_partials``).  That model is held against JAX's
``flash_attention`` (Pallas, interpret mode) and ``repro.kernels.ref``
at S 1 to 6, causal with and without a window, G 1 and 4, head dims 64
and 256, in fp32 within 3e-5 and bf16 within 3e-2; the non-causal case
with a key length of its own against the port's plain version (JAX's
kernel asserts one length).  ``chip_smoke.py``'s expected merges at
the main paths' shapes are checked too.  The cases marked ``cuda`` hold
the kernel against its plain version on the card at the split and
serving shapes, replay a split call in a CUDA graph and check that a
refused launch raises; they skip here.  The JAX package is imported
inside the tests that use it."""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
#: an H100 SXM's SMs
H100_SMS = 132
SPLITS = list(range(1, 7))
#: queries a multiple of JAX's blocks; a window (40) that starts inside a
#: key tile
T = 256

#: (BH, BHkv, T, Tk, causal, window, D, Dv) of the serving and training
#: paths, and the big grids: S = 1.  stablelm and deepseek prefill (T
#: 64), gemma3's at T 64 and its training forward (window 512 >= T:
#: none), the expert-parallel rank (T 256), zamba2's forward (64 heads, T
#: 1024: 512 blocks), whisper's encoder (288 blocks over 1500 frames; a
#: split measured no faster) and gemma3's 4096-token training forward
UNSPLIT = [(24, 24, 1500, 1500, False, 0, 64, 64),
           (32, 32, 64, 64, True, 0, 64, 64),
           (16, 16, 64, 64, True, 0, 192, 128),
           (4, 1, 64, 64, True, 0, 256, 256),
           (16, 4, 64, 64, True, 0, 256, 256),
           (16, 16, 256, 256, True, 0, 192, 128),
           (64, 64, 1024, 1024, True, 0, 64, 64),
           (4, 1, 4096, 4096, True, 0, 256, 256)]
#: gemma3's long prefill (global, and the local layers' window 512) and
#: whisper's cross attention from 64 and 16 tokens to 1500 frames: S > 1
SPLIT = [(4, 1, 1024, 1024, True, 0, 256, 256),
         (4, 1, 1024, 1024, True, 512, 256, 256),
         (24, 24, 64, 1500, False, 0, 64, 64),
         (24, 24, 16, 1500, False, 0, 64, 64)]


def rows_of(BH, BHkv):
    return 64 if fa.paired(BH, BHkv) else 128


def split_model(q, k, v, S, causal=True, window=0):
    """The plain model of an S-chunk split, merged: o / l."""
    o, m, l = ref.flash_split_partials(q, k, v, S, causal=causal,
                                       window=window,
                                       rows=rows_of(q.shape[0], k.shape[0]))
    o, _, l = ref.combine_partials(o, m, l)
    return (o / l[..., None]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def case(D, G):
    """q (2G, T, D), k / v (2, T, D) from a numpy seed."""
    r = np.random.default_rng(D + G)
    return (r.normal(size=(2 * G, T, D)).astype(np.float32),
            r.normal(size=(2, T, D)).astype(np.float32),
            r.normal(size=(2, T, D)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_outputs(D, G, window, dtype):
    """JAX's Pallas kernel (interpret mode, one 256-row block a head) and
    its oracle, on the kv heads repeated G times."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    q, k, v = case(D, G)
    args = [jnp.asarray(a, getattr(jnp, dtype)) for a in
            (q, np.repeat(k, G, 0), np.repeat(v, G, 0))]
    return (np.asarray(jops.flash_attention(*args, causal=True, window=window,
                                            bq=T, bk=T), np.float32),
            np.asarray(jref.flash_attention_ref(*args, causal=True,
                                                window=window), np.float32))


# ---------------------------------------------------------------------------
# the plain model of the split against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("D,G,window", [(64, 1, 0), (64, 4, 40), (256, 1, 40),
                                        (256, 4, 0)])
def test_split_model_equals_the_jax_kernel_in_fp32(D, G, window, S):
    q, k, v = (torch.as_tensor(a) for a in case(D, G))
    got = split_model(q, k, v, S, window=window).numpy()
    for want in jax_outputs(D, G, window, "float32"):
        np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("S", [1, 3, 6])
@pytest.mark.parametrize("D,G", [(64, 4), (256, 1)])
def test_split_model_equals_the_jax_kernel_in_bf16(D, G, S, window=40):
    q, k, v = (torch.as_tensor(a).bfloat16() for a in case(D, G))
    got = split_model(q, k, v, S, window=window).float().numpy()
    for want in jax_outputs(D, G, window, "bfloat16"):
        np.testing.assert_allclose(got, want, **TOL["bfloat16"])


@pytest.mark.parametrize("S", [1, 3, 6])
@pytest.mark.parametrize("D,G", [(64, 1), (256, 2)])
def test_split_model_over_a_key_length_of_its_own(D, G, S):
    """Cross attention without the causal mask: 40 queries over 1500
    keys (no multiple of 64) against the port's plain version."""
    r = np.random.default_rng(S)
    q = torch.as_tensor(r.normal(size=(2 * G, 40, D)), dtype=torch.float32)
    k, v = (torch.as_tensor(r.normal(size=(2, 1500, D)), dtype=torch.float32)
            for _ in range(2))
    torch.testing.assert_close(
        split_model(q, k, v, S, causal=False),
        ref.flash_attention_ref(q, k, v, causal=False), **TOL["float32"])


def test_empty_chunks_and_unseen_rows_report_nothing():
    """A row's chunk before its window, and the trailing chunks of a
    short walk, give o = 0, m = -2e38, l = 0; each row has a chunk that
    sees a key."""
    q, k, v = (torch.as_tensor(a) for a in case(64, 1))
    o, m, l = ref.flash_split_partials(q, k, v, 6, rows=128, window=40)
    empty = m == ref.PARTIAL_NEG_INF
    assert empty.any()
    assert torch.all(l[empty] == 0) and torch.all(o[empty] == 0)
    assert torch.all((~empty).any(0))
    # rows 0..127's walk is the first two tiles: chunks 2.. are empty
    assert torch.all(empty[2:, :, :128])


# ---------------------------------------------------------------------------
# the host's rule for S and the chunks the device gives a block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", UNSPLIT)
def test_serving_shapes_and_full_grids_are_not_split(shape):
    assert fa.flash_splits(*shape, H100_SMS) == 1


@pytest.mark.parametrize("shape", SPLIT)
def test_long_walks_on_small_grids_are_split(shape):
    assert fa.flash_splits(*shape, H100_SMS) > 1


@pytest.mark.parametrize("sms", [66, 132])
@pytest.mark.parametrize("D,Dv", [(64, 64), (256, 256)])
@pytest.mark.parametrize("BH,BHkv", [(1, 1), (4, 1), (6, 3), (24, 24)])
@pytest.mark.parametrize("T,Tk,causal,window", [
    (64, 64, True, 0), (300, 300, True, 0), (1024, 1024, True, 0),
    (1024, 1024, True, 512), (2000, 2000, True, 100), (64, 1500, False, 0),
    (1500, 1500, False, 0)])
def test_flash_splits_rule(BH, BHkv, T, Tk, causal, window, D, Dv, sms):
    """S = 1 where the blocks fill the block slots or no walk exceeds 4
    tiles; else at most four waves of chunk blocks, chunks of at least 2
    tiles."""
    rows = rows_of(BH, BHkv)
    units = BH // 2 if fa.paired(BH, BHkv) else BH
    walks = [e - f for f, e in (ref.flash_walk(r, min(T, r + rows), Tk,
                                               causal, window)
                                for r in range(0, T, rows))]
    base = units * len(walks)
    slots = sms * fa.blocks_per_sm(D, Dv)
    S = fa.flash_splits(BH, BHkv, T, Tk, causal, window, D, Dv, sms)
    assert S >= 1
    if base >= slots or max(walks) <= fa.SPLIT_MIN_WALK:
        assert S == 1
        return
    assert base * S <= 4 * slots
    if S > 1:
        assert -(-max(walks) // S) >= fa.SPLIT_MIN_CHUNK


@pytest.mark.parametrize("units,D", [(132, 256), (264, 256), (264, 64),
                                     (528, 64)])
def test_whole_waves_of_equal_walks_are_not_split(units, D):
    """Non-causal 128-row blocks of one walk each, as many as the block
    slots (one an SM at D 256, two at D 64) or twice that: S = 1."""
    assert fa.flash_splits(units, units, 128, 1500, False, 0, D, D,
                           H100_SMS) == 1


def _check_cover(first, end, S):
    chunks = ref.flash_chunks(first, end, S)
    assert len(chunks) == S
    per = -(-(end - first) // S)
    assert chunks[0][0] == first and chunks[-1][1] == end
    for (a, b), (c, d) in zip(chunks, chunks[1:]):
        assert b == c and (d == c or b - a == per)
    covered = [t for a, b in chunks for t in range(a, b)]
    assert covered == list(range(first, end))


@pytest.mark.parametrize("S", SPLITS + [16])
@pytest.mark.parametrize("Tq,Tk,causal,window,rows", [
    (1024, 1024, True, 0, 64), (1024, 1024, True, 512, 64),
    (1000, 1000, True, 300, 128), (256, 256, True, 40, 128),
    (64, 1500, False, 0, 128), (1500, 1500, False, 0, 128),
    (200, 200, True, 1, 64)])
def test_chunks_cover_each_walk_once_in_whole_tiles(Tq, Tk, causal, window,
                                                    rows, S):
    for r0 in range(0, Tq, rows):
        first, end = ref.flash_walk(r0, min(Tq, r0 + rows), Tk, causal,
                                    window)
        assert 0 <= first < end <= -(-Tk // 64)
        # every key a row of the block sees lies in the walk
        lo = max(0, r0 - window + 1) if window else 0
        hi = min(Tk, min(Tq, r0 + rows)) if causal else Tk
        assert first * 64 <= lo and hi <= end * 64
        # a window that starts inside a tile starts the walk at that tile
        assert first == lo // 64
        _check_cover(first, end, S)


def test_scratch_is_empty_unless_split():
    assert fa.scratch(1, 4, 1024, 256, "cpu").numel() == 0
    work = fa.scratch(4, 4, 1024, 256, "cpu")
    assert work.dtype == torch.float32
    assert work.numel() == 4 * 4 * 1024 * 258


def test_the_wrapper_takes_no_new_keyword():
    assert set(inspect.signature(fa.flash_attention).parameters) == {
        "q", "k", "v", "causal", "window"}


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    q, k, v = (torch.as_tensor(a) for a in case(64, 4))
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == 0 and fa.flash_attention.merges == 0


def test_instances_by_rows_and_alignment():
    """bf16 rows of whole 16-byte pieces take the TMA instance; D or Dv no
    multiple of 8, or a view that starts off 16 bytes, the other."""
    x = torch.zeros((2, 8, 72), dtype=torch.bfloat16)
    assert fa.instance(x, x, x) == "tma"
    assert fa.instance(x[..., :40], x[..., :40], x[..., :40]) == "tma"
    odd = torch.zeros((2, 8, 36), dtype=torch.bfloat16)
    assert fa.instance(odd, odd, odd) == "wgmma"
    flat = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 8, 64)
    assert fa.instance(shifted, x[..., :64], x[..., :64]) == "wgmma"


def test_signature_passes_scratch_and_chunks():
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    sig = build.SIGNATURES["flash_attention_bf16"]
    assert sig[:5] == (P,) * 5 and sig[5:14] == (I,) * 9 and sig[14] == P
    assert build.SIGNATURES["flash_attention_f32"] == (P,) * 4 + (I,) * 8 \
        + (P,)


def _chip_smoke():
    """``chip_smoke.py`` (the repo root's) as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def h100_sms(monkeypatch):
    from repro_torch.kernels import fedavg_reduce as fr
    monkeypatch.setattr(fr, "sms", lambda *_: H100_SMS)


@pytest.mark.parametrize("rows,T,splits", [(1, 1024, 26), (1, 64, 0),
                                           (4, 64, 0), (1, 4096, 0)])
def test_chip_smoke_expects_merges_at_gemma3_paths(h100_sms, rows, T,
                                                   splits):
    """The merges ``chip_smoke.py`` expects of gemma3-1b's layers: its
    600-token prompt prefills one row at T 1024 (the engines admit a row
    at a time), where every layer, local or global, splits; the serving
    prompts (T 64), the training batch (4 x 64) and the remat batch (1 x
    4096) split none."""
    from repro_torch.configs import get_config
    m = get_config("gemma3-1b").model
    assert sum(_chip_smoke().flash_split_layers(m, rows, T)) == splits


def test_chip_smoke_expects_merges_at_the_other_paths(h100_sms):
    """whisper's forward merges once a decoder layer a pass (the cross
    attention, 64 tokens to 1500 frames), its encodings never; zamba2's
    forward (2 x 1024, 32 heads) and the fp32 parity cuts never."""
    import dataclasses
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    w = get_config("whisper-small").model
    assert cs.expected_whisper_launches(w, 1, 2, 0, 0)[
        "flash_attention_merge"] == 2 * w.num_layers
    z = get_config("zamba2-1.2b").model
    assert cs.expected_hybrid_launches(z, (2, 1024), 2, 8, 8)[0][
        "flash_attention_merge"] == 0
    g = get_config("gemma3-1b").model
    fp32 = dataclasses.replace(g, dtype="float32", param_dtype="float32")
    assert not any(cs.flash_split_layers(fp32, 1, 1024))
    assert "flash_attention_merge" in ops.launch_counts()


# ---------------------------------------------------------------------------
# on the card: the split kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def card_inputs(BH, BHkv, Tq, Tk, D, Dv, device, seed=0):
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.normal(size=s), dtype=torch.float32)
            .to(device, torch.bfloat16)
            for s in ((BH, Tq, D), (BHkv, Tk, D), (BHkv, Tk, Dv))]


#: (BH, BHkv, T, Tk, D, Dv, causal, window): the split shapes, small
#: grids that split, and the serving ones
CARD = [(4, 1, 1024, 1024, 256, 256, True, 0),
        (4, 1, 1024, 1024, 256, 256, True, 512),
        (24, 24, 64, 1500, 64, 64, False, 0),
        (24, 24, 16, 1500, 64, 64, False, 0),
        (2, 2, 1024, 1024, 64, 64, True, 0),
        (6, 3, 700, 700, 192, 128, True, 0),
        (2, 2, 1000, 1000, 128, 128, True, 300),
        (32, 32, 64, 64, 64, 64, True, 0),
        (16, 16, 64, 64, 192, 128, True, 0),
        (4, 1, 64, 64, 256, 256, True, 0),
        (16, 4, 64, 64, 256, 256, True, 0),
        (16, 16, 256, 256, 192, 128, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD)
def test_kernel_matches_plain_at_split_and_serving_shapes(cuda_device,
                                                          shape):
    BH, BHkv, Tq, Tk, D, Dv, causal, window = shape
    q, k, v = card_inputs(BH, BHkv, Tq, Tk, D, Dv, cuda_device)
    S = fa.splits(q, k, v, causal, window)
    ops.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1
    assert fa.flash_attention.merges == int(S > 1)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL["bfloat16"])


@pytest.mark.cuda
def test_split_call_replays_in_a_cuda_graph(cuda_device):
    q, k, v = card_inputs(4, 1, 1024, 1024, 256, 256, cuda_device)
    assert fa.splits(q, k, v, True, 0) > 1
    eager = fa.flash_attention(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(0, 64), (2, 36)])
def test_a_refused_launch_raises(cuda_device, S, D):
    """S 0, and a split of rows that are no whole 16-byte pieces (the
    one-warpgroup instance never splits), are refused by the entry
    point; the launch raises."""
    q, k, v = card_inputs(2, 2, 128, 128, D, D, cuda_device)
    out = torch.empty_like(q)
    work = fa.scratch(2, 2, 128, D, cuda_device)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        build.launch("flash_attention_bf16", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), work.data_ptr(), 2, 2,
                     128, 128, D, D, 1, 0, S,
                     torch.cuda.current_stream().cuda_stream)


#: (BH, BHkv, T, D, Dv, window) of rows the TMA instance does not take:
#: head dims no multiple of 8 (rows no whole 16-byte pieces), GQA, a
#: window, T no multiple of a tile, D 250 beside Dv 250
ODD_ROWS = [(2, 2, 100, 36, 36, 0), (4, 2, 77, 20, 44, 20),
            (2, 1, 130, 250, 250, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ODD_ROWS)
def test_one_warpgroup_instance_matches_plain(cuda_device, shape):
    BH, BHkv, Tq, D, Dv, window = shape
    q, k, v = card_inputs(BH, BHkv, Tq, Tq, D, Dv, cuda_device)
    assert fa.instance(q, k, v) == "wgmma"
    assert fa.splits(q, k, v, True, window) == 1
    ops.reset_launches()
    out = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.merges) == (1, 0)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL["bfloat16"])


@pytest.mark.cuda
def test_unaligned_views_take_the_one_warpgroup_instance(cuda_device):
    """q starting 2 bytes off a 16-byte boundary: the entry point takes
    the one-warpgroup instance, unsplit, even at a shape that splits."""
    q, k, v = card_inputs(24, 24, 64, 1500, 64, 64, cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert fa.instance(shifted, k, v) == "wgmma"
    assert fa.splits(shifted, k, v, False, 0) == 1 < fa.splits(q, k, v,
                                                                False, 0)
    out = fa.flash_attention(shifted, k, v, causal=False)
    torch.testing.assert_close(
        out.float(), ref.flash_attention_ref(q, k, v, causal=False).float(),
        **TOL["bfloat16"])
