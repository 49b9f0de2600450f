"""The port's kernel wrappers against the JAX package's kernels.

On the CPU the wrappers run their kernels' plain versions; those are held
against ``repro.kernels.ops`` (Pallas, interpret mode) and
``repro.kernels.ref`` on the same numpy inputs, at the shapes and
tolerances of ``tests/test_kernels.py``.  The cases marked ``cuda`` hold
each CUDA kernel against its plain version on the card, and skip here.
The JAX package is imported inside the tests that use it, so the
``cuda`` cases also run where only PyTorch is installed."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import fedavg_reduce as fr_mod  # noqa: E402
from repro_torch.kernels import gru_cell  # noqa: E402

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
GRU_TOL = dict(atol=2e-5, rtol=2e-5)

GRU_SHAPES = [(8, 12, 32, 4), (4, 24, 64, 4), (2, 8, 128, 2)]
FEDAVG_SHAPES = [(20, 1000, 256), (4, 513, 128), (32, 4096, 4096)]


def _jax():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jops, jref


def _gru_inputs(B, T, h, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, T, 3 * h)).astype(np.float32),
            r.normal(size=(B, h)).astype(np.float32),
            (r.normal(size=(h, 3 * h)) * 0.1).astype(np.float32))


def _fedavg_inputs(C, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(C, N)).astype(np.float32),
            r.uniform(0.5, 2.0, C).astype(np.float32))


@pytest.mark.parametrize("B,T,h,bb", GRU_SHAPES)
def test_gru_seq_plain_matches_jax(B, T, h, bb):
    jops, jref = _jax()
    import jax.numpy as jnp
    xw, h0, wh = _gru_inputs(B, T, h)
    out = ops.gru_seq(*(torch.from_numpy(a) for a in (xw, h0, wh)))
    assert out.shape == (B, T, h) and out.dtype == torch.float32
    j_kernel = jops.gru_seq(jnp.asarray(xw), jnp.asarray(h0),
                            jnp.asarray(wh), bb=bb)
    j_ref = jref.gru_seq_ref(jnp.asarray(xw), jnp.asarray(h0),
                             jnp.asarray(wh))
    assert_allclose(out.numpy(), np.asarray(j_kernel), **GRU_TOL)
    assert_allclose(out.numpy(), np.asarray(j_ref), **GRU_TOL)


@pytest.mark.parametrize("C,N,bn", FEDAVG_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_plain_matches_jax(C, N, bn, dtype):
    jops, jref = _jax()
    import jax.numpy as jnp
    x, w = _fedavg_inputs(C, N)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = ops.fedavg_reduce(xt, torch.from_numpy(w))
    assert out.shape == (N,) and out.dtype == xt.dtype
    xj = jnp.asarray(x, getattr(jnp, dtype))
    j_kernel = jops.fedavg_reduce(xj, jnp.asarray(w), bn=bn)
    j_ref = jref.fedavg_reduce_ref(xj, jnp.asarray(w))
    got = out.float().numpy()
    assert_allclose(got, np.asarray(j_kernel, np.float32), **TOL[dtype])
    assert_allclose(got, np.asarray(j_ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B", [1, 3, 5, 16])
def test_gru_seq_takes_any_batch(B):
    """The JAX kernel asserts B % bb == 0; the port takes any B."""
    xw, h0, wh = _gru_inputs(B, 12, 16, seed=B)
    args = [torch.from_numpy(a) for a in (xw, h0, wh)]
    out = gru_cell.gru_seq(*args)
    assert out.shape == (B, 12, 16)
    # row b of a batch is the same sequence alone
    solo = gru_cell.gru_seq(args[0][-1:], args[1][-1:], args[2])
    assert_allclose(out[-1:].numpy(), solo.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    xw, h0, wh = _gru_inputs(2, 4, 8)
    ops.gru_seq(*(torch.from_numpy(a) for a in (xw, h0, wh)))
    x, w = _fedavg_inputs(3, 10)
    ops.fedavg_reduce(torch.from_numpy(x), torch.from_numpy(w))
    assert ops.launch_counts() == {
        "gru_seq": 0, "fedavg_reduce": 0, "flash_attention": 0,
        "decode_attention": 0, "decode_attention_partial": 0,
        "paged_decode_attention": 0, "paged_mla_decode_attention": 0,
        "topk_router": 0, "mamba_chunk_scan": 0,
        "flash_attention_merge": 0}


def test_wrappers_check_shapes_and_devices():
    xw, h0, wh = (torch.from_numpy(a) for a in _gru_inputs(2, 4, 8))
    with pytest.raises(ValueError):
        gru_cell.gru_seq(xw, h0[:1], wh)
    with pytest.raises(ValueError):
        gru_cell.gru_seq(xw[..., :-1], h0, wh)
    x, w = (torch.from_numpy(a) for a in _fedavg_inputs(3, 10))
    with pytest.raises(ValueError):
        fr_mod.fedavg_reduce(x, w[:2])
    with pytest.raises(ValueError, match="different devices"):
        fr_mod.fedavg_reduce(x, w.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fr_mod.fedavg_reduce(x.to("meta"), w.to("meta"))


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_every_kernel_source_is_built_and_bound():
    names = {p.name for p in build.sources()}
    assert names == {"gru_seq.cu", "fedavg_reduce.cu", "flash_attention.cu",
                     "decode_attention.cu", "paged_decode_attention.cu",
                     "paged_mla_decode_attention.cu", "topk_router.cu",
                     "mamba_chunk_scan.cu"}
    assert {p.name for p in build.headers()} == {"attention_common.cuh",
                                                 "decode_rows.cuh"}
    text = "".join(p.read_text() for p in build.sources())
    for entry in build.SIGNATURES:
        assert f'extern "C" int {entry}(' in text
    # each source names the TPU kernel it replaces
    assert "src/repro/kernels/gru_cell.py:gru_seq" in text
    assert "src/repro/kernels/fedavg_reduce.py:fedavg_reduce" in text
    assert "src/repro/kernels/topk_router.py:topk_router" in text
    assert "src/repro/kernels/mamba_scan.py:mamba_chunk_scan" in text
    assert ("src/repro/kernels/paged_decode_attention.py:\n"
            "// paged_mla_decode_attention ") in text
    assert len(build.source_hash()) == 16


def _entry_parameters():
    """Each ``extern "C"`` entry point of the sources: its parameter
    types as ctypes would pass them."""
    import ctypes
    import re
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    text = "".join(p.read_text() for p in build.sources())
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   text):
        types = []
        for param in params.split(","):
            kind = " ".join(param.split()[:-1]).replace("const ", "")
            types.append(ctypes.c_void_p if kind.endswith("*")
                         else kinds[kind])
        entries[name] = tuple(types)
    return entries


def test_signatures_match_the_entry_points():
    """``build.SIGNATURES`` passes each entry point's parameters in its
    order and types: the GQA decode kernels' and flash's bf16 scratch
    pointer and chunk count S among them."""
    import ctypes
    entries = _entry_parameters()
    assert set(entries) == set(build.SIGNATURES)
    for name, types in build.SIGNATURES.items():
        assert entries[name] == types, name
    P, I = ctypes.c_void_p, ctypes.c_int
    assert build.SIGNATURES["decode_attention_bf16"][4:7] == (P, P, I)
    assert build.SIGNATURES["decode_attention_partial_f32"][6:9] == (P, P, I)
    assert build.SIGNATURES["paged_decode_attention_bf16"][5:8] == (P, P, I)
    # flash's bf16 entry: the split's scratch after out, S after the shapes
    assert build.SIGNATURES["flash_attention_bf16"][4:6] == (P, I)
    assert build.SIGNATURES["flash_attention_bf16"][13:] == (I, P)


def _chip_smoke():
    """``chip_smoke.py`` (the repo root's) as a module: its parsers of
    the compiler's reports."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ptxas_report_reads_registers_and_spills():
    log = ("== decode_attention.cu\n"
           "ptxas info    : Compiling entry function '_Z1fPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1fPf\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers\n")
    assert _chip_smoke().ptxas_report(log) == {
        "_Z1fPf": {"spill_stores": 8, "spill_loads": 4, "registers": 168},
        "_Z1gv": {"registers": 32}}


def test_sass_counts_reads_opcodes_per_function():
    listing = (
        "\t\tFunction : _Z3mmav\n"
        "        /*0010*/  LDSM.16.M88.4 R4, [R2] ;\n"
        "        /*0020*/  HMMA.16816.F32.BF16 R8, R4, R12, R8 ;\n"
        "        /*0030*/  @P0 HMMA.16816.F32.BF16 R8, R4, R14, R8 ;\n"
        "\t\tFunction : _Z3ldgv\n"
        "        /*0010*/  @!P1 LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;\n"
        "        /*0020*/  LDG.E.64 R8, desc[UR4][R2.64] ;\n"
        "        /*0028*/  @!P0 LDG.E.EF.128 R12, desc[UR4][R2.64] ;\n"
        "        /*0030*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
        "        /*0040*/  REDUX.MAX.U32 UR5, R7 ;\n"
        "        /*0050*/  UCGABAR_ARV ;\n"
        "        /*0060*/  UCGABAR_WAIT ;\n")
    assert _chip_smoke().sass_counts(listing) == {
        "_Z3mmav": {"HGMMA": 0, "HMMA": 2, "LDG.E.128": 0, "LDG.E.EF.128": 0,
                    "REDUX": 0, "UCGABAR_ARV": 0},
        "_Z3ldgv": {"HGMMA": 1, "HMMA": 0, "LDG.E.128": 1, "LDG.E.EF.128": 1,
                    "REDUX": 1, "UCGABAR_ARV": 1}}


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,h", [(1, 12, 128), (4, 12, 128),
                                   (16, 12, 128), (6, 24, 64),
                                   (8, 12, 32), (3, 5, 1024),
                                   # B no multiple of the rows a cluster runs
                                   (5, 12, 128), (17, 12, 128),
                                   # one step: no exchange
                                   (4, 1, 128),
                                   # more clusters than one wave of the SMs
                                   (256, 12, 128),
                                   # the cluster instance's widest h, the
                                   # first general one, and an h that
                                   # divides neither 16 lanes nor S
                                   (3, 7, gru_cell.CLUSTER_MAX_HIDDEN),
                                   (3, 7, gru_cell.CLUSTER_MAX_HIDDEN + 1),
                                   (7, 9, 100)])
def test_gru_seq_kernel_matches_plain(cuda_device, B, T, h):
    xw, h0, wh = (torch.from_numpy(a).to(cuda_device)
                  for a in _gru_inputs(B, T, h))
    before = gru_cell.gru_seq.launches
    out = gru_cell.gru_seq(xw, h0, wh)
    torch.cuda.synchronize()
    assert gru_cell.gru_seq.launches == before + 1
    want = ref.gru_seq_ref(xw, h0, wh)
    assert_allclose(out.cpu().numpy(), want.cpu().numpy(), **GRU_TOL)


def _offset_view(x, offset):
    """x (C, N) copied into storage that starts ``offset`` elements in: a
    contiguous view whose rows lie off any 16-byte boundary."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("C,N,dtype", [
    (2, 792_797_824, torch.bfloat16), (2, 792_797_824, torch.float32),
    (32, 4096, torch.float32), (32, 4096, torch.bfloat16),
    (2, 1_048_584, torch.bfloat16), (37, 4104, torch.float32)])
def test_fedavg_reduce_instance_vector(C, N, dtype):
    assert fr_mod.instance(C, N, dtype, 1 << 20, 2 << 20) == "vector"


@pytest.mark.parametrize("C,N,dtype", [
    (20, 148_737, torch.float32), (20, 148_737, torch.bfloat16),
    (5, 148_737, torch.float32), (4, 513, torch.float32),
    (4, 513, torch.bfloat16), (3, 1_048_580, torch.bfloat16)])
def test_fedavg_reduce_instance_scalar(C, N, dtype):
    assert fr_mod.instance(C, N, dtype, 1 << 20, 2 << 20) == "scalar"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_reduce_instance_of_an_offset_view(dtype):
    x = torch.zeros((32, 4096), dtype=dtype)
    out = torch.empty(4096, dtype=dtype)
    aligned = _offset_view(x, 0)
    assert aligned.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert fr_mod.instance(32, 4096, dtype, aligned.data_ptr(),
                           out.data_ptr()) == "vector"
    view = _offset_view(x, 1)
    assert view.is_contiguous()
    assert fr_mod.instance(32, 4096, dtype, view.data_ptr(),
                           out.data_ptr()) == "scalar"
    assert fr_mod.instance(32, 4096, dtype, aligned.data_ptr(),
                           out.data_ptr() + view.element_size()) == "scalar"


@pytest.mark.parametrize("C", [0, fr_mod.MAX_REPLICAS + 1])
def test_fedavg_reduce_instance_rejects_replica_counts(C):
    with pytest.raises(ValueError, match="replica count"):
        fr_mod.instance(C, 4096, torch.float32, 0, 0)


def test_fedavg_reduce_instance_rejects_float16():
    with pytest.raises(TypeError):
        fr_mod.instance(2, 4096, torch.float16, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,offset", [
    (20, 148737, 0), (8, 148737, 0), (3, 148737, 0), (4, 513, 0),
    (32, 4096, 0),
    # vector instance, N no multiple of a block's tile (ragged tail)
    (2, 1_048_584, 0), (3, 1_048_580, 0),
    # one replica; a run-time count past the compile-time ones
    (1, 4100, 0), (37, 4104, 0),
    # rows off any 16-byte boundary: the scalar instance
    (32, 4096, 1),
    # the largest count the wrapper admits: its C * 4 bytes of weights
    # fill the 48 KB a block gets without an opt-in, so any other shared
    # memory refuses the launch
    (fr_mod.MAX_REPLICAS, 40, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_kernel_matches_plain(cuda_device, C, N, offset,
                                            dtype):
    x, w = _fedavg_inputs(C, N)
    xt = _offset_view(torch.from_numpy(x).to(cuda_device,
                                             getattr(torch, dtype)), offset)
    wt = torch.from_numpy(w).to(cuda_device)
    before = fr_mod.fedavg_reduce.launches
    out = fr_mod.fedavg_reduce(xt, wt)
    torch.cuda.synchronize()
    assert fr_mod.fedavg_reduce.launches == before + 1
    assert out.dtype == xt.dtype
    want = ref.fedavg_reduce_ref(xt, wt)
    assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                    **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("C,N", [(2, 1_048_584), (5, 8200), (37, 4104)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_instances_agree_bit_for_bit(cuda_device, C, N, dtype):
    """The same replicas through the vector instance and, one element
    into their storage, the scalar one give the same bits."""
    x, w = _fedavg_inputs(C, N)
    xt = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    wt = torch.from_numpy(w).to(cuda_device)
    view = _offset_view(xt, 1)
    out = torch.empty(N, dtype=xt.dtype, device=cuda_device)
    assert fr_mod.instance(C, N, xt.dtype, xt.data_ptr(),
                           out.data_ptr()) == "vector"
    assert fr_mod.instance(C, N, xt.dtype, view.data_ptr(),
                           out.data_ptr()) == "scalar"
    assert torch.equal(fr_mod.fedavg_reduce(xt, wt),
                       fr_mod.fedavg_reduce(view, wt))


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((3, 10), dtype=torch.float16, device=cuda_device)
    w = torch.ones(3, device=cuda_device)
    with pytest.raises(TypeError):
        fr_mod.fedavg_reduce(x, w)
    xw = torch.zeros((2, 4, 12), device=cuda_device).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gru_cell.gru_seq(xw, torch.zeros((4, 4), device=cuda_device),
                         torch.zeros((4, 12), device=cuda_device))
