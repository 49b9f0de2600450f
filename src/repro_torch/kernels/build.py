"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers they include) is
compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with
``ctypes``.  The library goes to ``kernels/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a second
load in the same checkout reuses it.  Nothing is built at import time,
a missing ``nvcc`` or a failed build raises, and there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C signature of every kernel entry point: (argtypes); all return int
SIGNATURES = {
    "gru_seq_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "gru_seq_cluster_f32": (_P, _P, _P, _P) + (_I,) * 5 + (_P,),
    "gru_seq_floor": (_P,) + (_I,) * 5 + (_P,),
    **{f"fedavg_reduce_{i}_{t}": (_P, _P, _P, _I, _L, _I, _P)
       for i in ("vector", "scalar") for t in ("f32", "bf16")},
    "fedavg_reduce_blocks": (_I, _I, _I, _L, _I),
    "fedavg_reduce_floor": (_I, _I, _I, _L, _I, _P),
    "flash_attention_f32": (_P,) * 4 + (_I,) * 8 + (_P,),
    # bf16: a scratch pointer after out, then S (chunks a block's walk
    # over the keys is split into) after the shapes
    "flash_attention_bf16": (_P,) * 5 + (_I,) * 9 + (_P,),
    # the GQA decode kernels: a scratch pointer, then S (chunks a row's
    # walk is split into) after the shapes
    **{f"decode_attention_{t}": (_P,) * 6 + (_I,) * 7 + (_F, _P)
       for t in ("f32", "bf16")},
    **{f"decode_attention_partial_{t}": (_P,) * 8 + (_I,) * 7 + (_F, _P)
       for t in ("f32", "bf16")},
    **{f"paged_decode_attention_{t}": (_P,) * 7 + (_I,) * 8 + (_F, _I, _P)
       for t in ("f32", "bf16")},
    **{f"paged_mla_decode_attention_{t}": (_P,) * 7 + (_I,) * 6 + (_F, _P)
       for t in ("f32", "bf16")},
    "topk_router_f32": (_P, _P, _P, _I, _I, _I, _P),
    "topk_router_floor": (_I, _P),
    **{f"mamba_chunk_scan_{t}": (_P,) * 8 + (_I,) * 6 + (_P,)
       for t in ("f32", "bf16")},
}

_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME); "
                       "the port's kernels cannot be built")


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its
    path.  The compiler's report (registers, shared memory, spills per
    kernel) is kept beside it in ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_log() -> str:
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


def launch(name: str, *args) -> None:
    """Call kernel entry point ``name``; raise if CUDA refused the launch
    (too many threads, too much shared memory, a bad argument), which a
    later synchronise would not report."""
    rc = getattr(load(), name)(*args)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
