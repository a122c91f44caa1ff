"""Build and load the CUDA kernels: ``nvcc`` into one shared library.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so each compiles in seconds.  At first use every source
is compiled by its own ``nvcc`` process, all started together, for
``sm_90a``; the objects are linked into one ``.so`` that is loaded with
``ctypes``.  The library lands in ``build/repro_torch_kernels/<hash>/``
under the checkout, keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  A failed
build raises; nothing falls back.  ``nvcc`` is taken from
``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then the ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).with_name("csrc")
SOURCES = ("gf_matmul.cu", "gear_cdc.cu", "sha1.cu", "fused_ingest.cu",
           "flash_attn.cu")
# included by the sources; hashed with them
HEADERS = ("sha1_ring.cuh", "gf_bitplane.cuh", "sm90.cuh")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsears_kernels.so"
LOG_NAME = "build.log"  # the compilers' output, beside the library

# What the last build did: seconds and the compilers' output (ptxas -v
# prints each kernel's registers, spills and shared memory there).  A
# library loaded from an earlier build reads that build's log.
BUILD_INFO: dict = {"seconds": 0.0, "built": False, "log": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (host constants, device constants, data, out, B, r, k, L, stream)
    "sears_gf_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sears_gear": [_P, _P, ctypes.c_uint32, _P, ctypes.c_longlong, _I, _P],
    "sears_sha1": [_P, _P, _P, _I, _I, _P],
    # (host constants, device constants, data, nbytes, piece_lens, words,
    #  enc, B, r, k, Lp, stream)
    "sears_fused_ingest": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (q, k, v, out, B, S, T, H, KV, hd, strides, scale, causal, window,
    #  stream): fp32 on the CUDA cores, bf16 on the tensor cores
    "sears_flash_attn_fp32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              ctypes.c_float, _I, _I, _P],
    "sears_flash_attn_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              ctypes.c_float, _I, _I, _P],
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def source_digest() -> str:
    """Hash of every source and flag the library is built from."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with their output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if p.returncode != 0:
            failed.append(logs[-1])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build(out_dir: pathlib.Path) -> pathlib.Path:
    """Compile every source (in parallel) and link them into one library."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(pathlib.Path(tmp) / (pathlib.Path(s).stem + ".o"))
                for s in SOURCES]
        logs = _run_all([[nvcc, *ARCH, *FLAGS, "-c", str(CSRC / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        lib_tmp = str(pathlib.Path(tmp) / LIB_NAME)
        logs += _run_all([[nvcc, *ARCH, "-shared", "-o", lib_tmp, *objs]])
        (out_dir / LOG_NAME).write_text("\n".join(logs))
        os.replace(lib_tmp, out_dir / LIB_NAME)  # atomic: racing builds agree
    # searslint: ignore[begin-purity] -- build-once diagnostics, read by no plan
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=True,
                      log="\n".join(logs))
    return out_dir / LIB_NAME


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources at first use."""
    path = BUILD_ROOT / source_digest() / LIB_NAME
    if not path.exists():
        build(path.parent)
    elif (path.parent / LOG_NAME).exists():
        # searslint: ignore[begin-purity] -- load-once diagnostics, read by no plan
        BUILD_INFO["log"] = (path.parent / LOG_NAME).read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sears_error_string.argtypes = [ctypes.c_int]
    lib.sears_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().sears_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
