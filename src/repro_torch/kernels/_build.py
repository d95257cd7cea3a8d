"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

The sources have a plain C interface: each ``.cu`` is compiled to an object
(all ``nvcc`` processes started together), the objects are linked into one
shared library, and the library is loaded with ``ctypes``.  The library is
built at first use into ``build/repro_torch/`` at the repository root and is
named by a hash of the sources and flags, so a source change rebuilds.
There is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_log: str = ""      # nvcc's output (ptxas register / shared-memory report)
build_seconds: float = 0.0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA toolkit is "
        "needed to build repro_torch's kernels")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[pathlib.Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> list[str]:
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{out}")
    return logs


def build() -> pathlib.Path:
    """Compile and link the kernels if the library for these sources is
    missing; return its path."""
    global build_log, build_seconds
    sources = _sources()
    lib_path = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in sources]
        compiles = []
        for src, obj in zip(sources, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = _run(compiles)
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        logs += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp_lib, lib_path)  # atomic: a half-written library is never loaded
    build_seconds = time.time() - t0
    build_log = "".join(logs)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 5 + [i32] * 7 + [i64] * 12 + [i32] * 3
        + [ctypes.c_float, ctypes.c_float, ptr])
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_bwd.argtypes = (
        [ptr] * 10 + [i32] * 7 + [i32] * 3 + [ctypes.c_float, ctypes.c_float, ptr])
    lib.flash_attention_bwd.restype = i32
    for fn in (lib.wkv6_fwd, lib.wkv6_chunked_fwd):
        fn.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 12 + [ptr]
        fn.restype = i32
    lib.wkv6_bwd.argtypes = [ptr] * 16 + [i32] * 5 + [ptr]
    lib.wkv6_bwd.restype = i32
    lib.rglru_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [i64] * 4 + [ptr]
    lib.rglru_fwd.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
