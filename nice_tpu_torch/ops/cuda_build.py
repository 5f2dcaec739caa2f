"""Build and load the CUDA kernels (csrc/nice_kernels.cu: K1-K5) at first
use.

nvcc compiles the sources into a shared library with a plain C interface,
which ctypes loads; no PyTorch header is involved, so the build takes
seconds, not minutes. The library lands in nice_tpu_torch/_build/<key>/,
where the key hashes the sources and the nvcc command: an edited kernel or
flag rebuilds, an unchanged one loads what is there. The build directory is
not part of the repository.

nvcc is found on PATH, else under the toolkit's default install prefix
/usr/local/cuda.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time

log = logging.getLogger(__name__)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("nice_kernels.cu",)
HEADERS = ("nice_kernels.cuh",)
LIB_NAME = "libnice_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# Facts of the build that loaded the library: seconds spent in nvcc (0.0 on
# a cache hit), the key directory, and ptxas's per-kernel resource report.
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (put it on PATH); the CUDA kernels are built from "
        "source at first use"
    )


def _source_digest():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h


@functools.lru_cache(maxsize=None)
def source_hash() -> str:
    """Hash of the kernel sources alone (no nvcc needed): what the tuning
    table's signature stamps, so that an edited kernel re-tunes."""
    return _source_digest().hexdigest()[:16]


def build_key(nvcc: str) -> str:
    h = _source_digest()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(lib) -> None:
    c_void_p, c_int, c_longlong = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    words = ctypes.POINTER(ctypes.c_uint64)
    lib.nice_detailed_megaloop.argtypes = [
        words, c_void_p, c_longlong, c_longlong, c_void_p, c_void_p, c_int,
        c_void_p,
    ]
    lib.nice_detailed_megaloop.restype = c_int
    lib.nice_uniques.argtypes = [words, c_void_p, c_longlong, c_void_p, c_void_p]
    lib.nice_uniques.restype = c_int
    lib.nice_strided_niceonly.argtypes = [
        words, c_void_p, c_longlong, c_void_p, c_longlong, c_longlong,
        c_longlong, c_int, c_void_p, c_void_p,
    ]
    lib.nice_strided_niceonly.restype = c_int
    lib.nice_niceonly_dense.argtypes = [
        words, c_void_p, c_void_p, c_longlong, c_longlong, c_int, c_int,
        c_void_p, c_void_p,
    ]
    lib.nice_niceonly_dense.restype = c_int
    lib.nice_error_string.argtypes = [c_int]
    lib.nice_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, built first if this key has no library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = find_nvcc()
        key_dir = os.path.join(BUILD_DIR, build_key(nvcc))
        lib_path = os.path.join(key_dir, LIB_NAME)
        log_path = os.path.join(key_dir, "nvcc.log")
        seconds = 0.0
        if not os.path.isfile(lib_path):
            os.makedirs(key_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.monotonic() - t0
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, lib_path)
            log.info("built %s in %.1fs", lib_path, seconds)
        lib = ctypes.CDLL(lib_path)
        _bind(lib)
        ptxas = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                ptxas = f.read()
        BUILD_INFO.update(path=lib_path, seconds=seconds, ptxas=ptxas)
        _lib = lib
        return lib
