"""Build and load the CUDA kernels at first use: the main library
(csrc/nice_kernels.cu: K1, K2 above b97, K4, K5) and one per-base library
for each base of at most four limbs (csrc/plan_kernels.cu: K2, K3 and K5's
detailed mode on the plan tier, with the base's plan as constants).

nvcc compiles the sources into a shared library with a plain C interface,
which ctypes loads; no PyTorch header is involved, so the build takes
seconds, not minutes. The main library lands in nice_tpu_torch/_build/<key>/,
where the key hashes the sources and the nvcc command, a per-base one in
_build/plan-<key>/, whose key also hashes the generated header nice_plan.h
(the plan words): an edited kernel, flag or plan rebuilds, an unchanged one
loads what is there. The build directory is not part of the repository;
deleting it clears every build.

nvcc is found on PATH, else under the toolkit's default install prefix
/usr/local/cuda.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
import time

from nice_tpu_torch.obs import stepprof
from nice_tpu_torch.utils import lockdep

log = logging.getLogger(__name__)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("nice_kernels.cu",)
HEADERS = ("nice_kernels.cuh", "nice_grid.cuh")
PLAN_SOURCES = ("plan_kernels.cu",)
PLAN_HEADER = "nice_plan.h"  # generated per base (cuda_engine.plan_header)
LIB_NAME = "libnice_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = lockdep.make_lock("ops.cuda_build._lock")
_lib = None
# Facts of the build that loaded the library: seconds spent in nvcc (0.0 on
# a cache hit), the key directory, and ptxas's per-kernel resource report.
BUILD_INFO: dict = {}
# A lock a generated header, so that one process runs one nvcc a base while
# other bases build beside it; and the facts of each per-base library this
# process loaded, as BUILD_INFO's, by header.
_plan_locks: dict = {}
PLAN_BUILDS: dict = {}


def find_nvcc() -> str:
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (put it on PATH); the CUDA kernels are built from "
        "source at first use"
    )


def _source_digest(names=SOURCES + HEADERS):
    h = hashlib.sha256()
    for name in names:
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


def plan_build_key(nvcc: str, header: str) -> str:
    """Key of a per-base build: the sources, the nvcc command and the
    generated header (so the plan words)."""
    h = _source_digest(PLAN_SOURCES + HEADERS)
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    h.update(b"\0" + header.encode())
    return h.hexdigest()[:16]


def nvcc_library(lib_path: str, sources, csrc: str | None = None,
                 include: tuple = ()) -> dict:
    """nvcc of `sources` (in csrc) into the shared library lib_path, through
    a temporary name so that a reader never loads half a file; nvcc's output
    (ptxas's report) into nvcc.log beside it. Returns {path, seconds,
    ptxas}. Raises if nvcc fails."""
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS,
           *(a for d in include for a in ("-I", d)), "-o", tmp,
           *(os.path.join(csrc or CSRC_DIR, s) for s in sources)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:  # nicelint: allow A1 (build log)
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    log.info("built %s in %.1fs", lib_path, seconds)
    # A build on a thread bound to a profiled field is that field's compile.
    stepprof.note_compile(seconds)
    return {"path": lib_path, "seconds": seconds,
            "ptxas": proc.stdout + proc.stderr}


# LOAD_NOTE: the libraries load as ctypes.PyDLL, whose calls keep the
# interpreter lock. A launch returns in microseconds; a ctypes.CDLL call
# releases the lock around it, which hands it to the pipelined loop's
# feed and collector threads at every launch (ops/engine.py), a thread
# wake-up each way per kernel.


def bind(lib) -> None:
    """Sets the argument and result types of the library's C functions
    (those it has: a build of an older tree may lack the newer ones)."""
    c_void_p, c_int, c_longlong = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    words = ctypes.POINTER(ctypes.c_uint64)
    signatures = {
        "nice_detailed_megaloop": [words, c_void_p, c_longlong, c_longlong,
                                   c_void_p, c_void_p, c_int, c_int,
                                   c_void_p],
        "nice_uniques": [words, c_void_p, c_longlong, c_void_p, c_void_p],
        # The main library's K3 before the plan tier took it (a parent
        # tree's, which scripts/kernel_ab.py loads).
        "nice_strided_niceonly": [words, c_void_p, c_longlong, c_void_p,
                                  c_longlong, c_longlong, c_longlong, c_int,
                                  c_void_p, c_void_p],
        # The per-base library (plan_kernels.cu).
        "nice_plan_uniques": [words, c_void_p, c_longlong, c_void_p,
                              c_void_p],
        "nice_plan_strided_niceonly": [words, c_void_p, c_longlong, c_void_p,
                                       c_longlong, ctypes.c_uint, c_int,
                                       c_int, c_longlong, c_longlong, c_int,
                                       c_void_p, c_int, c_void_p],
        "nice_plan_launch_shape": [c_int, words, c_longlong, c_longlong,
                                   c_int, ctypes.POINTER(c_int)],
        "nice_plan_detailed_megaloop_mma": [words, c_void_p, c_longlong,
                                            c_longlong, c_void_p, c_void_p,
                                            c_int, c_int, c_void_p],
        "nice_niceonly_dense": [words, c_void_p, c_void_p, c_longlong,
                                c_longlong, c_int, c_int, c_void_p, c_int,
                                c_void_p],
        "nice_launch_shape": [c_int, words, c_longlong, c_longlong, c_int,
                              c_int, ctypes.POINTER(c_int)],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = c_int
    lib.nice_error_string.argtypes = [c_int]
    lib.nice_error_string.restype = ctypes.c_char_p


def ptxas_resources(log: str) -> list:
    """ptxas's report (-Xptxas -v) per kernel entry: its mangled name,
    bytes of stack frame, of spill stores and loads, and registers."""
    out: list = []
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and "_kernel" in name:
            out.append({"mangled": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["mangled"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def sass_listing(path: str) -> dict:
    """Per function of a compiled file (cubin or shared library), from
    cuobjdump -sass: its instructions as (address, opcode without
    modifiers, text), padding NOPs left out."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    funcs: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if not (m and name):
            continue
        toks = m.group(2).split()
        op = (toks[1] if toks[0].startswith("@") else toks[0]).split(".")[0]
        if op != "NOP":
            funcs[name].append((int(m.group(1), 16), op, m.group(2)))
    return funcs


def load():
    """The loaded kernel library, built first if this key has no library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = os.path.join(BUILD_DIR, build_key(find_nvcc()), LIB_NAME)
        info = _built(lib_path, SOURCES)
        lib = ctypes.PyDLL(lib_path)  # calls keep the GIL (LOAD_NOTE)
        bind(lib)
        BUILD_INFO.update(info)
        _lib = lib
        return lib


def _built(lib_path: str, sources, include: tuple = ()) -> dict:
    """nvcc_library's facts: of this build, or of the one already at
    lib_path (its nvcc.log, 0.0 seconds)."""
    if not os.path.isfile(lib_path):
        return nvcc_library(lib_path, sources, include=include)
    log_path = os.path.join(os.path.dirname(lib_path), "nvcc.log")
    ptxas = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            ptxas = f.read()
    return {"path": lib_path, "seconds": 0.0, "ptxas": ptxas}


def build_plan(header: str) -> dict:
    """The per-base library of one generated header (nice_plan.h), built
    into _build/plan-<key>/ unless it is there; returns its facts (as
    nvcc_library's). The header is written only for a build, through a
    temporary name, so that another process's nvcc never reads half of it.
    Takes no lock: builds of several bases may run at once (chip_smoke.py's
    build phase starts them together)."""
    key = plan_build_key(find_nvcc(), header)
    key_dir = os.path.join(BUILD_DIR, f"plan-{key}")
    lib_path = os.path.join(key_dir, LIB_NAME)
    if not os.path.isfile(lib_path):
        os.makedirs(key_dir, exist_ok=True)
        path = os.path.join(key_dir, PLAN_HEADER)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        # nicelint: allow A1 (a build input under a temporary name, renamed)
        with open(tmp, "w") as f:
            f.write(header)
        os.replace(tmp, path)
    return _built(lib_path, PLAN_SOURCES, (key_dir,))


def load_plan(header: str):
    """The per-base library of one generated header, loaded, and built
    first if its key has no library (cuda_engine.plan_library keeps it per
    plan). Raises if the build fails: nothing else runs the plan tier's
    plans."""
    with _lock:
        # One label for every header's lock: load_plan never holds two.
        lock = _plan_locks.setdefault(
            header, lockdep.make_lock("ops.cuda_build._plan_locks"))
    with lock:
        info = build_plan(header)
        lib = ctypes.PyDLL(info["path"])  # calls keep the GIL (LOAD_NOTE)
        bind(lib)
        PLAN_BUILDS[header] = info
        return lib
