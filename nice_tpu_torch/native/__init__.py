"""ctypes bindings of the port's host library (nice_native.cpp): the MSD
prefix filter, the CRT stride iteration (generic loop, and the
polynomial-residue kernel of k >= 3 tables), the detailed range loop and the
fast-path test hook (the port's counterpart of nice_tpu/native/__init__.py,
cut to those entry points).

g++ builds the library at first use into nice_tpu_torch/_build/native-<key>/,
where the key hashes the source and the command, so an edited source
rebuilds. A failed build raises: the niceonly path has no Python fallback.

Every entry is pure; the library loads as ctypes.CDLL, which releases the
GIL for each call, so the engine's filter threads, its collector and the
native backend's thread pool run them in parallel. Where the JAX bindings
return None (no library, a base or value the C++ does not take), these
raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from nice_tpu_torch.utils import lockdep

log = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nice_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build")
LIB_NAME = "libnice_native.so"
# No -march=native: the build directory may travel with a copy of the tree
# to another machine, whose CPU must run the library all the same.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_U64 = ctypes.c_uint64
_MASK64 = (1 << 64) - 1

_lock = lockdep.make_lock("native._lock")
_lib = None
# Whether this thread's last iterate_range_strided call ran the
# polynomial-residue kernel (used_poly() reads it; tests assert on it).
_POLY_USED = threading.local()
# Facts of the build that loaded the library: g++ seconds (0.0 when the
# library was already built) and its path.
BUILD_INFO: dict = {}


def _build_key(cxx: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def load():
    """The loaded library, built first if this key has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH; the host library is "
                               "built from source at first use")
        key_dir = os.path.join(BUILD_DIR, "native-" + _build_key(cxx))
        lib_path = os.path.join(key_dir, LIB_NAME)
        seconds = 0.0
        if not os.path.isfile(lib_path):
            os.makedirs(key_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            t0 = time.monotonic()
            proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
            seconds = time.monotonic() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)
            log.info("built %s in %.1fs", lib_path, seconds)
        lib = ctypes.CDLL(lib_path)
        lib.nice_process_range_detailed.restype = None
        lib.nice_process_range_detailed.argtypes = [
            _U64, _U64, _U64, _U64, _U64,
            ctypes.POINTER(_U64), ctypes.POINTER(_U64), _U64,
            ctypes.POINTER(_U64),
        ]
        lib.nice_iterate_range_strided_poly.restype = None
        lib.nice_iterate_range_strided_poly.argtypes = [
            _U64, _U64, _U64, _U64, _U64, _U64, _U64,
            ctypes.POINTER(ctypes.c_uint32), _U64, ctypes.POINTER(_U64), _U64,
            ctypes.POINTER(_U64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.nice_strided_fast_enabled.restype = ctypes.c_int
        lib.nice_strided_fast_enabled.argtypes = [ctypes.c_int]
        lib.nice_iterate_range_strided.restype = None
        lib.nice_iterate_range_strided.argtypes = [
            _U64, _U64, _U64, _U64, _U64, _U64,
            ctypes.POINTER(_U64), _U64, ctypes.POINTER(_U64), _U64,
            ctypes.POINTER(_U64),
        ]
        lib.nice_msd_valid_ranges.restype = ctypes.c_void_p
        lib.nice_msd_valid_ranges.argtypes = [
            _U64, _U64, _U64, _U64, _U64, ctypes.c_int, _U64, ctypes.c_int,
        ]
        lib.nice_ranges_count.restype = _U64
        lib.nice_ranges_count.argtypes = [ctypes.c_void_p]
        lib.nice_ranges_copy.restype = None
        lib.nice_ranges_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(_U64)]
        lib.nice_ranges_free.restype = None
        lib.nice_ranges_free.argtypes = [ctypes.c_void_p]
        BUILD_INFO.update(path=lib_path, seconds=seconds)
        _lib = lib
        return lib


def supports(base: int, end: int) -> bool:
    """Inputs the C++ arithmetic takes: digit indicators are u128 bitmasks
    (base <= 128), digit buffers are sized for base >= 4, and values are two
    u64 limbs (end < 2^128)."""
    return 4 <= base <= 128 and 0 <= end < 1 << 128


def _check(base: int, end: int) -> None:
    if not supports(base, end):
        raise ValueError(f"the host library takes 4 <= base <= 128 and values "
                         f"below 2^128, got base {base}, end {end}")


def _split(n: int) -> tuple[int, int]:
    return n & _MASK64, n >> 64


def process_range_detailed(start: int, count: int, base: int, cutoff: int
                           ) -> tuple[list[int], list[tuple[int, int]]]:
    """(histogram list[base + 2], [(n, num_uniques), ...] of the near misses,
    num_uniques > cutoff) of [start, start + count)."""
    _check(base, start + count)
    lib = load()
    lo, hi = _split(start)
    hist = (_U64 * (base + 2))()
    cap = 4096
    while True:
        misses = (_U64 * (3 * cap))()
        miss_count = _U64(0)
        for i in range(base + 2):
            hist[i] = 0
        lib.nice_process_range_detailed(
            lo, hi, count, base, cutoff, hist, misses, cap,
            ctypes.byref(miss_count),
        )
        if miss_count.value <= cap:
            break
        cap = int(miss_count.value)
    out_misses = [
        (misses[i * 3] | (misses[i * 3 + 1] << 64), int(misses[i * 3 + 2]))
        for i in range(int(miss_count.value))
    ]
    return list(hist), out_misses


def strided_fast_enabled(enable: bool) -> bool:
    """Test hook: turn the fast strided paths (the polynomial-residue kernel
    and the magic-divide loop) on or off for the process; returns the
    previous setting."""
    return bool(load().nice_strided_fast_enabled(1 if enable else 0))


def iterate_range_strided(first: int, start_idx: int, end: int, base: int,
                          gap_array: np.ndarray, modulus: int | None = None,
                          residues: np.ndarray | None = None) -> list[int]:
    """Nice numbers among stride candidates in [first, end), starting from
    candidate `first` at residue index start_idx and stepping through
    gap_array (a StrideTable's u64 gap twin).

    Given the table's modulus and residues_u32 as well, the call tries the
    polynomial-residue kernel first; where that kernel does not take the
    table or the range (used_poly() is then False), the generic loop
    runs."""
    _check(base, end)
    if not (isinstance(gap_array, np.ndarray) and gap_array.dtype == np.uint64
            and gap_array.ndim == 1 and gap_array.flags.c_contiguous
            and 0 <= start_idx < len(gap_array)):
        raise ValueError("gap_array must be a contiguous 1-D uint64 array "
                         "indexed by start_idx")
    lib = load()
    flo, fhi = _split(first)
    elo, ehi = _split(end)
    cap = 1024
    if modulus is not None and residues is not None:
        if not (isinstance(residues, np.ndarray)
                and residues.dtype == np.uint32 and residues.ndim == 1
                and residues.flags.c_contiguous):
            raise ValueError("residues must be a contiguous 1-D uint32 array")
        res_ptr = residues.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        while True:
            out = (_U64 * (2 * cap))()
            count = _U64(0)
            used = ctypes.c_int(0)
            lib.nice_iterate_range_strided_poly(
                flo, fhi, start_idx, elo, ehi, base, modulus, res_ptr,
                len(residues), out, cap, ctypes.byref(count),
                ctypes.byref(used),
            )
            _POLY_USED.used = used.value
            if not used.value:
                break  # not eligible: the generic loop below
            if count.value <= cap:
                return [out[i * 2] | (out[i * 2 + 1] << 64)
                        for i in range(int(count.value))]
            cap = int(count.value)
    else:
        _POLY_USED.used = 0
    gaps = gap_array.ctypes.data_as(ctypes.POINTER(_U64))
    while True:
        out = (_U64 * (2 * cap))()
        count = _U64(0)
        lib.nice_iterate_range_strided(
            flo, fhi, start_idx, elo, ehi, base, gaps, len(gap_array), out,
            cap, ctypes.byref(count),
        )
        if count.value <= cap:
            break
        cap = int(count.value)
    return [out[i * 2] | (out[i * 2 + 1] << 64) for i in range(int(count.value))]


def used_poly() -> bool:
    """True when this thread's last iterate_range_strided call ran the
    polynomial-residue kernel, False when it ran the generic loop."""
    return bool(getattr(_POLY_USED, "used", 0))


def msd_valid_ranges(start: int, end: int, base: int, max_depth: int,
                     min_range_size: int, subdivision_factor: int
                     ) -> list[tuple[int, int]]:
    """[(sub_start, sub_end), ...] surviving the recursive MSD filter, in
    ascending order."""
    _check(base, end)
    lib = load()
    slo, shi = _split(start)
    elo, ehi = _split(end)
    handle = lib.nice_msd_valid_ranges(
        slo, shi, elo, ehi, base, max_depth, min_range_size, subdivision_factor
    )
    try:
        n = int(lib.nice_ranges_count(handle))
        buf = (_U64 * (4 * n))()
        if n:
            lib.nice_ranges_copy(handle, buf)
        return [
            (
                buf[i * 4] | (buf[i * 4 + 1] << 64),
                buf[i * 4 + 2] | (buf[i * 4 + 3] << 64),
            )
            for i in range(n)
        ]
    finally:
        lib.nice_ranges_free(handle)
