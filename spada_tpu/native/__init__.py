"""Native (C++) host-side components, loaded via ctypes.

Built with g++ into ``_build/`` on first use, keyed on a hash of
``spada_native.cpp``: a library built from other source is never loaded,
and one that fails to load is rebuilt once.  Every caller has a pure NumPy
fallback; when the library is unavailable the reason goes to stderr once.
See ``spada_native.cpp`` for what is implemented natively and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "spada_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libspada_native-{digest}.so")


def _build(so: str) -> Optional[str]:
    """Compile into ``so``; returns an error message or None."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except FileNotFoundError:
        return "g++ not found"
    except subprocess.CalledProcessError as e:
        return f"g++ failed: {e.stderr.decode(errors='replace')[-300:]}"
    except subprocess.TimeoutExpired:
        return "g++ timed out"
    os.replace(tmp, so)
    return None


def _open(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    lib.mtx_parse_body.restype = ctypes.c_int64
    lib.mtx_parse_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.esc_plan.restype = ctypes.c_int
    lib.esc_plan.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.traffic_simulate.restype = ctypes.c_int
    lib.traffic_simulate.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        so = _so_path()
        err = None if os.path.exists(so) else _build(so)
        if err is None:
            try:
                _lib = _open(so)
            except (OSError, AttributeError):
                # stale or foreign binary under this hash: rebuild once
                err = _build(so)
                if err is None:
                    try:
                        _lib = _open(so)
                    except (OSError, AttributeError) as e:
                        err = f"cannot load {so}: {e}"
        if _lib is None:
            _failed = err
            print(f"spada_tpu.native: {err}; using the NumPy fallbacks",
                  file=sys.stderr)
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mtx_parse_body(body: bytes, nnz: int, pattern: bool):
    """Native coordinate-body parse; returns (rows, cols, vals) or None."""
    lib = load()
    if lib is None:
        return None
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    n = lib.mtx_parse_body(
        body, len(body), nnz, int(pattern),
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(vals, ctypes.c_double),
    )
    if n != nnz:
        return None
    return rows, cols, vals


def traffic_simulate(a_indptr, a_indices, b_row_lens, row_order,
                     capacity_words: int, row_psum_nnz):
    """Native fiber-cache walk.

    Returns (counters[15], row_traffic_words, row_fills) or None — the
    per-row arrays are the full-K window task components for the latency
    accumulation (models/traffic.py windowed_cycles).
    """
    lib = load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    a_indices = np.ascontiguousarray(a_indices, dtype=np.int32)
    b_row_lens = np.ascontiguousarray(b_row_lens, dtype=np.int64)
    row_order = np.ascontiguousarray(row_order, dtype=np.int64)
    row_psum_nnz = np.ascontiguousarray(row_psum_nnz, dtype=np.int64)
    out = np.zeros(15, dtype=np.int64)
    n_rows = len(a_indptr) - 1
    row_traffic = np.zeros(n_rows, dtype=np.int64)
    row_fills = np.zeros(n_rows, dtype=np.int64)
    rc = lib.traffic_simulate(
        _ptr(a_indptr, ctypes.c_int64), _ptr(a_indices, ctypes.c_int32),
        n_rows, _ptr(b_row_lens, ctypes.c_int64), len(b_row_lens),
        _ptr(row_order, ctypes.c_int64), capacity_words,
        _ptr(row_psum_nnz, ctypes.c_int64), _ptr(out, ctypes.c_int64),
        _ptr(row_traffic, ctypes.c_int64), _ptr(row_fills, ctypes.c_int64),
    )
    return (out, row_traffic, row_fills) if rc == 0 else None


def esc_plan(a_indptr, a_indices, b_indptr, b_indices, b_rows: int,
             cap: int, e_products: int):
    """Native ESC symbolic phase (ops/element.py).

    Returns (counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr,
    ag, bg) with worst-case-sized arrays (caller trims via counts), or None
    if the native library is unavailable or the planner failed.
    """
    lib = load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    a_indices = np.ascontiguousarray(a_indices, dtype=np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, dtype=np.int64)
    b_indices = np.ascontiguousarray(b_indices, dtype=np.int32)
    m = len(a_indptr) - 1
    E = int(e_products)
    counts = np.zeros(6, dtype=np.int64)
    c_indices = np.empty(max(E, 1), dtype=np.int32)
    c_row_counts = np.empty(max(m, 1), dtype=np.int32)
    class_L = np.zeros(32, dtype=np.int32)
    class_n = np.zeros(32, dtype=np.int64)
    esc_to_csr = np.empty(E + E // max(cap, 1) + 2, dtype=np.int32)
    ag = np.empty(2 * E + 64, dtype=np.int32)
    bg = np.empty(2 * E + 64, dtype=np.int32)
    rc = lib.esc_plan(
        _ptr(a_indptr, ctypes.c_int64), _ptr(a_indices, ctypes.c_int32), m,
        _ptr(b_indptr, ctypes.c_int64), _ptr(b_indices, ctypes.c_int32),
        b_rows, cap,
        _ptr(counts, ctypes.c_int64), _ptr(c_indices, ctypes.c_int32),
        _ptr(c_row_counts, ctypes.c_int32), _ptr(class_L, ctypes.c_int32),
        _ptr(class_n, ctypes.c_int64), _ptr(esc_to_csr, ctypes.c_int32),
        _ptr(ag, ctypes.c_int32), _ptr(bg, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr, ag, bg
