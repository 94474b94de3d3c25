"""ctypes binding to the native correctness oracle, ``native/liboracle.so``.

The port's own binding to the library the JAX package's ``tpujoin.oracle``
binds (importing that module imports jax). The library is built with
``make -C native`` at first use. A join result passes when its
(rowID_R, rowID_S) pairs equal the recomputed join as a multiset.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_PATH = NATIVE_DIR / "liboracle.so"
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if not LIB_PATH.exists():
            proc = subprocess.run(["make", "-C", str(NATIVE_DIR)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"make -C {NATIVE_DIR} failed:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(str(LIB_PATH))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.oracle_join_count.restype = ctypes.c_int64
        lib.oracle_join_count.argtypes = [i32p, ctypes.c_int64, i32p,
                                          ctypes.c_int64, ctypes.c_int]
        lib.oracle_check.restype = ctypes.c_int
        lib.oracle_check.argtypes = [i32p, ctypes.c_int64, i32p,
                                     ctypes.c_int64, i32p, i32p,
                                     ctypes.c_int64, ctypes.c_int]
        lib.oracle_group_count.restype = ctypes.c_int64
        lib.oracle_group_count.argtypes = [i32p, ctypes.c_int64, i32p, i32p,
                                           ctypes.c_int64]
        lib.oracle_check_rle.restype = ctypes.c_int
        lib.oracle_check_rle.argtypes = [i32p, ctypes.c_int64, i32p,
                                         ctypes.c_int64, i32p, i32p, i32p,
                                         i32p, ctypes.c_int64]
        _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    if hasattr(a, "detach"):   # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def join_count(r_keys, s_keys, *, nested: bool = False) -> int:
    """Exact |R join S|, recomputed natively (sort-based unless nested)."""
    r, s = _i32(r_keys), _i32(s_keys)
    return int(_load().oracle_join_count(_ptr(r), len(r), _ptr(s), len(s),
                                         int(nested)))


def check_join(r_keys, s_keys, res_r, res_s, *, nested: bool = False) -> int:
    """1 = exact multiset match, 0 = mismatch, -1 = size mismatch."""
    r, s = _i32(r_keys), _i32(s_keys)
    rr, rs = _i32(res_r), _i32(res_s)
    if len(rr) != len(rs):
        raise ValueError("check_join: result columns differ in length")
    return int(_load().oracle_check(_ptr(r), len(r), _ptr(s), len(s),
                                    _ptr(rr), _ptr(rs), len(rr),
                                    int(nested)))


def check_join_rle(r_keys, s_keys, sorted_build_ids, probe_ids, lo,
                   cnt) -> int:
    """Check a factorized (RLE) join result: for each row r, the build-id
    run sorted_build_ids[lo[r]:lo[r] + cnt[r]] must be probe row
    probe_ids[r]'s exact match multiset, and unlisted probe rows must have
    no match. 1 = ok, 0 = mismatch, -1 = size mismatch."""
    r, s, sbi = _i32(r_keys), _i32(s_keys), _i32(sorted_build_ids)
    pid, lo_a, cnt_a = _i32(probe_ids), _i32(lo), _i32(cnt)
    if not len(pid) == len(lo_a) == len(cnt_a):
        raise ValueError("check_join_rle: RLE columns differ in length")
    return int(_load().oracle_check_rle(_ptr(r), len(r), _ptr(s), len(s),
                                        _ptr(sbi), _ptr(pid), _ptr(lo_a),
                                        _ptr(cnt_a), len(pid)))


def group_by_count(keys):
    """(unique_keys, counts) as int32 numpy arrays, keys ascending: the
    aggregate oracle."""
    k = _i32(keys)
    ko = np.empty(len(k), np.int32)
    co = np.empty(len(k), np.int32)
    n = int(_load().oracle_group_count(_ptr(k), len(k), _ptr(ko), _ptr(co),
                                       len(k)))
    return ko[:n], co[:n]
