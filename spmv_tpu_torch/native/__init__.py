"""Native (C++) host packers, loaded via ctypes.

``spmv_native.cpp`` beside this file is the port's own copy of the JAX
package's packer source; its code is unchanged, so both packages emit
identical packs (``tests/test_torch_formats.py`` pins them).  It is
compiled with g++ into the port's build directory at first use.  Bound are
the MatrixMarket parser (``parse_mtx``, for ``io/mmio.py``) and the entry
points the port's packers call: the SELL-8W greedy packer, the COO2
packers (the fused pipeline and the pass-1 placer), the SELL-8D slot-mode
packer and its bundle-width stats.

Everything degrades gracefully, as in the JAX package: if compilation
fails, the parser and the packers fall back to their pure-numpy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .._build import compile_shared

__all__ = ["load_native", "native_available", "parse_mtx",
           "pack_sell8w_native",
           "coo2_place_native", "coo2_pack_all_native", "pack_sell8d_native",
           "sell8d_stats_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "spmv_native.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = compile_shared(
                "spmv_native", [_SRC],
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", "-pthread"], timeout=120)
            lib = ctypes.CDLL(so)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        c = ctypes
        lib.mtx_parse.restype = c.c_void_p
        lib.mtx_parse.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
        lib.mtx_m.restype = c.c_int64
        lib.mtx_m.argtypes = [c.c_void_p]
        lib.mtx_n.restype = c.c_int64
        lib.mtx_n.argtypes = [c.c_void_p]
        lib.mtx_nnz.restype = c.c_int64
        lib.mtx_nnz.argtypes = [c.c_void_p]
        lib.mtx_copy.restype = None
        lib.mtx_copy.argtypes = [c.c_void_p] + [np.ctypeslib.ndpointer(d)
                                                for d in (np.int32, np.int32,
                                                          np.float64)]
        lib.mtx_free.restype = None
        lib.mtx_free.argtypes = [c.c_void_p]
        lib.sell8w_pack.restype = c.c_void_p
        lib.sell8w_pack.argtypes = [
            c.c_int64, c.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            c.POINTER(c.c_int64)]
        lib.sell8w_copy.restype = None
        lib.sell8w_copy.argtypes = [c.c_void_p] + [
            np.ctypeslib.ndpointer(d) for d in (np.int32, np.int32,
                                                np.int16, np.float32)]
        lib.sell8w_free.restype = None
        lib.sell8w_free.argtypes = [c.c_void_p]
        lib.coo2_place.restype = c.c_void_p
        lib.coo2_place.argtypes = [
            c.c_int64,
            np.ctypeslib.ndpointer(np.int16),
            np.ctypeslib.ndpointer(np.int16),
            np.ctypeslib.ndpointer(np.float32),
            c.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            c.POINTER(c.c_int64)]
        lib.coo2_copy.restype = None
        lib.coo2_copy.argtypes = [c.c_void_p] + [
            np.ctypeslib.ndpointer(d) for d in (np.int32, np.int16,
                                                np.float32, np.int64)]
        lib.coo2_free.restype = None
        lib.coo2_free.argtypes = [c.c_void_p]
        lib.coo2_pack_all.restype = c.c_void_p
        lib.coo2_pack_all.argtypes = [
            c.c_int64, c.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            c.c_int64, c.POINTER(c.c_int64)]
        lib.coo2_all_copy.restype = None
        lib.coo2_all_copy.argtypes = [c.c_void_p] + [
            np.ctypeslib.ndpointer(d) for d in (np.int32, np.int16,
                                                np.float32, np.int32,
                                                np.int32)]
        lib.coo2_all_free.restype = None
        lib.coo2_all_free.argtypes = [c.c_void_p]
        lib.sell8d_pack.restype = c.c_void_p
        lib.sell8d_pack.argtypes = [
            c.c_int64, c.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            c.c_int, c.c_int, c.c_int, c.c_double, c.c_double,
            c.c_double, c.c_double, c.c_int,
            c.POINTER(c.c_int64), c.POINTER(c.c_int64),
            c.POINTER(c.c_int64), c.POINTER(c.c_int)]
        lib.sell8d_copy.restype = None
        lib.sell8d_copy.argtypes = [c.c_void_p] + [
            np.ctypeslib.ndpointer(d) for d in (np.int32, np.int32,
                                                np.int16, np.int64,
                                                np.int64, np.int64)]
        lib.sell8d_free.restype = None
        lib.sell8d_free.argtypes = [c.c_void_p]
        lib.sell8d_stats.restype = None
        lib.sell8d_stats.argtypes = [
            c.c_int64, c.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64), c.c_double, c.c_double,
            c.c_double,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def parse_mtx(path: str):
    """(m, n, rows, cols, vals) COO of a coordinate MatrixMarket file with
    its symmetry expanded, or None (no native library, a missing or
    unreadable file, or a file the parser does not take: array format)."""
    lib = load_native()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    h = lib.mtx_parse(os.fsencode(path), ctypes.byref(err))
    if not h:
        return None
    try:
        m, n, nnz = lib.mtx_m(h), lib.mtx_n(h), lib.mtx_nnz(h)
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float64)
        lib.mtx_copy(h, rows, cols, vals)
        return int(m), int(n), rows, cols, vals
    finally:
        lib.mtx_free(h)


def pack_sell8w_native(m: int, n: int, rowptr: np.ndarray,
                       colidx: np.ndarray, vals: np.ndarray):
    """(window_ids, slice_ids, meta, vals_tiles) or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    vals32 = np.ascontiguousarray(vals, np.float32)
    ntiles = ctypes.c_int64(0)
    h = lib.sell8w_pack(m, n, rowptr, colidx, vals32, ctypes.byref(ntiles))
    if not h:
        return None
    try:
        t = int(ntiles.value)
        window_ids = np.empty(t, np.int32)
        slice_ids = np.empty(t, np.int32)
        meta = np.empty(t * 8 * 128, np.int16)
        vtiles = np.empty(t * 8 * 128, np.float32)
        lib.sell8w_copy(h, window_ids, slice_ids, meta, vtiles)
        return (window_ids, slice_ids, meta.reshape(t, 8, 128),
                vtiles.reshape(t, 8, 128))
    finally:
        lib.sell8w_free(h)


def coo2_pack_all_native(m, n, rowptr, colidx, vals, super_slices):
    """(window_ids, meta, vals_tiles, r_rowptr, r_colidx) or None.

    The fused pipeline: counting-sort by (super, window), greedy placement,
    and the pass-2 R matrix in CSR form, in one C++ pass."""
    lib = load_native()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    vals32 = np.ascontiguousarray(vals, np.float32)
    nnz = int(rowptr[-1])
    ntiles = ctypes.c_int64(0)
    h = lib.coo2_pack_all(m, n, rowptr, colidx, vals32, super_slices,
                          ctypes.byref(ntiles))
    if not h:
        return None
    try:
        t = int(ntiles.value)
        window_ids = np.empty(t, np.int32)
        meta = np.empty(t * 8 * 128, np.int16)
        vtiles = np.empty(t * 8 * 128, np.float32)
        r_rowptr = np.empty(m + 1, np.int32)
        r_colidx = np.empty(nnz, np.int32)
        lib.coo2_all_copy(h, window_ids, meta, vtiles, r_rowptr, r_colidx)
        return (window_ids, meta.reshape(t, 8, 128),
                vtiles.reshape(t, 8, 128), r_rowptr, r_colidx)
    finally:
        lib.coo2_all_free(h)


def coo2_place_native(s_arr, r_arr, v_arr, group_w, group_lo, group_hi):
    """(window_ids, meta, vals, positions) or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    s_arr = np.ascontiguousarray(s_arr, np.int16)
    r_arr = np.ascontiguousarray(r_arr, np.int16)
    v_arr = np.ascontiguousarray(v_arr, np.float32)
    group_w = np.ascontiguousarray(group_w, np.int64)
    group_lo = np.ascontiguousarray(group_lo, np.int64)
    group_hi = np.ascontiguousarray(group_hi, np.int64)
    ntiles = ctypes.c_int64(0)
    h = lib.coo2_place(len(s_arr), s_arr, r_arr, v_arr, len(group_w),
                       group_w, group_lo, group_hi, ctypes.byref(ntiles))
    if not h:
        return None
    try:
        t = int(ntiles.value)
        window_ids = np.empty(t, np.int32)
        meta = np.empty(t * 8 * 128, np.int16)
        vals = np.empty(t * 8 * 128, np.float32)
        positions = np.empty(len(s_arr), np.int64)
        lib.coo2_copy(h, window_ids, meta, vals, positions)
        return (window_ids, meta.reshape(t, 8, 128),
                vals.reshape(t, 8, 128), positions)
    finally:
        lib.coo2_free(h)


def pack_sell8d_native(m, n, rowptr, colidx, nw=1, g=16, depth_cap=-1,
                       tile_ns=25.0, spill_ns=15.0, pair_spill_ns=28.0,
                       max_spill=0.02, cell_w=False):
    """(tinfo, ginfo, meta_flat, slot_flat, kept_idx, spill_idx, cap) or
    None if the native library is unavailable.

    ``depth_cap``: -1 = auto (the cost-model rule); positive pins it.
    """
    lib = load_native()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    nt = ctypes.c_int64(0)
    nk = ctypes.c_int64(0)
    ns = ctypes.c_int64(0)
    cap = ctypes.c_int(0)
    h = lib.sell8d_pack(m, n, rowptr, colidx, nw, g, depth_cap,
                        tile_ns, spill_ns, pair_spill_ns, max_spill,
                        1 if cell_w else 0,
                        ctypes.byref(nt), ctypes.byref(nk),
                        ctypes.byref(ns), ctypes.byref(cap))
    if not h:
        return None
    try:
        t, k, s = int(nt.value), int(nk.value), int(ns.value)
        tinfo = np.empty(t, np.int32)
        ginfo = np.empty(t // g, np.int32)
        meta = np.empty(t * 8 * 128, np.int16)
        slot_flat = np.empty(k, np.int64)
        kept_idx = np.empty(k, np.int64)
        spill_idx = np.empty(max(s, 1), np.int64)
        lib.sell8d_copy(h, tinfo, ginfo, meta, slot_flat, kept_idx,
                        spill_idx)
        return (tinfo, ginfo, meta, slot_flat, kept_idx,
                spill_idx[:s], int(cap.value))
    finally:
        lib.sell8d_free(h)


def sell8d_stats_native(m, n, rowptr, colidx, tile_ns, spill_ns,
                        pair_spill_ns=28.0, max_spill=0.02):
    """Per-nw (tiles, cap, spilled) arrays for nw = 1,2,4,8, or None."""
    lib = load_native()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    t_ns = np.ascontiguousarray(tile_ns, np.float64)
    tiles = np.empty(4, np.int64)
    cap = np.empty(4, np.int64)
    spill = np.empty(4, np.int64)
    lib.sell8d_stats(m, n, rowptr, colidx, t_ns, spill_ns,
                     pair_spill_ns, max_spill, tiles, cap, spill)
    return tiles, cap, spill
