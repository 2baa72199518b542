"""Native (C++/OpenMP) host-side data plane, loaded via ctypes.

Compiles ``any4_native.cpp`` into a cached shared library on first import
(no pybind11 dependency) and exposes numpy wrappers. Everything degrades
gracefully: if no compiler is available, ``available() == False`` and
callers fall back to the jnp implementations in :mod:`any4.ops`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "any4_native.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    out = os.path.join(_HERE, "_any4_native.so")
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    # build beside the target and rename into place: processes that
    # build at the same time (test workers) never load a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("g++", "c++", "clang++"):
        cmd = [cc, "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
               _SRC, "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode != 0:
                # retry without OpenMP
                cmd = [c for c in cmd if c != "-fopenmp"]
                r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, out)
                return out
        except (OSError, subprocess.TimeoutExpired):
            continue
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.pack_int4_planar.argtypes = [u8p, i32p, i64, i64, i64]
    lib.unpack_int4_planar.argtypes = [i32p, u8p, i64, i64, i64]
    lib.group_quantize_f32.argtypes = [f32p, i64, i64, i64, ctypes.c_int,
                                       u8p, f32p, f32p]
    lib.lut_assign_rows.argtypes = [f32p, f32p, u8p, i64, i64]
    lib.bf16_to_f32.argtypes = [u16p, f32p, i64]
    lib.native_num_threads.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.native_num_threads() if lib else 0


def pack_int4(codes: np.ndarray, shards: int = 1) -> np.ndarray:
    """Planar-pack uint8 codes [n, k] -> int32 [n, kp/8] (matches
    ops.packing.pack_int4)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    codes = np.ascontiguousarray(codes, np.uint8)
    n, k = codes.shape
    assert k % shards == 0
    ks = k // shards
    kps = -(-ks // 1024) * 1024
    out = np.empty((n, shards * kps // 8), np.int32)
    lib.pack_int4_planar(codes, out, n, k, shards)
    return out


def unpack_int4(packed: np.ndarray, k: int, shards: int = 1) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable"
    packed = np.ascontiguousarray(packed, np.int32)
    n = packed.shape[0]
    out = np.empty((n, k), np.uint8)
    lib.unpack_int4_planar(packed, out, n, k, shards)
    return out


def group_quantize(w: np.ndarray, bits: int = 4, group_size: int = 128):
    """f32 [n, k] -> (codes u8 [n,k], scales f32 [n,k/g], zeros f32
    [n,k/g]); matches ops.quant.group_quantize."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    w = np.ascontiguousarray(w, np.float32)
    n, k = w.shape
    assert k % group_size == 0
    codes = np.empty((n, k), np.uint8)
    scales = np.empty((n, k // group_size), np.float32)
    zeros = np.empty((n, k // group_size), np.float32)
    lib.group_quantize_f32(w, n, k, group_size, bits, codes, scales, zeros)
    return codes, scales, zeros


def lut_assign(wg: np.ndarray, lut: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable"
    wg = np.ascontiguousarray(wg, np.float32)
    lut = np.ascontiguousarray(lut, np.float32)
    n, k = wg.shape
    codes = np.empty((n, k), np.uint8)
    lib.lut_assign_rows(wg, lut, codes, n, k)
    return codes


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable"
    raw = np.ascontiguousarray(raw).view(np.uint16).reshape(-1)
    out = np.empty(raw.shape, np.float32)
    lib.bf16_to_f32(raw, out, raw.size)
    return out
