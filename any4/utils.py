"""Shared utilities: benchmarking, tolerant comparison, memory accounting,
the compile cache.

Counterparts of the reference's utils.py: wall timing (``benchmark_in_ms``,
utils.py:32-112), the violation-tolerant ``assert_close``
(utils.py:128-194), and peak-memory tracking (``MemoryTracker`` via
nvidia-smi, utils.py:203-255 -- here via jax device memory stats).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def benchmark_in_ms(f: Callable, *args, warmup: int = 3, iters: int = 20,
                    **kwargs) -> float:
    """Median wall time per call in ms (device-synchronized)."""
    for _ in range(warmup):
        r = f(*args, **kwargs)
    jax.block_until_ready(r)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        r = f(*args, **kwargs)
        jax.block_until_ready(r)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def assert_close(actual, expected, rtol: float = 1e-2, atol: float = 1e-2,
                 allowed_violations: int = 0, factor: float = 10.0):
    """Tolerance check allowing a bounded number of larger outliers
    (reference utils.py:128-194): up to ``allowed_violations`` elements may
    exceed (rtol, atol) as long as they stay within ``factor`` times the
    tolerance."""
    a = np.asarray(actual, np.float32)
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape, f"shape {a.shape} != {e.shape}"
    err = np.abs(a - e)
    tol = atol + rtol * np.abs(e)
    bad = err > tol
    nbad = int(bad.sum())
    if nbad == 0:
        return
    assert nbad <= allowed_violations, (
        f"{nbad} violations (> {allowed_violations} allowed); "
        f"max err {err.max():.5f} at tol {tol.flat[np.argmax(err)]:.5f}")
    assert (err[bad] <= factor * tol[bad]).all(), (
        f"violations exceed {factor}x tolerance: max ratio "
        f"{(err[bad] / tol[bad]).max():.1f}")


def get_model_size(params) -> int:
    """Total parameter bytes (QuantizedTensor-aware); reference
    utils.py:115."""
    from .quant.api import model_size_bytes
    return model_size_bytes(params)


def device_memory_stats(device=None) -> Optional[dict]:
    """Live/peak device memory if the backend exposes it (the analog of the
    reference's nvidia-smi MemoryTracker)."""
    device = device or jax.devices()[0]
    try:
        return device.memory_stats()
    except Exception:
        return None


# the checkout's own compile-cache directory (listed in .gitignore); a
# fixed path, because the path is part of what the cache is keyed on
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def setup_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at :data:`COMPILE_CACHE_DIR`
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one (JAX reads that
    variable itself, and then nothing here overrides it). Call before the
    first compilation. Returns the directory set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
