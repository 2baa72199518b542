"""any4 quantization: per-row learned 16-entry LUTs over group-normalized
weights.

A re-implementation of the reference's anyq path
(quantize.py:523-637): group-normalize W into the [0, 2^n - 1] domain, run
weighted k-means per row (vectorized on-device, see
:mod:`any4.quant.kmeans`), and return integer codes + per-row LUT +
group scales/zeros. Reconstruction is
``(lut[row, code] - 2^(n-1)) * scale + zero``.

Options mirror the reference: ``sample_weight`` (per-input-feature activation
magnitudes from calibration), ``scale_sample_weight`` (multiply by the group
scale so k-means minimizes the de-normalized output error,
quantize.py:548-551), ``abs_weight_sample_weight`` (multiply by |W|),
``bias_pow`` signed-power emphasis of extremal values (quantize.py:434-474),
``keep_outliers`` (clamp extreme centroids to the row min/max,
quantize.py:456-464), ``per_row=False`` for a single global LUT
(quantize.py:528-530), and surrogate clustering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.quant import (anyq_dequantize, group_codes_float,
                         pack_scales_and_zeros)
from . import kmeans as _kmeans


def _expand_groups(x: jax.Array, k: int, group_size: int) -> jax.Array:
    """[n, k/g] -> [n, k] by repeating each group value."""
    n = x.shape[0]
    return jnp.repeat(x, group_size, axis=1)[:, :k]


def any4_quantize(
    w: jax.Array,
    n_bit: int = 4,
    group_size: int = 128,
    per_row: bool = True,
    sample_weight: Optional[Union[jax.Array, np.ndarray, str]] = None,
    scale_sample_weight: bool = False,
    abs_weight_sample_weight: bool = False,
    bias_pow: float = 1.0,
    keep_outliers: bool = False,
    surrogate_cluster: bool = False,
    init: str = "k-means++",
    cluster_backend: str = "kmeans",
    kmeans_iters: int = 30,
    n_init: int = 1,
    row_chunk: int = 64,
    seed: int = 0,
    nnq: bool = False,
    nnq_args: Optional[dict] = None,
    sample_activations=None,
    scale_only: bool = False,
):
    """Quantize a weight matrix ``[n, k]`` to any4.

    Returns ``(codes uint8 [n, k], lut f32 [n, 16] (or [1, 16] if not
    per_row) in the [0, 2^n-1] group-normalized domain, scales f32 [n, k/g],
    zeros f32 [n, k/g])``.
    """
    w = jnp.asarray(w)
    orig_shape = w.shape
    assert w.ndim == 2
    if group_size <= 0:
        group_size = w.shape[-1]

    if not per_row:
        # single global LUT: cluster the whole matrix as one row over the
        # group-normalized values (reference quantize.py:528-530)
        wg2, scales, zeros = group_codes_float(w, n_bit, group_size,
                                               symmetric=scale_only)
        wg = wg2.reshape(1, -1)
    else:
        wg, scales, zeros = group_codes_float(w, n_bit, group_size,
                                              symmetric=scale_only)

    n, k = wg.shape

    # --- sample weights -------------------------------------------------
    sw = None
    if isinstance(sample_weight, str):
        sw_np = _kmeans.build_sample_weight(
            np.zeros(orig_shape[-1]), sample_weight)
        sw = jnp.asarray(sw_np) if sw_np is not None else None
    elif sample_weight is not None:
        sw = jnp.asarray(sample_weight, dtype=jnp.float32)

    if scale_sample_weight:
        base = jnp.ones(orig_shape, jnp.float32) if sw is None else (
            jnp.broadcast_to(sw if sw.ndim == 2 else sw[None, :], orig_shape))
        sw = base * _expand_groups(scales, orig_shape[-1], group_size)
        if not per_row:
            sw = sw.reshape(1, -1)
    if abs_weight_sample_weight:
        base = jnp.ones(orig_shape, jnp.float32) if sw is None else (
            jnp.broadcast_to(sw if sw.ndim == 2 else sw[None, :], orig_shape))
        sw = base * jnp.abs(w.astype(jnp.float32))
        if not per_row:
            sw = sw.reshape(1, -1)
    if sw is not None and sw.ndim == 1 and not per_row:
        sw = jnp.broadcast_to(sw[None, :], orig_shape).reshape(1, -1)

    # --- optional signed-power emphasis (reference quantize.py:434-474) --
    x = wg
    half = ((2**n_bit) - 1) / 2.0
    if bias_pow != 1.0:
        x = x - half
        x = jnp.abs(x) ** bias_pow * jnp.sign(x)

    surrogate = w.astype(jnp.float32).reshape(x.shape) if surrogate_cluster \
        else None

    if cluster_backend == "agglomerative":
        # reference cluster_row_agglomerative (quantize.py:420-430)
        lut, assign = _kmeans.agglomerative_rows(
            np.asarray(x), n_clusters=2**n_bit,
            sample_weight=None if sw is None else np.asarray(sw))
    else:
        lut, assign = _kmeans.kmeans_rows(
            x, n_clusters=2**n_bit, sample_weight=sw, x_surrogate=surrogate,
            init=init, iters=kmeans_iters, key=jax.random.PRNGKey(seed),
            n_init=n_init, row_chunk=row_chunk)

    if keep_outliers:
        hi = x.max(axis=1, keepdims=True)
        lo = x.min(axis=1, keepdims=True)
        # centroids are sorted ascending: first/last are the extremes
        lut = lut.at[:, -1].set(hi[:, 0]).at[:, 0].set(lo[:, 0])

    if bias_pow != 1.0:
        lut = jnp.abs(lut) ** (1.0 / bias_pow) * jnp.sign(lut) + half

    if nnq:
        # gradient refinement of the LUT values (reference learn_anyq,
        # quantize.py:687-806)
        assert per_row, "nnq refinement requires per_row=True"
        from . import nnq as _nnq
        lut, assign = _nnq.learn_lut(
            w, lut, scales, zeros, group_size=group_size,
            sample_activations=sample_activations,
            **(nnq_args or {}))

    codes = assign.astype(jnp.uint8)
    if not per_row:
        codes = codes.reshape(orig_shape)
    return codes, lut, scales, zeros


def any4_reconstruct(w: jax.Array, **kwargs) -> jax.Array:
    """Pseudo-quantization: quantize to any4 and dequantize back (the
    reference's ``anyq_reconstruct_tensor``, quantize.py:810-818)."""
    n_bit = kwargs.get("n_bit", 4)
    group_size = kwargs.get("group_size", 128)
    if group_size <= 0:
        group_size = w.shape[-1]
    codes, lut, scales, zeros = any4_quantize(w, **kwargs)
    lut2 = lut if lut.shape[0] == codes.shape[0] else lut[0]
    return anyq_dequantize(codes, lut2, scales, zeros, n_bit=n_bit,
                           group_size=group_size).astype(w.dtype)
