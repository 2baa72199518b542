"""Vectorized weighted k-means over matrix rows (the any4 LUT learner).

The reference clusters each weight-matrix row independently with
sklearn/np k-means fanned out over joblib worker processes
(quantize.py:506-521, kmeans.py:139-287). Here we instead vectorize: all
rows are clustered in parallel as batched jnp ops (E-step distance argmin,
M-step segment means as one-hot matmuls), chunked over rows to bound
memory. One jit-compiled call clusters an entire ``[n, k]``
weight matrix.

Supported inits (reference kmeans.py:19-67): ``k-means++`` (weighted, the
default), ``random`` / ``manual_random``, ``int`` (per-row linspace),
``pow`` (per-row geomspace) and ``nf4`` (nf4 table rescaled to the row's
range). Sample-weight spec strings (``outlier_*``, ``gradual_*``) follow
reference kmeans.py:70-133.
"""
from __future__ import annotations

import functools
import re
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.formats import NF4_TABLE


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init_int(x: jax.Array, n_clusters: int) -> jax.Array:
    lo = x.min(axis=1, keepdims=True)
    hi = x.max(axis=1, keepdims=True)
    t = jnp.linspace(0.0, 1.0, n_clusters)[None, :]
    return lo + (hi - lo) * t


def _init_nf4(x: jax.Array, n_clusters: int) -> jax.Array:
    assert n_clusters == 16, "nf4 init requires 16 clusters"
    lo = x.min(axis=1, keepdims=True)
    hi = x.max(axis=1, keepdims=True)
    t = (jnp.asarray(NF4_TABLE) + 1.0) / 2.0  # [0, 1]
    return lo + (hi - lo) * t[None, :]


def _init_pow(x: jax.Array, n_clusters: int) -> jax.Array:
    """Geometric (log-spaced) spacing from row min to row max (reference
    kmeans.py "pow": base^linspace(1, log_base(max)) with base=min, which
    reduces to geomspace(min, max)). Requires positive values; the anyq
    domain is [0, 2^n-1], so the min clamps at a small epsilon."""
    lo = jnp.maximum(x.min(axis=1, keepdims=True), 1e-6)
    hi = jnp.maximum(x.max(axis=1, keepdims=True), lo * (1 + 1e-6))
    t = jnp.linspace(0.0, 1.0, n_clusters)[None, :]
    return jnp.exp(jnp.log(lo) + (jnp.log(hi) - jnp.log(lo)) * t)


def _init_random(x: jax.Array, n_clusters: int, key: jax.Array) -> jax.Array:
    r, k = x.shape
    keys = jax.random.split(key, r)

    def pick(row, kk):
        idx = jax.random.choice(kk, k, shape=(n_clusters,), replace=False)
        return row[idx]

    return jax.vmap(pick)(x, keys)


def _init_kmeanspp(x: jax.Array, weights: jax.Array, n_clusters: int,
                   key: jax.Array) -> jax.Array:
    """Weighted k-means++ seeding, vectorized over rows.

    Maintains the running min-distance-to-chosen-centroids per point and
    samples the next centroid proportionally to ``weight * d^2``.
    """
    r, k = x.shape
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (r,), 0, k)
    c0 = jnp.take_along_axis(x, first[:, None], axis=1)  # [r, 1]
    dmin = (x - c0) ** 2
    cents = [c0[:, 0]]
    for _ in range(1, n_clusters):
        kk, key = jax.random.split(key)
        logits = jnp.log(jnp.maximum(weights * dmin, 1e-30))
        idx = jax.random.categorical(kk, logits, axis=1)  # [r]
        c = jnp.take_along_axis(x, idx[:, None], axis=1)
        dmin = jnp.minimum(dmin, (x - c) ** 2)
        cents.append(c[:, 0])
    return jnp.stack(cents, axis=1)  # [r, n_clusters]


# ---------------------------------------------------------------------------
# Lloyd iterations
# ---------------------------------------------------------------------------

def _lloyd(x: jax.Array, x_surrogate: jax.Array, weights: jax.Array,
           cents: jax.Array, iters: int) -> tuple[jax.Array, jax.Array]:
    """Weighted Lloyd iterations on a row chunk.

    x: [r, k], cents: [r, c]. The M-step averages ``x_surrogate`` (equal to x
    unless surrogate clustering is enabled; reference kmeans.py:267) with
    ``weights``; empty clusters keep their previous centroid and clusters
    whose weights sum to zero fall back to the unweighted mean (reference
    kmeans.py:271-275).
    """

    def step(carry, _):
        cents, _ = carry
        d = (x[:, :, None] - cents[:, None, :]) ** 2          # [r, k, c]
        assign = jnp.argmin(d, axis=2)                          # [r, k]
        onehot = jax.nn.one_hot(assign, cents.shape[1], dtype=x.dtype)
        wsum = jnp.einsum("rk,rkc->rc", weights, onehot)
        wnum = jnp.einsum("rk,rkc->rc", weights * x_surrogate, onehot)
        csum = jnp.einsum("rk,rkc->rc", jnp.ones_like(weights), onehot)
        cnum = jnp.einsum("rk,rkc->rc", x_surrogate, onehot)
        unweighted = jnp.where(csum > 0, cnum / jnp.maximum(csum, 1e-30), cents)
        new = jnp.where(wsum > 0, wnum / jnp.maximum(wsum, 1e-30), unweighted)
        return (new, assign), None

    assign0 = jnp.zeros(x.shape, dtype=jnp.int32)
    (cents, assign), _ = jax.lax.scan(step, (cents, assign0), None, length=iters)
    # final E-step so assignments match returned centroids
    d = (x[:, :, None] - cents[:, None, :]) ** 2
    assign = jnp.argmin(d, axis=2)
    return cents, assign


@functools.partial(jax.jit, static_argnames=("n_clusters", "iters", "init",
                                             "row_chunk"))
def _kmeans_impl(x, weights, x_surrogate, key, n_clusters, iters, init,
                 row_chunk):
    r, k = x.shape

    def run_chunk(args):
        xc, wc, sc, kc = args
        if init == "k-means++":
            cents = _init_kmeanspp(xc, wc, n_clusters, kc)
        elif init in ("random", "manual_random"):
            # the reference's manual_random is a no-replacement sample
            # with numpy's global seed (kmeans.py:33-36); with explicit
            # keys it coincides with "random"
            cents = _init_random(xc, n_clusters, kc)
        elif init == "int":
            cents = _init_int(xc, n_clusters)
        elif init == "pow":
            cents = _init_pow(xc, n_clusters)
        elif init == "nf4":
            cents = _init_nf4(xc, n_clusters)
        else:
            raise ValueError(f"unsupported init {init!r}")
        return _lloyd(xc, sc, wc, cents, iters)

    nchunks = -(-r // row_chunk)
    if nchunks <= 1:
        return run_chunk((x, weights, x_surrogate, key))
    pad = nchunks * row_chunk - r
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    wp = jnp.pad(weights, ((0, pad), (0, 0)), constant_values=1.0)
    sp = jnp.pad(x_surrogate, ((0, pad), (0, 0)))
    keys = jax.random.split(key, nchunks)
    xp = xp.reshape(nchunks, row_chunk, k)
    wp = wp.reshape(nchunks, row_chunk, k)
    sp = sp.reshape(nchunks, row_chunk, k)
    cents, assign = jax.lax.map(run_chunk, (xp, wp, sp, keys))
    return (cents.reshape(nchunks * row_chunk, n_clusters)[:r],
            assign.reshape(nchunks * row_chunk, k)[:r])


def kmeans_rows(x: jax.Array, n_clusters: int = 16,
                sample_weight: Optional[jax.Array] = None,
                x_surrogate: Optional[jax.Array] = None,
                init: str = "k-means++", iters: int = 30,
                key: Optional[jax.Array] = None,
                row_chunk: int = 64,
                n_init: int = 1) -> tuple[jax.Array, jax.Array]:
    """Cluster every row of ``x`` [n, k] into ``n_clusters`` scalar centroids.

    Returns ``(centroids [n, n_clusters] f32, assign [n, k] int32)``.
    ``sample_weight`` may be ``[k]`` (shared across rows) or ``[n, k]``.
    ``n_init > 1`` reruns with different seeds and keeps, per row, the
    restart with the lowest weighted inertia (reference kmeans.py:180-188).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    r, k = x.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    if sample_weight is None:
        weights = jnp.ones_like(x)
    else:
        sample_weight = jnp.asarray(sample_weight, dtype=jnp.float32)
        weights = jnp.broadcast_to(
            sample_weight if sample_weight.ndim == 2 else sample_weight[None, :],
            x.shape)
    surrogate = x if x_surrogate is None else jnp.asarray(x_surrogate,
                                                          jnp.float32)

    if n_init > 1 and init in ("k-means++", "random", "manual_random"):
        best = None
        for t in range(n_init):
            # t=0 uses the raw key so n_init>1 strictly supersets n_init=1
            kt = key if t == 0 else jax.random.fold_in(key, t)
            cents, assign = _kmeans_impl(x, weights, surrogate, kt,
                                         n_clusters, iters, init,
                                         min(row_chunk, r))
            vals = jnp.take_along_axis(cents, assign, axis=1)
            inertia = jnp.sum(weights * (x - vals) ** 2, axis=1)  # [r]
            if best is None:
                best = (cents, assign, inertia)
            else:
                better = inertia < best[2]
                best = (jnp.where(better[:, None], cents, best[0]),
                        jnp.where(better[:, None], assign, best[1]),
                        jnp.minimum(inertia, best[2]))
        cents, assign = best[0], best[1]
    else:
        cents, assign = _kmeans_impl(x, weights, surrogate, key, n_clusters,
                                     iters, init, min(row_chunk, r))
    # sort centroids ascending so codes are monotone in value (stable layout)
    order = jnp.argsort(cents, axis=1)
    cents_sorted = jnp.take_along_axis(cents, order, axis=1)
    inv = jnp.argsort(order, axis=1)
    assign_sorted = jnp.take_along_axis(inv, assign, axis=1)
    return cents_sorted, assign_sorted.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Sample-weight spec parsing (reference kmeans.py:70-133)
# ---------------------------------------------------------------------------

def build_sample_weight(x: np.ndarray,
                        spec: Union[None, str, np.ndarray, jax.Array],
                        use_abs: bool = True):
    """Parse a sample-weight spec against data ``x`` of shape ``[k]`` or
    ``[k, d]``.

    Specs: an explicit array; ``"outlier_{factor}[_{num}]"`` (upweight the
    ``num`` largest/smallest unique values by ``factor``);
    ``"gradual_{max}[_{min}][_pow{p}]"`` (weight grows from the midpoint
    outwards). Returns a ``[k]`` numpy array or None.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if spec is None:
        return None
    if isinstance(spec, (np.ndarray, jnp.ndarray)):
        w = np.asarray(spec).squeeze()
        assert w.shape == (n,), f"sample_weight shape {w.shape} != ({n},)"
    elif isinstance(spec, str) and spec.startswith("outlier"):
        m = re.match(r"^outlier_([0-9]*\.?[0-9]+)(?:_([0-9]+))?$", spec)
        if not m:
            raise ValueError(f"failed to parse {spec!r}")
        factor = float(m.group(1))
        num = int(m.group(2)) if m.group(2) else 1
        xm = x.mean(axis=1)
        w = np.ones(n)
        uniq = np.unique(xm)
        hi = np.partition(uniq, -num)[-num:]
        lo = np.partition(uniq, num - 1)[:num]
        w[np.isin(xm, hi)] = factor
        w[np.isin(xm, lo)] = factor
    elif isinstance(spec, str) and spec.startswith("gradual"):
        m = re.match(r"^gradual_(-?[0-9]*\.?[0-9]+)(?:_(-?[0-9]*\.?[0-9]+))?"
                     r"(?:_pow(-?[0-9]*\.?[0-9]+))?$", spec)
        if not m:
            raise ValueError(f"failed to parse {spec!r}")
        fmax = float(m.group(1))
        fmin = float(m.group(2)) if m.group(2) else 1.0
        p = float(m.group(3)) if m.group(3) else 1.0
        xm = x.mean(axis=1)
        mid = (xm.max() + xm.min()) / 2
        denom = xm.max() - mid if xm.max() != mid else 1.0
        w = (fmax - fmin) * (np.abs(xm - mid) / denom) ** p + fmin
    else:
        raise ValueError(f"unsupported sample weight spec {spec!r}")
    if use_abs:
        w = np.abs(w)
    return w


# ---------------------------------------------------------------------------
# Agglomerative backend (reference quantize.py:420-430): CPU sklearn per row
# ---------------------------------------------------------------------------

def agglomerative_rows(x, n_clusters: int = 16, sample_weight=None):
    """Per-row agglomerative clustering with weighted-average centroids
    (reference ``cluster_row_agglomerative``). CPU/sklearn; rows are
    processed in a Python loop, so this is for small matrices or parity
    experiments -- the vectorized k-means is the production path.

    Returns ``(centroids [n, n_clusters] f32 (sorted), assign [n, k] i32)``.
    """
    import numpy as _np
    from sklearn.cluster import AgglomerativeClustering

    x = _np.asarray(x, _np.float64)
    n, k = x.shape
    sw = None if sample_weight is None else _np.asarray(sample_weight)
    cents = _np.zeros((n, n_clusters), _np.float32)
    assign = _np.zeros((n, k), _np.int32)
    for r in range(n):
        labels = AgglomerativeClustering(n_clusters=n_clusters).fit(
            x[r].reshape(-1, 1)).labels_
        row_w = None if sw is None else (sw[r] if sw.ndim == 2 else sw)
        vals = _np.empty(n_clusters)
        for c in range(n_clusters):
            m = labels == c
            w = None if row_w is None else row_w[m]
            if w is not None and w.sum() == 0:
                w = None
            vals[c] = _np.average(x[r][m], weights=w)
        order = _np.argsort(vals)
        inv = _np.empty_like(order)
        inv[order] = _np.arange(n_clusters)
        cents[r] = vals[order]
        assign[r] = inv[labels]
    return jnp.asarray(cents), jnp.asarray(assign)
