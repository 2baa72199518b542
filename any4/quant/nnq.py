"""Gradient-based LUT refinement (the reference's nnq / learn_anyq path).

The reference trains the 16 per-row LUT values with Adam against a
weight-MSE or layer-output-MSE objective, using a straight-through-estimator
through the nearest-value assignment (quantize.py:639-806 ``AnyQNN`` /
``learn_anyq``). Here the assignment is recomputed each step from
the current LUT (hard nearest-neighbor, constant through the gradient), and
the LUT is updated by optax Adam on the differentiable reconstruction.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ..ops.quant import group_codes_float


def _assign(wg: jax.Array, lut: jax.Array) -> jax.Array:
    """Nearest-centroid assignment [n, k] for per-row LUTs [n, 16]."""
    d = jnp.abs(wg[:, :, None] - lut[:, None, :])
    return jnp.argmin(d, axis=2)


def _reconstruct(lut, assign, scales, zeros, group_size, n_bit=4):
    vals = jnp.take_along_axis(lut, assign, axis=1) - 2 ** (n_bit - 1)
    n, k = assign.shape
    vg = vals.reshape(n, k // group_size, group_size)
    w = vg * scales[..., None] + zeros[..., None]
    return w.reshape(n, k)


@functools.partial(jax.jit,
                   static_argnames=("group_size", "objective", "steps", "lr"))
def _train(wg, w, lut0, scales, zeros, x, key, group_size, objective,
           steps, lr):
    opt = optax.adam(lr)

    def nlc_loss(output, label):
        # negative log of the mean per-row cosine similarity (reference
        # nlc_loss, quantize.py:678-684)
        num = jnp.sum(output * label, axis=-1)
        den = jnp.linalg.norm(output, axis=-1) * \
            jnp.linalg.norm(label, axis=-1) + 1e-8
        cos = jnp.abs(jnp.mean(num / den))
        return -jnp.log(jnp.maximum(cos, 1e-8))

    def loss_fn(lut, assign):
        wq = _reconstruct(lut, assign, scales, zeros, group_size)
        if objective == "w_mse":
            return jnp.mean((wq - w) ** 2)
        if objective == "w_cossim":
            return nlc_loss(wq, w)
        y = x @ w.T
        yq = x @ wq.T
        if objective == "y_cossim":
            return nlc_loss(yq.T, y.T)  # per output-channel cossim
        return jnp.mean((y - yq) ** 2)

    def step(carry, _):
        lut, opt_state = carry
        assign = _assign(wg, lut)  # hard assignment, constant in grad
        g = jax.grad(loss_fn)(lut, assign)
        updates, opt_state = opt.update(g, opt_state, lut)
        lut = optax.apply_updates(lut, updates)
        return (lut, opt_state), None

    (lut, _), _ = jax.lax.scan(step, (lut0, opt.init(lut0)), None,
                               length=steps)
    return lut


def learn_lut(w: jax.Array, lut_init: jax.Array, scales: jax.Array,
              zeros: jax.Array, group_size: int = 128,
              objective: str = "y_mse",
              sample_activations: Optional[jax.Array] = None,
              steps: int = 200, lr: float = 1e-3,
              seed: int = 0):
    """Refine per-row LUTs (in the [0, 15] group-normalized domain).

    Returns ``(lut, assign)``. ``objective`` is one of
    ``{w_mse, y_mse, w_cossim, y_cossim}`` (the reference's W_mse / Y_mse /
    *cossim criteria, quantize.py:707-714); ``sample_activations`` [t, k]
    drive the y_* objectives; random activations are drawn if absent
    (reference learn_anyq X_val fallback, quantize.py:728-733).
    """
    w = jnp.asarray(w, jnp.float32)
    wg, _, _ = group_codes_float(w, 4, group_size)
    key = jax.random.PRNGKey(seed)
    if objective in ("y_mse", "y_cossim"):
        if sample_activations is None:
            x = jax.random.normal(key, (256, w.shape[1]), jnp.float32)
        else:
            x = jnp.asarray(sample_activations, jnp.float32)
    else:
        x = jnp.zeros((1, w.shape[1]), jnp.float32)
    lut = _train(wg, w, jnp.asarray(lut_init, jnp.float32), scales, zeros,
                 x, key, group_size, objective, steps, lr)
    # sort for the canonical monotone code layout
    lut = jnp.sort(lut, axis=1)
    assign = _assign(wg, lut)
    return lut, assign.astype(jnp.uint8)
