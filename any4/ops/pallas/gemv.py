"""4-bit lookup-table GEMV for Hopper: Pallas on the Triton backend.

The reference's CUDA core (tinygemm) streams packed 4-bit weights from
device memory straight into registers, decodes each code with a 16-entry
table held on chip (an in-register ``__shfl_sync`` lookup for any4's
learned per-row LUT, Dequantization.cuh:93-131), applies the group scale
and zero, accumulates in f32, and splits k across warps with a reduction
through shared memory (TinyGemmImpl.cuh:23-345). This kernel keeps that
design for decode-shaped calls (``m <= M_MAX``):

- codes are read in the row-planar packing of
  :func:`any4.ops.packing.pack_int4`: a ``[BLOCK_N, 128] int32`` tile holds
  a 1024-wide k block of ``BLOCK_N`` output rows, and nibble plane ``j`` of
  it is the contiguous 128-wide k slice ``j`` -- one quantization group at
  ``group_size >= 128``;
- each code is looked up in its row's table (any4's ``[n, 16]`` LUT, a
  global ``[1, 16]`` nf4/fp4/mx4/any4 table, or the int4 ramp), the table
  being small enough to stay in L1; the value is folded with the group's
  scale and zero and rounded to bf16, which is exactly what
  :func:`any4.ops.linear.dequantize_tensor` produces in bf16;
- ``m == 1`` multiplies in f32 on the CUDA cores into a ``[BLOCK_N, 128]``
  accumulator that is reduced once at the end; ``2 <= m <= 16`` pads the
  activations to 16 rows and runs one tensor-core dot per plane;
- k is split over a second grid axis so that enough programs stream at
  once to cover the card; the ``[splits, m, n]`` f32 partial sums are
  added by XLA afterwards.

The kernel only ever runs compiled for the GPU, or in interpret mode when
a caller passes ``interpret=True``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..packing import LANES, PACK_BLOCK, PLANES

# formats whose packed codes the kernel reads (row-planar 4-bit)
FMTS = ("int4", "any4", "nf4", "fp4", "mx4")
# largest number of activation rows: tinygemm's validity range for its
# GEMV kernels (tinygemm_lib/functional.py:10-18)
M_MAX = 16
BLOCK_N = 32
NUM_WARPS = 4
# programs to aim for: a few waves over the H100's 132 SMs
_TARGET_PROGRAMS = 4 * 132
# int4's table: codes 0..15 reconstruct as (code - 8) * s + z
INT4_RAMP = tuple(float(c - 8) for c in range(16))


def supports(group_size: int, kp: int) -> bool:
    """Groups must be whole planes and tile the padded k."""
    return group_size % LANES == 0 and kp % group_size == 0


def num_splits(n_blocks: int, k_blocks: int) -> int:
    """Largest divisor of ``k_blocks`` that keeps the grid near
    ``_TARGET_PROGRAMS`` programs."""
    target = max(1, -(-_TARGET_PROGRAMS // n_blocks))
    return max(d for d in range(1, k_blocks + 1)
               if k_blocks % d == 0 and d <= target)


def _kernel(x_ref, w_ref, s_ref, z_ref, lut_ref, o_ref, *, bn: int,
            kb_per: int, group_size: int, per_row_lut: bool, vector: bool):
    i, split = pl.program_id(0), pl.program_id(1)
    row0 = i * bn
    if per_row_lut:
        rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (bn, LANES), 0)
        lut_base = rows * 16
    else:
        lut_base = jnp.zeros((bn, LANES), jnp.int32)

    def body(t, acc):
        kb = split * kb_per + t
        words = w_ref[pl.ds(row0, bn), pl.ds(kb * LANES, LANES)]
        for j in range(PLANES):
            koff = kb * PACK_BLOCK + j * LANES
            grp = koff // group_size
            codes = jax.lax.shift_right_logical(words, 4 * j) & 0xF
            v = lut_ref[lut_base + codes]                     # [bn, 128]
            s = s_ref[grp, pl.ds(row0, bn)]
            z = z_ref[grp, pl.ds(row0, bn)]
            w = (v * s[:, None] + z[:, None]).astype(jnp.bfloat16)
            if vector:
                xj = x_ref[0, pl.ds(koff, LANES)].astype(jnp.float32)
                acc = acc + w.astype(jnp.float32) * xj[None, :]
            else:
                xj = x_ref[:, pl.ds(koff, LANES)]             # [16, 128]
                acc = acc + pl.dot(xj, w, trans_b=True)
        return acc

    if vector:
        acc = jax.lax.fori_loop(0, kb_per, body,
                                jnp.zeros((bn, LANES), jnp.float32))
        o_ref[...] = jnp.sum(acc, axis=1)[None, :]
    else:
        acc = jax.lax.fori_loop(0, kb_per, body,
                                jnp.zeros((M_MAX, bn), jnp.float32))
        o_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("group_size", "interpret"))
def _lut_gemv_padded(x, packed, scales, zeros, lut, *, group_size: int,
                     interpret: bool):
    """x ``[mp, kp]`` bf16 (mp 1 or 16); packed ``[np, kp/8]`` with
    ``np % BLOCK_N == 0``; scales/zeros ``[kp/g, np]`` f32; lut flat f32
    (``np * 16`` per-row entries or 16 shared ones). Returns f32
    ``[splits, mp, np]`` partial sums."""
    mp, kp = x.shape
    np_ = packed.shape[0]
    k_blocks = kp // PACK_BLOCK
    n_blocks = np_ // BLOCK_N
    splits = num_splits(n_blocks, k_blocks)
    kern = functools.partial(
        _kernel, bn=BLOCK_N, kb_per=k_blocks // splits,
        group_size=group_size, per_row_lut=lut.shape[0] > 16,
        vector=mp == 1)
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((splits, mp, np_), jnp.float32),
        grid=(n_blocks, splits),
        in_specs=[pl.no_block_spec] * 5,
        out_specs=pl.BlockSpec((None, mp, BLOCK_N),
                               lambda i, s: (s, 0, i)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        backend="triton",
        interpret=interpret,
        name="lut_gemv",
    )(x, packed, scales, zeros, lut)


def lut_gemv(x: jax.Array, packed: jax.Array, scales: jax.Array,
             zeros: jax.Array, lut: jax.Array, *, group_size: int,
             interpret: bool = False) -> jax.Array:
    """``y = x @ dequant(W)^T`` for a row-planar 4-bit weight.

    ``x``: ``[..., k]`` with at most ``M_MAX`` rows and ``k <= kp``
    (zero-padded here); ``packed``: ``[n, kp/8] int32``; ``scales`` and
    ``zeros``: ``[kp/g, n]``; ``lut``: ``[n, 16]`` per-row or ``[1, 16]``
    shared table. Returns ``[..., n]`` in ``x.dtype``.
    """
    lead, k = x.shape[:-1], x.shape[-1]
    n, kp = packed.shape[0], packed.shape[1] * PLANES
    x2 = x.reshape(-1, k).astype(jnp.bfloat16)
    m = x2.shape[0]
    assert m <= M_MAX and k <= kp and supports(group_size, kp), \
        (m, k, kp, group_size)
    mp = 1 if m == 1 else M_MAX
    x2 = jnp.pad(x2, ((0, mp - m), (0, kp - k)))
    np_ = -(-n // BLOCK_N) * BLOCK_N
    per_row = lut.shape[0] == n and n > 1
    lut = lut.astype(jnp.float32)
    if np_ != n:
        pad = np_ - n
        packed = jnp.pad(packed, ((0, pad), (0, 0)))
        scales = jnp.pad(scales, ((0, 0), (0, pad)))
        zeros = jnp.pad(zeros, ((0, 0), (0, pad)))
        if per_row:
            lut = jnp.pad(lut, ((0, pad), (0, 0)))
    y = _lut_gemv_padded(x2, packed, scales.astype(jnp.float32),
                         zeros.astype(jnp.float32), lut.reshape(-1),
                         group_size=group_size, interpret=interpret)
    y = jnp.sum(y, axis=0)[:m, :n]
    return y.astype(x.dtype).reshape(*lead, n)
