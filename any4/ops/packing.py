"""Packed weight layouts.

The analog of the reference's tensor-core layout converters
(TinyGemmConvertA.cu / TinyGemmConvertB.cu): a one-time pre-processing step
that rearranges quantized codes into the layout the compute paths consume.
The CUDA reference interleaves 8 codes per int32 in `75316420` nibble order
to match its `mma.sync` fragment ownership; the lookup GEMV kernel here
(:mod:`any4.ops.pallas.gemv`) instead reads **planar nibble packing**, so
that each 4-bit shift/mask of a loaded int32 block yields a *contiguous
k-slice* aligned with quantization groups:

For each k-block of ``PACK_BLOCK = 1024`` weights of one logical weight row,
view the codes as ``[8, 128]`` (8 planes x 128 lanes); nibble ``j`` of the
packed word at lane ``l`` holds ``codes[k_block*1024 + j*128 + l]``. Packed
storage is row-major ``packed[r, kb*128 + l]``. A kernel that loads the
packed block ``[bn, 128] int32`` recovers plane ``j`` (one contiguous
128-wide k-slice per output row, one quantization group at g >= 128) with
``(word >> 4j) & 0xF``.

k is zero-padded to a multiple of 1024 at pack time (codes 0, scales/zeros 0,
so padded columns reconstruct to exactly 0.0 and contribute nothing).

The other layouts (pair, quad, transposed, grouped, row-scale) are storage
layouts that :func:`any4.ops.linear.dequantize_tensor` and the XLA int8 paths
read.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PACK_BLOCK = 1024          # k-weights per packed block
PLANES = 8                 # nibbles per int32
LANES = PACK_BLOCK // PLANES  # 128


def padded_k(k: int) -> int:
    return -(-k // PACK_BLOCK) * PACK_BLOCK


def pad_axis(x: jax.Array, axis: int, target: int, value=0) -> jax.Array:
    """Zero-pad ``x`` along ``axis`` up to length ``target``."""
    cur = x.shape[axis]
    if cur == target:
        return x
    assert cur < target
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - cur)
    return jnp.pad(x, pads, constant_values=value)


def pack_int4(codes: jax.Array, shards: int = 1) -> jax.Array:
    """Pack 4-bit codes ``[n, k]`` (values in [0,15]) into planar int32
    ``[n, k_padded/8]``.

    ``shards > 1`` packs each of the ``shards`` contiguous k-slices
    independently (each zero-padded to a PACK_BLOCK multiple) so that
    sharding the packed array along its word axis splits exactly at logical
    k boundaries -- required for row-parallel tensor parallelism, where each
    device must hold a contiguous k-range of the weight.
    """
    n, k = codes.shape
    if shards > 1:
        assert k % shards == 0, f"k={k} not divisible by shards={shards}"
        parts = [pack_int4(codes[:, s * (k // shards):(s + 1) * (k // shards)])
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    kp = padded_k(k)
    c = pad_axis(codes.astype(jnp.int32), 1, kp)
    c = c.reshape(n, kp // PACK_BLOCK, PLANES, LANES)
    shifts = (4 * jnp.arange(PLANES, dtype=jnp.int32))[None, None, :, None]
    words = jnp.sum(c << shifts, axis=2, dtype=jnp.int32)  # [n, kb, 128]
    return words.reshape(n, kp // PLANES)


def unpack_int4(packed: jax.Array, k: int, shards: int = 1) -> jax.Array:
    """Inverse of :func:`pack_int4`; returns uint8 codes ``[n, k]``."""
    if shards > 1:
        n, kw = packed.shape
        per = kw // shards
        parts = [unpack_int4(packed[:, s * per:(s + 1) * per], k // shards)
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    n, kw = packed.shape
    kp = kw * PLANES
    words = packed.reshape(n, kp // PACK_BLOCK, 1, LANES)
    shifts = (4 * jnp.arange(PLANES, dtype=jnp.int32))[None, None, :, None]
    c = (jax.lax.shift_right_logical(words, shifts)) & 0xF  # [n, kb, j, l]
    return c.reshape(n, kp)[:, :k].astype(jnp.uint8)


def pad_group_arrays(scales: jax.Array, zeros: jax.Array | None, k: int,
                     group_size: int, shards: int = 1):
    """Pad per-group scale/zero arrays ``[n, k/g]`` to cover ``padded_k(k)``
    groups with zeros (so padded weights reconstruct to 0). With
    ``shards > 1`` padding is applied per contiguous k-shard, mirroring
    :func:`pack_int4`."""
    if shards > 1:
        gs = scales.shape[1] // shards
        parts = [pad_group_arrays(
            scales[:, s * gs:(s + 1) * gs],
            None if zeros is None else zeros[:, s * gs:(s + 1) * gs],
            k // shards, group_size) for s in range(shards)]
        s_all = jnp.concatenate([p[0] for p in parts], axis=1)
        z_all = None if zeros is None else \
            jnp.concatenate([p[1] for p in parts], axis=1)
        return s_all, z_all
    kp = padded_k(k)
    gp = kp // group_size
    scales = pad_axis(scales, 1, gp)
    if zeros is not None:
        zeros = pad_axis(zeros, 1, gp)
    return scales, zeros


def pack_int4_pair(codes: jax.Array, shards: int = 1) -> jax.Array:
    """Pair-packed int4: TWO output rows per int32 word,
    ``[n/2, k_padded/4]``.

    ``word[rp, kb*128 + l]`` bit-field ``[4p + 16h, +4)`` holds
    ``codes[2*rp + h, kb*512 + p*128 + l]``: nibble plane ``p`` covers one
    contiguous 128-wide k-slice (= one g=128 quant group) and halves ``h``
    are the row pair, so ``(word >> 4p) & 0x000F000F | 0x43004300`` read
    as bf16 is ``128 + code`` for both rows at once (the reference's
    magic-number dequant, Dequantization.cuh:136-260). ``n`` must be even.
    """
    n, k = codes.shape
    assert n % 2 == 0, f"pair packing needs an even n, got {n}"
    if shards > 1:
        assert k % shards == 0
        parts = [pack_int4_pair(
            codes[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    kp = padded_k(k)
    c = pad_axis(codes.astype(jnp.uint32), 1, kp)
    c = c.reshape(n // 2, 2, kp // 512, 4, 128)
    sh = (4 * jnp.arange(4, dtype=jnp.uint32))[None, None, None, :, None] \
        + (16 * jnp.arange(2, dtype=jnp.uint32))[None, :, None, None, None]
    words = jnp.sum(c << sh, axis=(1, 3), dtype=jnp.uint32)
    return words.astype(jnp.int32).reshape(n // 2, kp // 4)


def unpack_int4_pair(packed: jax.Array, k: int, shards: int = 1
                     ) -> jax.Array:
    """Inverse of :func:`pack_int4_pair`; returns uint8 codes ``[n, k]``."""
    if shards > 1:
        nh, kw = packed.shape
        per = kw // shards
        parts = [unpack_int4_pair(packed[:, s * per:(s + 1) * per],
                                  k // shards)
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    nh, kw = packed.shape
    kp = kw * 4
    words = packed.reshape(nh, 1, kp // 512, 1, 128).astype(jnp.uint32)
    sh = (4 * jnp.arange(4, dtype=jnp.uint32))[None, None, None, :, None] \
        + (16 * jnp.arange(2, dtype=jnp.uint32))[None, :, None, None, None]
    c = (words >> sh) & 0xF                        # [n/2, 2, kb, 4, 128]
    return c.reshape(nh * 2, kp)[:, :k].astype(jnp.uint8)


def pack_int4_quad(codes: jax.Array, shards: int = 1) -> jax.Array:
    """Quad-packed int4 (the w4a8 layout): FOUR output rows per int32
    word, ``[n/4, k_padded/2]``.

    ``word[rq, kb*128 + l]`` bit-field ``[8b + 4p, +4)`` holds
    ``codes[4*rq + b, kb*256 + p*128 + l]``: each byte ``b`` is one output
    row and its two nibbles ``p`` are two consecutive 128-wide k-slices
    (= two g>=128 quant sub-groups), so one mask (+ shift) and an
    int32->int8 bitcast yield a whole ``[4, 128]`` code tile. ``n`` must be
    divisible by 4.
    """
    n, k = codes.shape
    assert n % 4 == 0, f"quad packing needs n % 4 == 0, got {n}"
    if shards > 1:
        assert k % shards == 0
        parts = [pack_int4_quad(
            codes[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    kp = padded_k(k)
    c = pad_axis(codes.astype(jnp.uint32), 1, kp)
    c = c.reshape(n // 4, 4, kp // 256, 2, 128)
    sh = (8 * jnp.arange(4, dtype=jnp.uint32))[None, :, None, None, None] \
        + (4 * jnp.arange(2, dtype=jnp.uint32))[None, None, None, :, None]
    words = jnp.sum(c << sh, axis=(1, 3), dtype=jnp.uint32)
    return words.astype(jnp.int32).reshape(n // 4, kp // 2)


def unpack_int4_quad(packed: jax.Array, k: int, shards: int = 1
                     ) -> jax.Array:
    """Inverse of :func:`pack_int4_quad`; returns uint8 codes ``[n, k]``."""
    if shards > 1:
        nq, kw = packed.shape
        per = kw // shards
        parts = [unpack_int4_quad(packed[:, s * per:(s + 1) * per],
                                  k // shards)
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    nq, kw = packed.shape
    kp = kw * 2
    words = packed.reshape(nq, 1, kp // 256, 1, 128).astype(jnp.uint32)
    sh = (8 * jnp.arange(4, dtype=jnp.uint32))[None, :, None, None, None] \
        + (4 * jnp.arange(2, dtype=jnp.uint32))[None, None, None, :, None]
    c = (words >> sh) & 0xF                        # [n/4, 4, kb, 2, 128]
    return c.reshape(nq * 4, kp)[:, :k].astype(jnp.uint8)


def pack_int8(q: jax.Array, shards: int = 1) -> jax.Array:
    """int8 weights need no nibble packing; this just zero-pads k to the
    pack block (row-major ``[n, kp]``), per contiguous k-shard when
    ``shards > 1``."""
    n, k = q.shape
    if shards > 1:
        assert k % shards == 0
        return jnp.concatenate(
            [pack_int8(q[:, s * (k // shards):(s + 1) * (k // shards)])
             for s in range(shards)], axis=1)
    return pad_axis(q, 1, padded_k(k))


def pack_int8_quad(q: jax.Array, shards: int = 1) -> jax.Array:
    """Quad-packed int8 weights: FOUR output rows per int32 word,
    ``[n/4, k_padded] int32``.

    ``word[rq, c]`` byte ``b`` holds ``q[4*rq + b, c]`` (as uint8 bits), so
    an int32->int8 bitcast of a word row yields four rows' centered int8
    codes in row order (pack_int4_quad's mechanics on full bytes).
    ``n % 4 == 0`` required.
    """
    n, k = q.shape
    assert n % 4 == 0, f"quad packing needs n % 4 == 0, got {n}"
    if shards > 1:
        assert k % shards == 0
        parts = [pack_int8_quad(
            q[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    kp = padded_k(k)
    u = pad_axis(q, 1, kp).astype(jnp.int32) & 0xFF    # uint8 bit pattern
    u = u.reshape(n // 4, 4, kp)
    sh = (8 * jnp.arange(4, dtype=jnp.int32))[None, :, None]
    words = jnp.sum(u << sh, axis=1, dtype=jnp.int32)  # [n/4, kp]
    return words


def unpack_int8_quad(packed: jax.Array, k: int, shards: int = 1
                     ) -> jax.Array:
    """Inverse of :func:`pack_int8_quad`; returns int8 ``[n, k]``."""
    if shards > 1:
        nq, kw = packed.shape
        per = kw // shards
        parts = [unpack_int8_quad(packed[:, s * per:(s + 1) * per],
                                  k // shards)
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    nq, kw = packed.shape
    sh = (8 * jnp.arange(4, dtype=jnp.int32))[None, :, None]
    u = (jax.lax.shift_right_logical(
        packed.reshape(nq, 1, kw), sh)) & 0xFF          # [n/4, 4, kw]
    q = jnp.where(u >= 128, u - 256, u).astype(jnp.int8)
    return q.reshape(nq * 4, kw)[:, :k]


def pack_int8_transposed(q: jax.Array, shards: int = 1) -> jax.Array:
    """Transposed int8 layout: centered int8 codes ``[n, k]`` ->
    ``[k_padded, n] int8`` (the natural ``x [m, k] @ w [k, n]``
    orientation). ``shards > 1`` pads each contiguous k-slice
    independently (row-parallel TP splits on axis 0).
    """
    n, k = q.shape
    if shards > 1:
        assert k % shards == 0, f"k={k} not divisible by shards={shards}"
        parts = [pack_int8_transposed(
            q[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=0)
    return pad_axis(q.T, 0, padded_k(k))


def unpack_int8_transposed(packed: jax.Array, k: int, shards: int = 1
                           ) -> jax.Array:
    """Inverse of :func:`pack_int8_transposed`; returns int8 ``[n, k]``."""
    if shards > 1:
        kw, n = packed.shape
        per = kw // shards
        parts = [unpack_int8_transposed(
            packed[s * per:(s + 1) * per], k // shards)
            for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    return packed[:k].T


def pack_int8_grouped(q: jax.Array, shards: int = 1) -> jax.Array:
    """Grouped int8 layout for the XLA-dot path: centered int8 codes
    ``[n, k]`` -> ``[k_padded/128, n, 128]`` (one 128-wide quantization
    sub-group per leading batch index).

    It feeds XLA's int8 x int8 -> int32 ``dot_general`` as ONE batched
    contraction ``x [G, m, 128] . w [G, n, 128] -> [G, m, n]`` whose int32
    group partials take the exact post-dot affine
    ``y = sum_g P_g * s_g + sum(x_g) * z_g`` as two small einsums.
    ``shards > 1`` packs each contiguous k-slice independently
    (row-parallel TP splits on axis 0 at group granularity).
    """
    n, k = q.shape
    if shards > 1:
        assert k % shards == 0, f"k={k} not divisible by shards={shards}"
        parts = [pack_int8_grouped(
            q[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=0)
    kp = padded_k(k)
    qp = pad_axis(q, 1, kp)                       # [n, kp]
    return qp.reshape(n, kp // LANES, LANES).transpose(1, 0, 2)


def unpack_int8_grouped(packed: jax.Array, k: int, shards: int = 1
                        ) -> jax.Array:
    """Inverse of :func:`pack_int8_grouped`; returns int8 ``[n, k]``."""
    if shards > 1:
        gw = packed.shape[0] // shards
        parts = [unpack_int8_grouped(packed[s * gw:(s + 1) * gw],
                                     k // shards)
                 for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    g, n, lanes = packed.shape
    return packed.transpose(1, 0, 2).reshape(n, g * lanes)[:, :k]


def pack_rowscale(q: jax.Array, shards: int = 1) -> jax.Array:
    """``[k, n] int8`` (transposed at pack time) for the per-row-scale
    XLA-dot formats (w8a8r/int8r/any4q8r): no padding, no word packing,
    the natural dot orientation. The [n, k] orientation with a dim-1
    contraction can make XLA re-lay the weight out per step inside a
    decode scan, while [k, n] contracts directly. A contiguous k split needs no per-shard padding, so
    ``shards`` only asserts divisibility (row-parallel TP splits
    axis 0)."""
    n, k = q.shape
    if shards > 1:
        assert k % shards == 0, f"k={k} not divisible by shards={shards}"
    return q.T.astype(jnp.int8)


def pack_int4_transposed(codes: jax.Array, shards: int = 1) -> jax.Array:
    """Transposed planar packing (the any4t/nf4t/fp4t storage layout):
    4-bit codes ``[n, k]`` -> int32 words ``[k_padded/8, n]``.

    k is blocked in 128-wide groups; within a group, word row ``K`` (of 16)
    holds in nibble ``p`` the code for k-offset ``p*16 + K``. Unpacking
    plane ``p`` of a ``[16, n]`` word block and concatenating the 8 planes
    along axis 0 therefore yields ``ct[j, r] = codes[r, k_base + j]`` --
    codes in NATURAL k order with output rows on axis 1.

    ``shards > 1`` packs contiguous k-slices independently (each padded to
    a PACK_BLOCK multiple) so sharding along axis 0 splits at logical k
    boundaries (row-parallel TP).
    """
    n, k = codes.shape
    if shards > 1:
        assert k % shards == 0, f"k={k} not divisible by shards={shards}"
        parts = [pack_int4_transposed(
            codes[:, s * (k // shards):(s + 1) * (k // shards)])
            for s in range(shards)]
        return jnp.concatenate(parts, axis=0)
    kp = padded_k(k)
    c = pad_axis(codes.astype(jnp.int32), 1, kp)
    c = c.reshape(n, kp // LANES, PLANES, 16)      # k = g*128 + p*16 + K
    c = c.transpose(1, 3, 2, 0)                    # [groups, 16, planes, n]
    shifts = (4 * jnp.arange(PLANES, dtype=jnp.int32))[None, None, :, None]
    words = jnp.sum(c << shifts, axis=2, dtype=jnp.int32)  # [groups, 16, n]
    return words.reshape(kp // PLANES, n)


def unpack_int4_transposed(packed: jax.Array, k: int, shards: int = 1
                           ) -> jax.Array:
    """Inverse of :func:`pack_int4_transposed`; returns uint8 ``[n, k]``."""
    if shards > 1:
        kw, n = packed.shape
        per = kw // shards
        parts = [unpack_int4_transposed(
            packed[s * per:(s + 1) * per], k // shards)
            for s in range(shards)]
        return jnp.concatenate(parts, axis=1)
    kw, n = packed.shape
    kp = kw * PLANES
    words = packed.reshape(kp // LANES, 16, 1, n)
    shifts = (4 * jnp.arange(PLANES, dtype=jnp.int32))[None, None, :, None]
    c = (jax.lax.shift_right_logical(words, shifts)) & 0xF  # [g, K, p, n]
    c = c.transpose(3, 0, 2, 1)                    # [n, g, p, K]
    return c.reshape(n, kp)[:, :k].astype(jnp.uint8)
