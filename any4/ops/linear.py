"""Quantized tensor container and the `linear` dispatch API.

The reference wraps packed weights in nn.Module subclasses
(Int4Linear/Int8Linear/Any4Linear, modules.py:12-230) that dispatch on a
kernel-name string. Here a quantized weight is a *pytree leaf bundle*
(:class:`QuantizedTensor`) carried inside the model's parameter tree, and
:func:`linear` is a functional op that dispatches between the 4-bit
lookup GEMV kernel (decode, m <= 16, on the GPU) and XLA formulations:
dequantize-then-matmul for the weight-only formats, and int8 dots with
post-dot group affines for the int8-activation formats (w4a8/w8a8/any4q8),
the analog of the reference's m<=16 kernel validity rule
(tinygemm_lib/functional.py:10-18).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import jax
import jax.numpy as jnp

from . import packing, quant
from .formats import get_table
from .pallas import gemv

# formats whose packed codes are 4-bit planar words
_NIBBLE_FMTS = ("int4", "any4", "nf4", "fp4", "mx4")
# transposed packings (packed axis 0 carries k, axis 1 n): readable
# storage layouts, computed through dequantize-then-matmul
TRANSPOSED_FMTS = ("any4t", "nf4t", "fp4t", "w8a8t", "int8t")
# transposed formats whose packed array is int8 [kp, n] (one k per row)
_T_INT8_FMTS = ("w8a8t", "int8t")
# quad-word int8 formats: packed [n/4, kp] int32, four rows' bytes per word
_QUAD8_FMTS = ("w8a8q", "int8q", "any4q8")
# grouped int8 formats: packed [kp/128, n, 128] int8 for one batched int8
# dot -> per-group int32 partials + two small affine einsums
_GROUPED_FMTS = ("w8a8g", "int8g", "any4q8g")
# per-ROW-scale int8 formats: packed [k, n] int8, scales [1, n]. One
# full-k dot + a rank-1 affine -- no per-group partials. Accuracy: 8-bit
# per-channel (w8a8r/int8r) or the any4 per-row LUT learned on
# row-normalized weights (any4q8r) -- any4's learned codebook is the
# format whose quality survives whole-row grouping (BASELINE.md
# group-size table: any4 degrades 2.8% from g=128 to g=1024 where
# fp4/nf4 explode).
_ROWSCALE_FMTS = ("w8a8r", "int8r", "any4q8r")
# int8-ACTIVATION formats: activations are quantized per row to int8 and
# the int8 x int8 group dots accumulate in int32
_A8_FMTS = ("w4a8", "w8a8", "w8a8t", "w8a8q", "any4q8", "w8a8g", "any4q8g")
# largest m for the grouped XLA formulation: its [G, m, n] int32 partial
# tensor grows with m; above this the dequantize-then-matmul path runs.
# Per-row formats never materialize partials and take every m.
_XLA_GROUPED_M_MAX = 128
# int8 activation-quantization constants
ACT_QMAX = 127.0
ACT_EPS = 1e-8


@jax.tree_util.register_pytree_node_class
@dataclass
class QuantizedTensor:
    """A quantized 2-D weight ``[n, k]`` in packed layout.

    Fields (all device arrays):
      packed: ``[n, kp/8] int32`` planar nibbles (4-bit fmts) or
              ``[n, kp] int8`` (int8).
      scales: ``[kp/g, n] f32`` transposed group scales, matching the
              reference's scales_and_zeros layout (tinygemm_lib/
              utils.py:53-65) (for mx4 these are the decoded e8m0
              scales)
      zeros:  ``[kp/g, n] f32`` zeros of the affine reconstruction (0 for
              absmax formats)
      lut:    ``[n, 16]`` centered per-row LUT (any4), ``[1, 16]`` global
              table (nf4/fp4/mx4), or None (int4/int8). Reconstruction is
              ``lut[code] * scale + zero`` -- for any4 the stored LUT is
              pre-centered (``lut - 8``), matching the reference module
              convention (quantize.py:893).
    """
    packed: jax.Array
    scales: jax.Array
    zeros: jax.Array
    lut: Optional[jax.Array]
    fmt: str = field(metadata=dict(static=True), default="int4")
    group_size: int = field(metadata=dict(static=True), default=128)
    shape: tuple = field(metadata=dict(static=True), default=())
    dtype: jnp.dtype = field(metadata=dict(static=True), default=jnp.bfloat16)
    # number of independently-packed contiguous k-shards (row-parallel TP):
    # each shard's k-range is padded to the pack block on its own, so array
    # sharding along the packed axis splits at logical k boundaries
    row_shards: int = field(metadata=dict(static=True), default=1)

    def tree_flatten(self):
        children = (self.packed, self.scales, self.zeros, self.lut)
        aux = (self.fmt, self.group_size, self.shape, self.dtype,
               self.row_shards)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        packed, scales, zeros, lut = children
        fmt, group_size, shape, dtype, row_shards = aux
        return cls(packed, scales, zeros, lut, fmt, group_size, shape, dtype,
                   row_shards)

    @property
    def nbytes(self) -> int:
        tot = sum(int(a.size) * a.dtype.itemsize
                  for a in (self.packed, self.scales, self.zeros)
                  if a is not None)
        if self.lut is not None:
            tot += int(self.lut.size) * self.lut.dtype.itemsize
        return tot


def quantize_tensor(w: jax.Array, fmt: str = "any4", group_size: int = 128,
                    row_shards: int = 1, **kwargs) -> QuantizedTensor:
    """Quantize a 2-D weight ``[n, k]`` into packed layout.

    ``kwargs`` are forwarded to the any4 learner for ``fmt="any4"``
    (sample_weight, init, keep_outliers, ...). ``row_shards`` packs the k
    axis as that many independently-padded contiguous shards (for
    row-parallel TP; see packing.pack_int4).

    The 4-bit formats (int4/any4/nf4/fp4/mx4) use the row-planar packing
    the lookup GEMV kernel reads (:mod:`any4.ops.pallas.gemv`).
    ``layout="transposed"`` stores any4/nf4/fp4 in the transposed packing
    instead (fmt ``any4t``/``nf4t``/``fp4t``, same numbers);
    ``layout="row"`` keeps the row-major int8 layouts (needed for row
    gathers, e.g. quantized embedding tables).
    """
    from ..quant import anyq  # local import to avoid cycle
    import numpy as _np

    layout = kwargs.pop("layout", None)
    assert layout in (None, "row", "transposed"), \
        f"layout must be None/'row'/'transposed', got {layout!r}"
    n, k = w.shape
    if group_size <= 0 or group_size > k:
        # whole-row grouping when the layer is narrower than the group
        group_size = k
    if fmt in ("any4", "nf4", "fp4") and layout == "transposed" \
            and group_size % 128 == 0:
        fmt = fmt + "t"
    if fmt in ("w8a8", "int8", "any4q8") and layout != "row" \
            and group_size % 128 == 0:
        # int8-weight routing depends on k: the grouped layout at
        # k >= 4096 (and wherever n cannot be quad-packed), the quad-word
        # layout below. Both compute through XLA int8 dots with identical
        # numbers; the k threshold is not yet measured on the H100.
        # Row-major remains for embeddings (layout="row") and
        # g % 128 != 0; all layouts stay explicitly addressable.
        if k >= 4096 or n % 4 != 0:
            fmt = {"w8a8": "w8a8g", "int8": "int8g",
                   "any4q8": "any4q8g"}[fmt]
        elif fmt != "any4q8":
            fmt = {"w8a8": "w8a8q", "int8": "int8q"}[fmt]
    host_input = isinstance(w, _np.ndarray)
    int_zeros = bool(kwargs.pop("int_zeros", False))
    assert not int_zeros or fmt in ("int4", "int4p", "int8", "int8p",
                                    "w4a8", "w8a8", "w8a8t", "int8t",
                                    "w8a8g", "int8g"), \
        f"int_zeros (group_q1/new_grouping) applies to int formats, not {fmt!r}"
    if fmt in ("int4", "int4p") and host_input and k % group_size == 0 \
            and not int_zeros and not kwargs.get("scale_only", False):
        # host-side (checkpoint-conversion) fast path: the C++/OpenMP data
        # plane quantizes (and for the planar layout packs) without a
        # device round trip (the analog of the reference's host conversion
        # stage, TinyGemmConvertB.cu:21-466)
        from .. import native
        if native.available():
            codes_n, scales_n, zeros_n = native.group_quantize(
                _np.asarray(w, _np.float32), 4, group_size)
            if fmt == "int4p":
                packed_n = packing.pack_int4_pair(jnp.asarray(codes_n),
                                                  row_shards)
            else:
                packed_n = jnp.asarray(native.pack_int4(codes_n, row_shards))
            scales, zeros = packing.pad_group_arrays(
                jnp.asarray(scales_n), jnp.asarray(zeros_n), k, group_size,
                row_shards)
            return QuantizedTensor(
                packed_n, scales.T.astype(jnp.float32),
                zeros.T.astype(jnp.float32), None, fmt, group_size, (n, k),
                jnp.dtype(w.dtype), row_shards)
    if host_input:
        w = jnp.asarray(w)
    symmetric = bool(kwargs.pop("scale_only", False))
    assert not symmetric or fmt in ("int4", "int4p", "int8", "int8p",
                                    "w4a8", "w8a8", "w8a8t", "int8t",
                                    "w8a8g", "int8g", "w8a8r", "int8r",
                                    "any4", "any4t", "any4q8", "any4q8g",
                                    "any4q8r"), \
        f"scale_only (symmetric) applies to int/any4 formats, not {fmt!r}"
    if fmt == "int4":
        codes, scales, zeros = quant.group_quantize(
            w, 4, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int4(codes, row_shards)
        lut = None
    elif fmt == "w4a8":
        # int4 weights (same codes/scales as fmt="int4") quad-packed,
        # four rows per int32 word; activations are quantized per row to
        # int8 at matmul time (quantize_activations)
        assert group_size % 128 == 0, \
            "w4a8 requires group_size a multiple of 128"
        assert n % 4 == 0, "w4a8 quad packing requires n % 4 == 0"
        codes, scales, zeros = quant.group_quantize(
            w, 4, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int4_quad(codes, row_shards)
        lut = None
    elif fmt == "w8a8":
        # centered int8 codes stored row-major [n, kp] (reached via
        # layout="row"); the int8 dots take post-dot (s, z) affines
        assert group_size % 128 == 0, \
            "w8a8 requires group_size a multiple of 128"
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int8(q, row_shards)
        lut = None
    elif fmt in ("w8a8t", "int8t"):
        # transposed int8: same numbers as w8a8/int8, codes stored [kp, n]
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int8_transposed(q, row_shards)
        lut = None
    elif fmt in ("w8a8q", "int8q"):
        # quad-word int8: four rows' bytes per int32 word
        assert group_size % 128 == 0, \
            f"{fmt} requires group_size a multiple of 128"
        assert n % 4 == 0, f"{fmt} quad packing requires n % 4 == 0"
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int8_quad(q, row_shards)
        lut = None
    elif fmt in ("w8a8g", "int8g"):
        # grouped int8: same numbers as w8a8/int8, codes stored
        # [kp/128, n, 128] for the batched int8 dot_general (see
        # packing.pack_int8_grouped)
        assert group_size % 128 == 0, \
            f"{fmt} requires group_size a multiple of 128"
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int8_grouped(q, row_shards)
        lut = None
    elif fmt in ("w8a8r", "int8r"):
        # per-ROW-scale int8 on the plain XLA dot: one full-k
        # contraction + a rank-1 affine (the standard per-channel int8
        # quantization; scales [1, n])
        q, scales, zeros = quant.int8_quantize(
            w, k, symmetric=symmetric, int_zeros=int_zeros)
        return QuantizedTensor(
            packing.pack_rowscale(q, row_shards),
            scales.T.astype(jnp.float32), zeros.T.astype(jnp.float32),
            None, fmt, k, (n, k), w.dtype, row_shards)
    elif fmt == "any4q8r":
        # any4's learned per-row LUT at WHOLE-ROW grouping, snapped to
        # an int8 grid: reconstruction lut8[c] * s_row + z_row is a
        # plain int8 dot + rank-1 affine, with the one 4-bit-born
        # format whose accuracy survives large groups
        # (BASELINE.md group-size ablation: any4 14.34 at g=1024 vs
        # 13.95 at g=128 while fp4/nf4 blow up to 1e5-1e6)
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=k, scale_only=symmetric, **kwargs)
        lutc = (lut01 - 8.0).astype(jnp.float32)
        sr = jnp.maximum(jnp.max(jnp.abs(lutc), axis=1, keepdims=True),
                         1e-12) / 127.0
        lut8 = jnp.clip(jnp.round(lutc / sr), -127.0,
                        127.0).astype(jnp.int8)
        if lut8.shape[0] == 1:
            lut8 = jnp.broadcast_to(lut8, (n, 16))
            sr = jnp.broadcast_to(sr, (n, 1))
        q8 = jnp.take_along_axis(lut8, codes.astype(jnp.int32), axis=1)
        return QuantizedTensor(
            packing.pack_rowscale(q8, row_shards),
            (scales * sr).T.astype(jnp.float32),
            zeros.T.astype(jnp.float32), None, fmt, k, (n, k), w.dtype,
            row_shards)
    elif fmt in ("any4q8", "any4q8g"):
        # any4 accuracy on the w8a8 path: the learned per-row LUT is
        # snapped to an int8 grid (error <= |lut|_max/254 of the row
        # scale) and the CODES ARE MATERIALIZED as int8 at pack time --
        # recon lut[c]*s + z == lut8[c]*(s*sr) + z, so the row scale
        # folds into the group scales and the runtime is exactly the
        # w8a8 int8-dot path (8 bits/weight instead of 4.25)
        assert group_size % 128 == 0, \
            "any4q8 requires group_size a multiple of 128"
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=group_size, scale_only=symmetric,
            **kwargs)
        lutc = (lut01 - 8.0).astype(jnp.float32)         # [n|1, 16]
        sr = jnp.maximum(jnp.max(jnp.abs(lutc), axis=1, keepdims=True),
                         1e-12) / 127.0                  # [n|1, 1]
        lut8 = jnp.clip(jnp.round(lutc / sr), -127.0,
                        127.0).astype(jnp.int8)
        if lut8.shape[0] == 1:                           # global LUT
            lut8 = jnp.broadcast_to(lut8, (n, 16))
            sr = jnp.broadcast_to(sr, (n, 1))
        q8 = jnp.take_along_axis(lut8, codes.astype(jnp.int32), axis=1)
        if fmt == "any4q8g":
            packed = packing.pack_int8_grouped(q8, row_shards)
        else:
            assert n % 4 == 0, "any4q8 quad packing requires n % 4 == 0"
            packed = packing.pack_int8_quad(q8, row_shards)
        scales = scales * sr                             # fold row scale
        lut = None
    elif fmt == "int4p":
        # pair-packed int4 (two rows per int32 word): identical numbers
        # to fmt="int4", a readable storage layout
        assert group_size % 128 == 0, \
            "int4p requires group_size a multiple of 128"
        codes, scales, zeros = quant.group_quantize(
            w, 4, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int4_pair(codes, row_shards)
        lut = None
    elif fmt == "any4":
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=group_size, scale_only=symmetric,
            **kwargs)
        packed = packing.pack_int4(codes, row_shards)
        lut = (lut01 - 8.0).astype(jnp.float32)  # centered storage
    elif fmt == "any4t":
        # identical NUMBERS to fmt="any4" (same learner, same LUT/codes)
        # in the transposed packing (packing.pack_int4_transposed); LUT
        # stored TRANSPOSED [16, n].
        if group_size % 128 != 0:
            # sub-128 groups have no whole-plane group: row-major packing,
            # same numbers
            return quantize_tensor(w, "any4", group_size,
                                   row_shards=row_shards,
                                   scale_only=symmetric, **kwargs)
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=group_size, scale_only=symmetric,
            **kwargs)
        packed = packing.pack_int4_transposed(codes, row_shards)
        lut = (lut01.T - 8.0).astype(jnp.float32)      # [16, n] centered
    elif fmt in ("nf4", "fp4"):
        codes, scales = quant.lut_quantize(w, fmt, group_size)
        packed = packing.pack_int4(codes, row_shards)
        zeros = jnp.zeros_like(scales)
        lut = jnp.asarray(get_table(fmt))[None, :]
    elif fmt in ("nf4t", "fp4t"):
        # nf4/fp4 numbers in the transposed packing (the any4t layout
        # with the global codebook)
        base = fmt[:-1]
        if group_size % 128 != 0:
            return quantize_tensor(w, base, group_size,
                                   row_shards=row_shards, **kwargs)
        codes, scales = quant.lut_quantize(w, base, group_size)
        packed = packing.pack_int4_transposed(codes, row_shards)
        zeros = jnp.zeros_like(scales)
        lut = jnp.asarray(get_table(base))[None, :].T      # [16, 1]
    elif fmt == "mx4":
        codes, exps = quant.mx4_quantize(w, group_size)
        packed = packing.pack_int4(codes, row_shards)
        scales = quant.mx4_scales(exps)
        zeros = jnp.zeros_like(scales)
        lut = jnp.asarray(get_table("mx4"))[None, :]
    elif fmt == "int8":
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        packed = packing.pack_int8(q, row_shards)
        lut = None
    elif fmt == "int8p":
        # split-byte int8 (never a routed default): each byte
        # u = 16*hi + lo becomes two group-interleaved nibble planes with
        # scales (s, 16*s) -- same numbers as fmt="int8", same bytes
        assert group_size % 128 == 0, \
            "int8p requires group_size a multiple of 128"
        assert row_shards == 1, "int8p does not support row_shards yet"
        assert k % 128 == 0, "int8p requires k a multiple of 128"
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
        u = (q.astype(jnp.int32) + 128).astype(jnp.uint8)
        G = k // 128
        u = u.reshape(n, G, 128)
        c4 = jnp.stack([u & 0xF, u >> 4], axis=2)      # [n, G, 2, 128]
        packed = packing.pack_int4_pair(c4.reshape(n, 2 * k))
        # per-128-lane plane rows on the doubled axis: (lo: s, z-120s),
        # (hi: 16s, 128s) -- derived so a per-plane affine
        # P*sg + sum(x_g)*(zg - 136*sg) sums to (u-128)*s + z exactly
        s128 = jnp.repeat(scales, group_size // 128, axis=1)  # [n, G]
        z128 = jnp.repeat(zeros, group_size // 128, axis=1)
        # constants are per-chunk-uniform so they sum over a group's chunks
        # as coef*sum(x_g); solve z_lo + z_hi - 136 s = z - 128 s
        z_lo = z128 - 120.0 * s128
        z_hi = 128.0 * s128
        s4 = jnp.stack([s128, 16.0 * s128], axis=2).reshape(n, 2 * G)
        z4 = jnp.stack([z_lo, z_hi], axis=2).reshape(n, 2 * G)
        s4, z4 = packing.pad_group_arrays(s4, z4, 2 * k, 128)
        return QuantizedTensor(packed, s4.T.astype(jnp.float32),
                               z4.T.astype(jnp.float32), None, fmt,
                               group_size, (n, k), w.dtype, 1)
    else:
        raise ValueError(f"unsupported fmt {fmt!r}")
    scales, zeros = packing.pad_group_arrays(scales, zeros, k, group_size,
                                             row_shards)
    return QuantizedTensor(packed, scales.T.astype(jnp.float32),
                           zeros.T.astype(jnp.float32), lut, fmt, group_size,
                           (n, k), w.dtype, row_shards)


def dequantize_tensor(qt: QuantizedTensor, dtype=None) -> jax.Array:
    """Reconstruct the dense weight ``[n, k]`` (debug path + prefill path;
    the analog of tinygemm's `tinygemm_dequant_int4`,
    TinyGemmDequantize.cu:19-58)."""
    from dataclasses import replace as _replace
    if qt.fmt in _ROWSCALE_FMTS:
        # [k(_local), n(_local)] int8 + per-row affine; unpadded, so
        # shard-local leaves reconstruct with the same expression
        dtype = dtype or qt.dtype
        s = qt.scales.T          # [n_local, 1]
        z = qt.zeros.T
        return (qt.packed.T.astype(jnp.float32) * s + z).astype(dtype)
    if qt.fmt in _GROUPED_FMTS:
        dtype = dtype or qt.dtype
        n, k = qt.shape
        S = qt.row_shards
        if S > 1:
            shard_groups = packing.padded_k(k // S) // packing.LANES
            if qt.packed.shape[0] == shard_groups:
                # live shard_map leaf: one k-shard, full static metadata
                sub = _replace(qt, shape=(n, k // S), row_shards=1)
                return dequantize_tensor(sub, dtype)
            rowper = qt.scales.shape[0] // S
            parts = []
            for s_ in range(S):
                sub = _replace(
                    qt,
                    packed=qt.packed[s_ * shard_groups:
                                     (s_ + 1) * shard_groups],
                    scales=qt.scales[s_ * rowper:(s_ + 1) * rowper],
                    zeros=qt.zeros[s_ * rowper:(s_ + 1) * rowper],
                    shape=(n, k // S), row_shards=1)
                parts.append(dequantize_tensor(sub, dtype))
            return jnp.concatenate(parts, axis=1)
        n_local = qt.packed.shape[1]
        kp = qt.packed.shape[0] * packing.LANES
        q = packing.unpack_int8_grouped(qt.packed, kp).astype(jnp.float32)
        g = min(qt.group_size, kp)
        scales = jnp.repeat(qt.scales.T, g, axis=1)[:, :kp]
        zeros = jnp.repeat(qt.zeros.T, g, axis=1)[:, :kp]
        w = q * scales + zeros
        return w[:, :min(k, kp)].astype(dtype)
    transposed = qt.fmt in TRANSPOSED_FMTS
    k_axis = 0 if transposed else 1   # packed axis carrying (packed) k
    if qt.row_shards > 1:
        S = qt.row_shards
        n, k = qt.shape
        denom = 1 if qt.fmt in _T_INT8_FMTS else \
            8 if qt.fmt in _NIBBLE_FMTS or transposed else \
            4 if qt.fmt == "int4p" else 2 if qt.fmt == "w4a8" else 1
        shard_words = packing.padded_k(k // S) // denom
        if qt.packed.shape[k_axis] == shard_words:
            # live leaf holds ONE k-shard (inside shard_map the static
            # metadata still describes the full logical tensor): dequantize
            # it as a standalone single-shard weight
            sub = _replace(qt, shape=(n, k // S), row_shards=1)
            return dequantize_tensor(sub, dtype)
        wordper = qt.packed.shape[k_axis] // S
        rowper = qt.scales.shape[0] // S
        parts = []
        for s_ in range(S):
            pk = (qt.packed[s_ * wordper:(s_ + 1) * wordper] if transposed
                  else qt.packed[:, s_ * wordper:(s_ + 1) * wordper])
            sub = _replace(
                qt,
                packed=pk,
                scales=qt.scales[s_ * rowper:(s_ + 1) * rowper],
                zeros=qt.zeros[s_ * rowper:(s_ + 1) * rowper],
                shape=(n, k // S), row_shards=1)
            parts.append(dequantize_tensor(sub, dtype))
        return jnp.concatenate(parts, axis=1)
    n, k = qt.shape
    dtype = dtype or qt.dtype
    kp = qt.packed.shape[k_axis] * (
        1 if qt.fmt in _T_INT8_FMTS else
        8 if qt.fmt in _NIBBLE_FMTS or transposed else
        4 if qt.fmt in ("int4p", "int8p") else
        2 if qt.fmt == "w4a8" else 1)
    g = qt.group_size
    if qt.fmt == "int8p":
        # split-byte layout: de-interleave nibble planes, reassemble bytes
        # and recover the original (s, z) from the plane-transformed rows
        c4 = packing.unpack_int4_pair(qt.packed, kp).astype(jnp.int32)
        Gp = kp // 256
        c4 = c4.reshape(n, Gp, 2, 128)
        u = c4[:, :, 0] + 16 * c4[:, :, 1]            # [n, Gp, 128]
        q = (u - 128).astype(jnp.float32).reshape(n, Gp * 128)
        s128 = qt.scales[0::2].T                      # [n, Gp] (s rows)
        z128 = qt.zeros[0::2].T + 120.0 * s128        # z_lo = z - 120 s
        w = q * jnp.repeat(s128, 128, axis=1) \
            + jnp.repeat(z128, 128, axis=1)
        return w[:, :k].astype(dtype)
    if qt.fmt in ("int8", "w8a8"):
        q = qt.packed.astype(jnp.float32)
    elif qt.fmt in _T_INT8_FMTS:
        q = qt.packed.T.astype(jnp.float32)       # [n, kp]
    elif qt.fmt in _QUAD8_FMTS:
        q = packing.unpack_int8_quad(qt.packed, kp).astype(jnp.float32)
    else:
        if qt.fmt == "int4p":
            codes = packing.unpack_int4_pair(qt.packed, kp).astype(jnp.int32)
        elif qt.fmt == "w4a8":
            codes = packing.unpack_int4_quad(qt.packed, kp).astype(jnp.int32)
        elif transposed:
            codes = packing.unpack_int4_transposed(
                qt.packed, kp).astype(jnp.int32)
        else:
            codes = packing.unpack_int4(qt.packed, kp).astype(jnp.int32)
        if qt.fmt in ("int4", "int4p", "w4a8"):
            q = (codes - 8).astype(jnp.float32)
        else:
            # LUT lookup as 16 compare-selects, an elementwise chain XLA
            # fuses with the unpack and the affine; bit-exact with a gather
            lut = qt.lut.astype(jnp.float32)
            if transposed:          # any4t stores the LUT as [16, n]
                lut = lut.T if lut.shape[1] == n else \
                    jnp.broadcast_to(lut.T, (n, 16))
            elif lut.shape[0] == 1:  # global table (nf4/fp4/mx4/global-any4)
                lut = jnp.broadcast_to(lut, (n, 16))
            q = jnp.zeros(codes.shape, jnp.float32)
            for c in range(16):
                q = q + jnp.where(codes == c, lut[:, c:c + 1], 0.0)
    scales = jnp.repeat(qt.scales.T, g, axis=1)[:, :kp]
    zeros = jnp.repeat(qt.zeros.T, g, axis=1)[:, :kp]
    w = q * scales + zeros
    return w[:, :k].astype(dtype)


# formats a quantized *embedding table* may use: the row gather needs one
# logical row per packed row (int4p/w4a8 interleave 2/4 rows per int32
# word; int8p splits bytes across group-interleaved planes)
EMBED_FMTS = _NIBBLE_FMTS + ("int8", "w8a8")


def embedding_lookup(qt: QuantizedTensor, ids: jax.Array) -> jax.Array:
    """Gather + dequantize rows of a quantized embedding table.

    The reference never quantizes embeddings (its tinygemm is a linear-
    layer kernel); a quantized *tied* embedding pays twice: the
    lm_head matmul reads half (w8a8) or a quarter (4-bit) of the bf16
    bytes at decode, and the token lookup is a cheap row gather + affine
    over ``[batch, k]`` -- so the big vocab table stops being the largest
    bf16 buffer in a quantized checkpoint. Rows are gathered from the
    packed codes and reconstructed exactly like
    :func:`dequantize_tensor` on the sub-table.
    """
    assert qt.row_shards == 1, "embedding tables are not row-sharded"
    assert qt.fmt in EMBED_FMTS, \
        f"embedding lookup needs row-gatherable packing; fmt {qt.fmt!r} " \
        f"packs multiple rows per word (use one of {EMBED_FMTS})"
    n, k = qt.shape
    flat = ids.reshape(-1)
    sub = replace(
        qt,
        packed=jnp.take(qt.packed, flat, axis=0),
        scales=jnp.take(qt.scales, flat, axis=1),
        zeros=jnp.take(qt.zeros, flat, axis=1),
        lut=(jnp.take(qt.lut, flat, axis=0)
             if qt.lut is not None and qt.lut.shape[0] == n else qt.lut),
        shape=(int(flat.shape[0]), k))
    w = dequantize_tensor(sub)
    return w.reshape(*ids.shape, k)


def embed(w, ids: jax.Array, dtype=None) -> jax.Array:
    """Token-embedding lookup over a dense or quantized table."""
    if isinstance(w, QuantizedTensor):
        x = embedding_lookup(w, ids)
    else:
        x = jnp.take(w, ids, axis=0)
    return x if dtype is None else x.astype(dtype)


def quantize_activations(x: jax.Array, eps: float = ACT_EPS):
    """Per-row absmax int8 activation quantization for the int8-activation
    formats (w4a8/w8a8/any4q8): ``x ~= xq * sx`` with ``xq`` int8 in
    [-127, 127] and ``sx = absmax/127`` per leading row. Under row-parallel
    TP each shard quantizes its local k-slice independently (a
    finer-grained, equally valid activation grouping -- each shard's
    partial is scaled by its own ``sx`` before the psum).
    Returns ``(xq int8, sx f32[..., 1])``."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                     eps) / ACT_QMAX
    xq = jnp.clip(jnp.round(xf / sx), -ACT_QMAX,
                  ACT_QMAX).astype(jnp.int8)
    return xq, sx


def _xla_rowscale_linear(x: jax.Array, w: QuantizedTensor) -> jax.Array:
    """Per-row-scale int8 linear on the plain XLA dot (w8a8r/int8r/
    any4q8r): ``y = (x . W8) * s_n + sum(x) * z_n`` -- one full-k
    contraction plus a rank-1 affine. Works at every m (no per-group
    partials to materialize). The weight is stored ``[k, n]`` so the
    contraction is in natural orientation."""
    packed, s, z = w.packed, w.scales, w.zeros       # [k_l, n_l], [1, n_l]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n_local = packed.shape[1]
    if w.fmt == "int8r":
        P = jax.lax.dot_general(
            x2.astype(jnp.bfloat16), packed.astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        xs = jnp.sum(x2.astype(jnp.float32), axis=1, keepdims=True)
        y = P * s + xs * z
    else:
        xq, sx = quantize_activations(x2)
        P = jax.lax.dot_general(
            xq, packed, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32).astype(jnp.float32)
        xs = jnp.sum(xq.astype(jnp.int32), axis=1,
                     keepdims=True).astype(jnp.float32)
        y = (P * s + xs * z) * sx
    return y.reshape(*lead, n_local).astype(x.dtype)


def _grouped_codes(w: QuantizedTensor) -> jax.Array:
    """Centered int8 codes of an int8-activation or grouped weight as
    ``[kp/128, n, 128]`` (the grouped layout; other layouts unpack)."""
    if w.fmt in _GROUPED_FMTS:
        return w.packed
    if w.fmt == "w4a8":
        kp = w.packed.shape[1] * 2
        q = (packing.unpack_int4_quad(w.packed, kp).astype(jnp.int8)
             - jnp.int8(8))
    elif w.fmt in _QUAD8_FMTS:
        q = packing.unpack_int8_quad(w.packed, w.packed.shape[1])
    elif w.fmt in _T_INT8_FMTS:
        q = w.packed.T
    else:                                             # row-major w8a8
        q = w.packed
    n, kp = q.shape
    return q.reshape(n, kp // packing.LANES, packing.LANES).transpose(1, 0, 2)


def _xla_grouped_linear(x: jax.Array, w: QuantizedTensor) -> jax.Array:
    """Grouped int8 linear on the batched XLA dot (the int8-activation
    formats and int8g): codes [G, n, 128], one int8 dot_general ->
    [G, m, n] int32 partials, the per-group affine folded by two small
    einsums -- exact integer dots, one f32 affine per group. Callers bound
    m at _XLA_GROUPED_M_MAX (the partial tensor scales with m)."""
    codes = _grouped_codes(w)                         # [G, n_l, 128]
    G, n_local = codes.shape[0], codes.shape[1]
    kp = G * packing.LANES
    xa = _shard_align_x(x, w)
    lead = xa.shape[:-1]
    x2 = xa.reshape(-1, xa.shape[-1])
    if x2.shape[1] != kp:
        x2 = jnp.pad(x2, ((0, 0), (0, kp - x2.shape[1])))
    m = x2.shape[0]
    s, z = w.scales, w.zeros                          # [kp/g, n_l]
    rep = G // s.shape[0]
    if rep > 1:                                       # g > 128
        s = jnp.repeat(s, rep, axis=0)
        z = jnp.repeat(z, rep, axis=0)
    if w.fmt == "int8g":
        xb = x2.astype(jnp.bfloat16).reshape(m, G, 128).transpose(1, 0, 2)
        P = jax.lax.dot_general(
            xb, codes.astype(jnp.bfloat16), (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        xs = jnp.sum(xb.astype(jnp.float32), axis=2)
        y = jnp.einsum("gmn,gn->mn", P, s) + jnp.einsum("gm,gn->mn", xs, z)
    else:
        xq, sx = quantize_activations(x2)
        xb = xq.reshape(m, G, 128).transpose(1, 0, 2)
        P = jax.lax.dot_general(
            xb, codes, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)
        xs = jnp.sum(xb.astype(jnp.int32), axis=2).astype(jnp.float32)
        y = jnp.einsum("gmn,gn->mn", P.astype(jnp.float32), s) \
            + jnp.einsum("gm,gn->mn", xs, z)
        y = y * sx
    return y.reshape(*lead, n_local).astype(x.dtype)


def _shard_align_x(x: jax.Array, w: QuantizedTensor) -> jax.Array:
    """Align activations to a multi-shard weight's per-shard k padding.

    A weight packed with ``row_shards=S`` holds S independently padded
    k-segments; when executing UNsharded (the live leaf carries all S
    segments) the activation k-axis must be split at logical shard
    boundaries and zero-padded per segment to match. Inside shard_map the
    live leaf is a single segment and x is the local k-slice: no-op.
    """
    S = w.row_shards
    if S > 1 and x.shape[-1] == w.shape[1]:
        kl = w.shape[1] // S
        kps = packing.padded_k(kl)
        xs = x.reshape(*x.shape[:-1], S, kl)
        xs = jnp.pad(xs, [(0, 0)] * (xs.ndim - 1) + [(0, kps - kl)])
        return xs.reshape(*x.shape[:-1], S * kps)
    return x


def _platform() -> str:
    """The backend quantized linears run on: "gpu" (the lookup GEMV
    kernel) or "cpu" (XLA formulations only). Anything else raises."""
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise NotImplementedError(
            f"quantized linear has no path for platform {platform!r}")
    return platform


def lut_kernel_applies(w: QuantizedTensor, m: int,
                       interpret: bool = False) -> bool:
    """Does :func:`linear` run ``w`` at ``m`` activation rows through the
    lookup GEMV kernel? On the GPU for the row-planar 4-bit formats at
    decode-shaped m; on the CPU only in interpret mode."""
    if _platform() == "cpu" and not interpret:
        return False
    kp = w.packed.shape[1] * packing.PLANES
    return (w.fmt in gemv.FMTS and m <= gemv.M_MAX
            and gemv.supports(w.group_size, kp))


def _kernel_table(w: QuantizedTensor) -> jax.Array:
    """The 16-entry table(s) the kernel looks codes up in."""
    if w.fmt == "int4":
        return jnp.asarray(gemv.INT4_RAMP, jnp.float32)[None, :]
    return w.lut


def linear(x: jax.Array, w, bias: Optional[jax.Array] = None, *,
           interpret: bool = False) -> jax.Array:
    """``y = x @ W^T + bias`` where ``w`` is dense or a QuantizedTensor.

    ``interpret=True`` runs the lookup GEMV kernel in Pallas interpret
    mode (tests on the CPU)."""
    if not isinstance(w, QuantizedTensor):
        y = jnp.einsum("...k,nk->...n", x, w.astype(x.dtype))
    else:
        m = 1
        for d in x.shape[:-1]:
            m *= d
        if w.fmt in _ROWSCALE_FMTS:
            y = _xla_rowscale_linear(x, w)
        elif (w.fmt in _A8_FMTS or w.fmt == "int8g") \
                and m <= _XLA_GROUPED_M_MAX:
            y = _xla_grouped_linear(x, w)
        elif lut_kernel_applies(w, m, interpret):
            # n from the live array, not static metadata: inside shard_map
            # the leaves are local shards while .shape still describes the
            # full logical tensor
            y = gemv.lut_gemv(_shard_align_x(x, w), w.packed, w.scales,
                              w.zeros, _kernel_table(w),
                              group_size=w.group_size, interpret=interpret)
        else:
            # prefill-shaped m, the weight-only int8 layouts and the
            # storage-only 4-bit layouts (any4t/int4p/...): XLA's dot over
            # the reconstructed weight
            wd = dequantize_tensor(w, dtype=x.dtype)
            y = jnp.einsum("...k,nk->...n", x, wd)
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y
