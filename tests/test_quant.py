"""Core group-quantization math tests.

Mirrors the reference's exactness-property strategy (tests/test_intq.py:29-46,
tests/test_anyq.py:31-49): construct weights from exactly 2^n_bit values per
group so quantize->dequantize is bit-exact, plus identity-survival and MX4
semantics checks (tests/tinygemm/test_tinygemm_mx4.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.ops import formats, quant


def _grid_weights(key, n, k, n_bit, group_size):
    """Weights whose every group holds values from a 2^n_bit-point linspace
    spanning the full group range (so uniform grouped quantization is exact;
    each group is forced to contain both extreme levels, as in reference
    test_intq.py:36-46)."""
    levels = 2**n_bit
    kq = jax.random.randint(key, (n, k), 0, levels)
    kq = kq.reshape(n, k // group_size, group_size)
    kq = kq.at[:, :, 0].set(0).at[:, :, 1].set(levels - 1)
    kq = kq.reshape(n, k)
    lo, hi = -1.0, 1.0
    vals = lo + (hi - lo) * kq.astype(jnp.float32) / (levels - 1)
    return vals


class TestGroupQuant:
    @pytest.mark.parametrize("n_bit", [4, 8])
    @pytest.mark.parametrize("group_size", [32, 128])
    def test_exact_on_grid(self, n_bit, group_size):
        w = _grid_weights(jax.random.PRNGKey(0), 16, 256, n_bit, group_size)
        codes, scales, zeros = quant.group_quantize(w, n_bit, group_size)
        w2 = quant.group_dequantize(codes, scales, zeros, n_bit, group_size)
        np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)

    def test_identity_matrix_exact(self):
        # the identity survives int4 grouping exactly (reference
        # test_tinygemm_any4.py:117-139 relies on this)
        k = 256
        w = jnp.eye(k, dtype=jnp.float32)
        codes, scales, zeros = quant.group_quantize(w, 4, 128)
        w2 = quant.group_dequantize(codes, scales, zeros, 4, 128)
        np.testing.assert_array_equal(np.asarray(w2), np.asarray(w))

    def test_code_range_and_shapes(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (8, 256))
        codes, scales, zeros = quant.group_quantize(w, 4, 64)
        assert codes.shape == (8, 256) and codes.dtype == jnp.uint8
        assert scales.shape == (8, 4) and zeros.shape == (8, 4)
        assert int(codes.max()) <= 15 and int(codes.min()) >= 0

    def test_zeros_semantics(self):
        # zeros = min + scale * 2^(n-1): a code of 8 reconstructs the zero
        # point, code 0 reconstructs min (reference utils.py:43-46)
        w = jax.random.normal(jax.random.PRNGKey(2), (4, 128))
        codes, scales, zeros = quant.group_quantize(w, 4, 128)
        rec_min = quant.group_dequantize(
            jnp.zeros_like(codes), scales, zeros, 4, 128)
        np.testing.assert_allclose(np.asarray(rec_min)[:, 0],
                                   np.asarray(w.min(axis=1)), rtol=1e-5)

    @pytest.mark.parametrize("n_bit", [4, 8])
    def test_symmetric_scale_only(self, n_bit):
        # symmetric=True is the reference's scale_only branch
        # (quantize.py:133-141): zeros==0, scales=absmax/(2^(n-1)-1), and
        # values on the symmetric grid reconstruct exactly
        half = 2 ** (n_bit - 1)
        g = 64
        key = jax.random.PRNGKey(3)
        q = jax.random.randint(key, (8, 256), -(half - 1), half)
        # pin each group's absmax so the symmetric grid is exact
        q = q.reshape(8, 256 // g, g).at[:, :, 0].set(half - 1).reshape(8, 256)
        w = q.astype(jnp.float32) * 0.01
        codes, scales, zeros = quant.group_quantize(
            w, n_bit, g, symmetric=True)
        np.testing.assert_array_equal(np.asarray(zeros), 0.0)
        w2 = quant.group_dequantize(codes, scales, zeros, n_bit, g)
        np.testing.assert_allclose(np.asarray(w2), np.asarray(w),
                                   rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("n_bit", [4, 8])
    def test_int_zeros_group_q1_semantics(self, n_bit):
        # int_zeros=True is the reference's new_grouping/group_q1 variant
        # (quantize.py:267-314): zq = clip(round(-min/s), 0, 2^n-1),
        # codes = clip(round(w/s) + zq), recon = (code - zq) * s. Verify
        # against a direct transcription of that formula.
        g = 64
        w = jax.random.normal(jax.random.PRNGKey(5), (8, 256))
        codes, scales, zeros = quant.group_quantize(
            w, n_bit, g, int_zeros=True)
        wg = np.asarray(w, np.float64).reshape(8, 256 // g, g)
        max_int = 2**n_bit - 1
        s = np.maximum(wg.max(-1) - wg.min(-1), 1e-6) / max_int
        zq = np.clip(np.round(-wg.min(-1) / s), 0, max_int)
        ref_codes = np.clip(
            np.round(wg / s[..., None]) + zq[..., None], 0, max_int)
        np.testing.assert_array_equal(
            np.asarray(codes).reshape(8, 256 // g, g), ref_codes)
        # zeros fold the integer zero-point into the standard convention:
        # (code - 2^(n-1)) * s + zeros == (code - zq) * s
        rec = quant.group_dequantize(codes, scales, zeros, n_bit, g)
        ref_rec = (ref_codes - zq[..., None]) * s[..., None]
        np.testing.assert_allclose(np.asarray(rec, np.float64),
                                   ref_rec.reshape(8, 256), rtol=1e-5,
                                   atol=1e-6)

    def test_int_zeros_flows_through_quantize_tensor(self):
        from any4.ops import linear as lin
        w = np.asarray(
            jax.random.normal(jax.random.PRNGKey(6), (16, 256)))
        qt = lin.quantize_tensor(w, "int4", group_size=128, int_zeros=True)
        # every zero must be an integer multiple of its scale away from
        # the standard half-range offset: zeros = (8 - zq) * s, zq integer
        nrows = w.shape[1] // 128  # valid (unpadded) scale rows
        ratio = (np.asarray(qt.zeros)[:nrows]
                 / np.asarray(qt.scales)[:nrows])
        np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-4)
        wd = lin.dequantize_tensor(qt, dtype=jnp.float32)
        assert float(jnp.abs(wd - w).max()) < 0.5  # sane reconstruction
        with pytest.raises(AssertionError):
            lin.quantize_tensor(w, "any4", group_size=128, int_zeros=True)

    def test_scale_only_flows_through_quantize_tensor(self):
        from any4.ops import linear as lin
        w = jax.random.normal(jax.random.PRNGKey(4), (16, 256))
        qt = lin.quantize_tensor(w, "int4", group_size=128, scale_only=True)
        np.testing.assert_array_equal(np.asarray(qt.zeros), 0.0)
        with pytest.raises(AssertionError):
            lin.quantize_tensor(w, "nf4", group_size=128, scale_only=True)

    def test_scales_and_zeros_roundtrip(self):
        w = jax.random.normal(jax.random.PRNGKey(3), (8, 256))
        _, scales, zeros = quant.group_quantize(w, 4, 128)
        sz = quant.pack_scales_and_zeros(scales, zeros)
        assert sz.shape == (2, 8, 2)  # [k/g, n, 2] reference layout
        s2, z2 = quant.unpack_scales_and_zeros(sz)
        np.testing.assert_array_equal(np.asarray(s2), np.asarray(scales))
        np.testing.assert_array_equal(np.asarray(z2), np.asarray(zeros))


class TestLutQuant:
    @pytest.mark.parametrize("fmt", ["nf4", "fp4"])
    def test_exact_on_table_values(self, fmt):
        table = formats.get_table(fmt)
        key = jax.random.PRNGKey(0)
        idx = jax.random.randint(key, (4, 128), 0, 16)
        scale = 3.7
        w = jnp.asarray(table)[idx] * scale
        codes, scales = quant.lut_quantize(w, fmt, group_size=128)
        w2 = quant.lut_dequantize(codes, scales, fmt, group_size=128)
        np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-6)

    def test_nf4_absmax_scaling(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (4, 256)) * 5
        codes, scales = quant.lut_quantize(w, "nf4", group_size=64)
        np.testing.assert_allclose(
            np.asarray(scales),
            np.abs(np.asarray(w).reshape(4, 4, 64)).max(-1), rtol=1e-6)
        w2 = quant.lut_dequantize(codes, scales, "nf4", group_size=64)
        # error bounded by half the largest table gap times the scale
        assert float(jnp.abs(w2 - w).max()) < 0.3 * float(scales.max())


class TestMx4:
    def test_roundtrip_exact_on_mx4_values(self):
        # values of the form table[i] * 2^e are represented exactly
        table = formats.FP4_E2M1_TABLE
        idx = np.random.RandomState(0).randint(0, 16, size=(4, 64))
        w = jnp.asarray(table[idx] * 4.0)  # shared exponent 2
        codes, exps = quant.mx4_quantize(w, group_size=32)
        w2 = quant.mx4_dequantize(codes, exps, group_size=32)
        np.testing.assert_array_equal(np.asarray(w2), np.asarray(w))

    def test_exponent_routing(self):
        # rows with different magnitudes get different shared exponents
        # (reference test_tinygemm_mx4.py varies exponent per row)
        base = jnp.asarray(formats.FP4_E2M1_TABLE[np.random.RandomState(1)
                                                  .randint(1, 8, (4, 32))])
        w = base * (2.0 ** jnp.arange(4)[:, None])
        codes, exps = quant.mx4_quantize(w, group_size=32)
        e = np.asarray(exps).astype(np.int32) - 127
        assert (np.diff(e[:, 0]) == 1).all()
        w2 = quant.mx4_dequantize(codes, exps, group_size=32)
        np.testing.assert_allclose(np.asarray(w2), np.asarray(w), rtol=1e-6)

    def test_signed_zero_codes(self):
        w = jnp.asarray([[0.0, -0.0, 1.0, -1.0] * 8])
        codes, exps = quant.mx4_quantize(w, group_size=32)
        c = np.asarray(codes)[0]
        assert c[0] == 0 and c[1] == 8  # +0 -> 0, -0 -> 8

    def test_general_error_bound(self):
        w = jax.random.normal(jax.random.PRNGKey(5), (8, 256))
        codes, exps = quant.mx4_quantize(w, group_size=32)
        w2 = quant.mx4_dequantize(codes, exps, group_size=32)
        # e2m1 relative step within a group is coarse; check loose bound
        assert float(jnp.abs(w2 - w).max()) < float(jnp.abs(w).max())


class TestInt8:
    def test_roundtrip_close(self):
        w = jax.random.normal(jax.random.PRNGKey(7), (8, 256))
        q, scales, zeros = quant.int8_quantize(w, group_size=128)
        assert q.dtype == jnp.int8
        w2 = quant.int8_dequantize(q, scales, zeros, group_size=128)
        assert float(jnp.abs(w2 - w).max()) < 2e-2


class TestAnyqDequant:
    def test_per_row_lut_gather(self):
        n, k, g = 4, 256, 128
        lut = jnp.tile(jnp.arange(16, dtype=jnp.float32)[None], (n, 1)) * \
            jnp.arange(1, n + 1, dtype=jnp.float32)[:, None]
        codes = jax.random.randint(jax.random.PRNGKey(0), (n, k), 0, 16)
        scales = jnp.ones((n, k // g))
        zeros = jnp.zeros((n, k // g))
        w = quant.anyq_dequantize(codes.astype(jnp.uint8), lut, scales, zeros)
        expect = (np.take_along_axis(np.asarray(lut), np.asarray(codes), 1)
                  - 8.0)
        np.testing.assert_allclose(np.asarray(w), expect, atol=1e-6)

    def test_centered_matches_uncentered(self):
        n, k = 4, 256
        lut = jax.random.uniform(jax.random.PRNGKey(1), (n, 16)) * 15
        codes = jax.random.randint(
            jax.random.PRNGKey(2), (n, k), 0, 16).astype(jnp.uint8)
        scales = jax.random.uniform(jax.random.PRNGKey(3), (n, 2)) + 0.5
        zeros = jax.random.normal(jax.random.PRNGKey(4), (n, 2))
        a = quant.anyq_dequantize(codes, lut, scales, zeros, centered=False)
        b = quant.anyq_dequantize(codes, lut - 8.0, scales, zeros,
                                  centered=True)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
