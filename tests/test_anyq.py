"""any4 algorithm tests (model: reference tests/test_anyq.py:31-108)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.ops import quant
from any4.quant import anyq


def _lut_weights(rng, n, k, group_size):
    """Rows built from 16 per-row values so any4 can be exact: each group is
    an affine image of the same per-row 16-value set (so group-normalized
    values collapse to 16 distinct points)."""
    base = np.sort(rng.rand(n, 16), axis=1)  # in [0, 1]
    base[:, 0] = 0.0
    base[:, -1] = 1.0
    idx = rng.randint(0, 16, (n, k))
    unit = np.take_along_axis(base, idx, axis=1)  # in [0,1], hits 0 and 1
    g = k // group_size
    scale = rng.rand(n, g)[:, :, None] + 0.5
    shift = rng.randn(n, g)[:, :, None]
    w = unit.reshape(n, g, group_size) * scale + shift
    return w.reshape(n, k)


class TestAny4Quantize:
    def test_exact_on_lut_structured_weights(self):
        rng = np.random.RandomState(0)
        w = jnp.asarray(_lut_weights(rng, 8, 512, 128), dtype=jnp.float32)
        rec = anyq.any4_reconstruct(w, group_size=128, kmeans_iters=50)
        np.testing.assert_allclose(np.asarray(rec), np.asarray(w), atol=1e-4)

    def test_better_than_int4_on_gaussian(self):
        w = jax.random.normal(jax.random.PRNGKey(0), (32, 512))
        rec_any4 = anyq.any4_reconstruct(w, group_size=128, kmeans_iters=30)
        codes, s, z = quant.group_quantize(w, 4, 128)
        rec_int4 = quant.group_dequantize(codes, s, z, 4, 128)
        e_any4 = float(((rec_any4 - w) ** 2).mean())
        e_int4 = float(((rec_int4 - w) ** 2).mean())
        assert e_any4 < e_int4

    def test_outputs_shapes_and_ranges(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (8, 256))
        codes, lut, scales, zeros = anyq.any4_quantize(w, group_size=128)
        assert codes.shape == (8, 256) and codes.dtype == jnp.uint8
        assert lut.shape == (8, 16)
        assert scales.shape == (8, 2) and zeros.shape == (8, 2)
        assert int(codes.max()) <= 15
        # LUT lives in the group-normalized [0, 15] domain
        assert float(lut.min()) > -1.0 and float(lut.max()) < 16.5

    def test_global_lut(self):
        w = jax.random.normal(jax.random.PRNGKey(2), (8, 256))
        codes, lut, scales, zeros = anyq.any4_quantize(
            w, group_size=128, per_row=False)
        assert lut.shape == (1, 16)
        assert codes.shape == (8, 256)
        rec = quant.anyq_dequantize(codes, lut[0], scales, zeros,
                                    group_size=128)
        assert float(((rec - w) ** 2).mean()) < 0.1

    def test_keep_outliers(self):
        w = jax.random.normal(jax.random.PRNGKey(3), (4, 256))
        codes, lut, scales, zeros = anyq.any4_quantize(
            w, group_size=128, keep_outliers=True, kmeans_iters=20)
        wg, _, _ = quant.group_codes_float(w, 4, 128)
        np.testing.assert_allclose(np.asarray(lut[:, -1]),
                                   np.asarray(wg.max(axis=1)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(lut[:, 0]),
                                   np.asarray(wg.min(axis=1)), atol=1e-5)

    def test_sample_weight_improves_weighted_error(self):
        # columns with large activations should be better represented when
        # passed as sample_weight (the activation-aware objective,
        # README.md:400-407)
        k = 512
        w = jax.random.normal(jax.random.PRNGKey(4), (16, k))
        act = jnp.ones((k,)).at[:8].set(100.0)
        rec_w = anyq.any4_reconstruct(w, group_size=128, sample_weight=act,
                                      kmeans_iters=30)
        rec_u = anyq.any4_reconstruct(w, group_size=128, kmeans_iters=30)
        err_w = float((((rec_w - w) * act[None, :]) ** 2).mean())
        err_u = float((((rec_u - w) * act[None, :]) ** 2).mean())
        assert err_w <= err_u

    def test_bias_pow_runs(self):
        w = jax.random.normal(jax.random.PRNGKey(5), (4, 256))
        rec = anyq.any4_reconstruct(w, group_size=128, bias_pow=2.0,
                                    kmeans_iters=20)
        assert float(((rec - w) ** 2).mean()) < 0.1

    def test_scale_only_symmetric_grouping(self):
        """scale_only=True clusters over symmetric group codes
        (reference anyq_quantize_tensor assymetric=not scale_only,
        quantize.py:542-545): zeros are exactly 0 and the quantized
        linear still reconstructs well."""
        import numpy as np
        from any4.ops import linear as lin
        w = jax.random.normal(jax.random.PRNGKey(6), (16, 256))
        qt = lin.quantize_tensor(w, "any4", group_size=128,
                                 scale_only=True, kmeans_iters=20)
        np.testing.assert_array_equal(np.asarray(qt.zeros), 0.0)
        rec = lin.dequantize_tensor(qt, dtype=jnp.float32)
        assert float(((rec - w) ** 2).mean()) < 0.05
