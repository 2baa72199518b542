"""Vectorized k-means tests (model: reference tests/test_kmeans.py:17-141)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.quant import kmeans


class TestKmeansRows:
    def test_exact_when_clusters_equal_distinct_values(self):
        # when each row has exactly n_clusters distinct values, k-means must
        # recover them exactly (reference test_kmeans.py:83-91)
        rng = np.random.RandomState(0)
        vals = np.sort(rng.randn(4, 16), axis=1)
        idx = rng.randint(0, 16, (4, 512))
        x = np.take_along_axis(vals, idx, axis=1)
        cents, assign = kmeans.kmeans_rows(jnp.asarray(x), 16, iters=50)
        recon = np.take_along_axis(np.asarray(cents), np.asarray(assign), 1)
        np.testing.assert_allclose(recon, x, atol=1e-5)

    def test_centroids_sorted(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (8, 256))
        cents, assign = kmeans.kmeans_rows(x, 16, iters=10)
        c = np.asarray(cents)
        assert (np.diff(c, axis=1) >= 0).all()
        recon = np.take_along_axis(c, np.asarray(assign), 1)
        # reconstruction assigns each point to its nearest centroid
        d_direct = np.abs(np.asarray(x) - recon)
        d_all = np.abs(np.asarray(x)[:, :, None] - c[:, None, :]).min(2)
        np.testing.assert_allclose(d_direct, d_all, atol=1e-6)

    @pytest.mark.parametrize("init", ["int", "nf4", "random", "k-means++",
                                      "pow", "manual_random"])
    def test_inits_converge(self, init):
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 512))
        cents, assign = kmeans.kmeans_rows(x, 16, init=init, iters=25)
        recon = np.take_along_axis(np.asarray(cents), np.asarray(assign), 1)
        mse = ((recon - np.asarray(x)) ** 2).mean()
        # 16 clusters over 512 gaussian samples: quantization error well
        # under the variance
        assert mse < 0.02

    def test_sample_weight_pulls_centroids(self):
        # one heavily-weighted outlier must become (nearly) its own centroid
        x = np.concatenate([np.linspace(-1, 1, 255), [25.0]])[None, :]
        w = np.ones_like(x)
        w[0, -1] = 1e4
        cents, assign = kmeans.kmeans_rows(
            jnp.asarray(x), 16, sample_weight=jnp.asarray(w[0]), iters=50)
        assert abs(float(np.asarray(cents).max()) - 25.0) < 1e-3

    def test_row_chunking_matches_unchunked(self):
        x = jax.random.normal(jax.random.PRNGKey(2), (96, 128))
        c1, a1 = kmeans.kmeans_rows(x, 16, init="int", iters=20, row_chunk=32)
        c2, a2 = kmeans.kmeans_rows(x, 16, init="int", iters=20, row_chunk=96)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-5)


class TestBuildSampleWeight:
    def test_none(self):
        assert kmeans.build_sample_weight(np.ones(8), None) is None

    def test_array_passthrough(self):
        w = np.arange(8.0) - 4
        out = kmeans.build_sample_weight(np.ones(8), w)
        np.testing.assert_array_equal(out, np.abs(w))

    def test_outlier_spec(self):
        x = np.array([0.0, 1.0, 2.0, 3.0, 10.0, -5.0])
        w = kmeans.build_sample_weight(x, "outlier_3.0")
        assert w[4] == 3.0 and w[5] == 3.0
        assert (w[[0, 1, 2, 3]] == 1.0).all()

    def test_outlier_spec_num(self):
        x = np.arange(10.0)
        w = kmeans.build_sample_weight(x, "outlier_2.5_2")
        assert (w[[0, 1, 8, 9]] == 2.5).all()
        assert (w[2:8] == 1.0).all()

    def test_gradual_spec(self):
        x = np.linspace(-1, 1, 11)
        w = kmeans.build_sample_weight(x, "gradual_5.0_1.0_pow2")
        assert abs(w[0] - 5.0) < 1e-9 and abs(w[-1] - 5.0) < 1e-9
        assert abs(w[5] - 1.0) < 1e-9

    def test_bad_spec_raises(self):
        import pytest as _pytest
        with _pytest.raises(ValueError):
            kmeans.build_sample_weight(np.ones(4), "bogus_spec")


class TestNInitRestarts:
    def test_n_init_never_worse(self):
        import jax as _jax
        import jax.numpy as _jnp
        x = _jax.random.normal(_jax.random.PRNGKey(3), (8, 256))
        c1, a1 = kmeans.kmeans_rows(x, 16, iters=8, n_init=1)
        c4, a4 = kmeans.kmeans_rows(x, 16, iters=8, n_init=4)
        def inertia(c, a):
            vals = np.take_along_axis(np.asarray(c), np.asarray(a), 1)
            return ((np.asarray(x) - vals) ** 2).sum(1)
        assert (inertia(c4, a4) <= inertia(c1, a1) + 1e-5).all()
