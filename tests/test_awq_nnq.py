"""AWQ pre-quantization and nnq LUT-refinement tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.models import llama
from any4.ops import quant
from any4.quant import anyq, awq, nnq


class TestAwqPrimitives:
    def test_scale_search_preserves_fp_output(self):
        # scaling is exactly neutral in fp: x @ W^T == (x/s) @ (W*s)^T
        key = jax.random.PRNGKey(0)
        x = jax.random.normal(key, (64, 128))
        w = jax.random.normal(jax.random.PRNGKey(1), (32, 128))
        s, ratio = awq.search_scale(x, [w], n_grid=8, group_size=32)
        assert s.shape == (128,)
        y0 = x @ w.T
        y1 = (x / s[None, :]) @ (w * s[None, :]).T
        np.testing.assert_allclose(np.asarray(y0), np.asarray(y1),
                                   rtol=1e-4, atol=1e-4)

    def test_scale_search_helps_outlier_channels(self):
        # a channel with huge activations should get scale > 1 and reduce
        # quantized output error
        key = jax.random.PRNGKey(2)
        x = jax.random.normal(key, (128, 64))
        x = x.at[:, 0].mul(50.0)
        w = jax.random.normal(jax.random.PRNGKey(3), (32, 64))
        s, ratio = awq.search_scale(x, [w], n_grid=16, group_size=32)
        base = float(jnp.mean(
            (x @ awq.pseudo_quantize(w, group_size=32).T - x @ w.T) ** 2))
        wq = awq.pseudo_quantize(w * s[None, :], group_size=32) / s[None, :]
        scaled = float(jnp.mean((x @ wq.T - x @ w.T) ** 2))
        assert scaled <= base

    def test_clip_reduces_or_keeps_error(self):
        x = jax.random.normal(jax.random.PRNGKey(4), (64, 64))
        w = jax.random.normal(jax.random.PRNGKey(5), (16, 64))
        w = w.at[0, 0].set(40.0)  # an outlier that hurts group scaling
        wc = awq.search_clip(x, w, n_grid=8, group_size=64)
        err_c = float(jnp.mean(
            (x @ awq.pseudo_quantize(wc, group_size=64).T - x @ w.T) ** 2))
        err_0 = float(jnp.mean(
            (x @ awq.pseudo_quantize(w, group_size=64).T - x @ w.T) ** 2))
        assert err_c <= err_0


class TestAwqModel:
    def test_run_awq_output_neutral_in_fp(self):
        cfg = llama.LlamaConfig.tiny(vocab=128, layers=1)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                                 cfg.vocab_size)
        base, _ = llama.forward(params, cfg, ids)
        results, scaled = awq.run_awq(params, cfg, ids, group_size=32,
                                      n_grid=4, do_clip=False)
        out, _ = llama.forward(scaled, cfg, ids)
        # AWQ scaling folds exactly; fp outputs must match closely
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=5e-2, rtol=5e-2)
        assert len(results["scales"]) == 4  # 4 groups x 1 layer

    def test_apply_awq_reproduces(self):
        cfg = llama.LlamaConfig.tiny(vocab=128, layers=1)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                                 cfg.vocab_size)
        results, scaled = awq.run_awq(params, cfg, ids, group_size=32,
                                      n_grid=4, do_clip=False)
        replayed = awq.apply_awq(params, results)
        np.testing.assert_allclose(
            np.asarray(replayed["layers"][0]["q_proj"], np.float32),
            np.asarray(scaled["layers"][0]["q_proj"], np.float32),
            rtol=1e-5, atol=1e-6)


    def test_run_awq_mixtral_schema(self):
        """MoE schema: per-expert w1/w3 scale group off the post-attention
        norm and per-expert w3->w2 folds (reference mixtral adapter)."""
        from any4.models import mixtral
        cfg = mixtral.MixtralConfig.tiny(vocab=128, layers=1)
        params = mixtral.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 12), 0,
                                 cfg.vocab_size)
        base, _ = mixtral.forward(params, cfg, ids)
        results, scaled = awq.run_awq(params, cfg, ids, group_size=32,
                                      n_grid=4, do_clip=False)
        out, _ = mixtral.forward(scaled, cfg, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=5e-2, rtol=5e-2)
        # 3 shared groups + one w3->w2 group per expert
        assert len(results["scales"]) == 3 + cfg.num_local_experts
        assert "layers.0.experts.0.w3" in results["scales"]

    def test_artifact_roundtrip(self, tmp_path):
        """save_awq/load_awq (the reference --dump_awq/--load_awq): the
        reloaded artifact must reproduce the searched model, including
        clip ratios."""
        cfg = llama.LlamaConfig.tiny(vocab=128, layers=1)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                                 cfg.vocab_size)
        results, scaled = awq.run_awq(params, cfg, ids, group_size=32,
                                      n_grid=4, do_clip=True)
        assert results["clip"]  # clip ratios recorded
        path = str(tmp_path / "awq.npz")
        awq.save_awq(path, results)
        loaded = awq.load_awq(path)
        replayed = awq.apply_awq(params, loaded)
        for nm in ("q_proj", "o_proj", "down_proj"):
            np.testing.assert_allclose(
                np.asarray(replayed["layers"][0][nm], np.float32),
                np.asarray(scaled["layers"][0][nm], np.float32),
                rtol=1e-5, atol=1e-6)


class TestNnq:
    def test_learn_improves_w_mse(self):
        w = jax.random.normal(jax.random.PRNGKey(0), (8, 256))
        codes, lut, scales, zeros = anyq.any4_quantize(
            w, group_size=64, kmeans_iters=3)
        rec0 = quant.anyq_dequantize(codes, lut, scales, zeros,
                                     group_size=64)
        e0 = float(jnp.mean((rec0 - w) ** 2))
        lut2, assign2 = nnq.learn_lut(w, lut, scales, zeros, group_size=64,
                                      objective="w_mse", steps=150, lr=5e-2)
        rec1 = quant.anyq_dequantize(assign2, lut2, scales, zeros,
                                     group_size=64)
        e1 = float(jnp.mean((rec1 - w) ** 2))
        assert e1 <= e0 * 1.05  # refinement must not regress

    def test_nnq_through_any4_quantize(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (4, 128))
        codes, lut, scales, zeros = anyq.any4_quantize(
            w, group_size=32, kmeans_iters=2, nnq=True,
            nnq_args={"steps": 20, "objective": "w_mse"})
        assert lut.shape == (4, 16)
        assert int(codes.max()) <= 15


class TestAwqNumericTypes:
    """numeric_type dispatch in the AWQ search objective (reference
    pre_process/awq/quantizer.py:157-176, 276-323): the scale/clip grid
    optimizes the deployed format, including any4."""

    @pytest.mark.parametrize("numeric_type", ["any4", "nf4", "fp4"])
    def test_pseudo_quantize_variants(self, numeric_type):
        w = jax.random.normal(jax.random.PRNGKey(3), (8, 128))
        wq = awq.pseudo_quantize(w, n_bit=4, group_size=32,
                                 numeric_type=numeric_type)
        assert wq.shape == w.shape
        err = float(jnp.mean((wq - w) ** 2) / jnp.mean(w ** 2))
        assert 0 < err < 0.2, err
        # any4 should beat the fixed codebooks on gaussian data
        if numeric_type == "any4":
            wq_int = awq.pseudo_quantize(w, n_bit=4, group_size=32,
                                         numeric_type="int")
            err_int = float(jnp.mean((wq_int - w) ** 2))
            assert float(jnp.mean((wq - w) ** 2)) <= err_int * 1.05

    def test_pseudo_any4_matches_reference_shape_contract(self):
        # jit-safety inside a scan (the search path)
        w = jax.random.normal(jax.random.PRNGKey(4), (4, 64))

        @jax.jit
        def f(w):
            def body(_, r):
                return None, awq.pseudo_quantize(
                    w * r, 4, 32, numeric_type="any4")
            _, out = jax.lax.scan(body, None,
                                  jnp.asarray([0.5, 1.0, 2.0]))
            return out

        out = f(w)
        assert out.shape == (3, 4, 64)
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_run_awq_any4_end_to_end(self):
        cfg = llama.LlamaConfig.tiny(vocab=128, layers=1)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                                 cfg.vocab_size)
        base, _ = llama.forward(params, cfg, ids)
        results, scaled = awq.run_awq(params, cfg, ids, group_size=32,
                                      n_grid=4, do_clip=True,
                                      numeric_type="any4")
        out, _ = llama.forward(scaled, cfg, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=6e-2, rtol=6e-2)
        assert len(results["scales"]) == 4
