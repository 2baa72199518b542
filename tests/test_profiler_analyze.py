"""Profiler breakdown, analyzer plots, and nnq cossim objective tests."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from any4.evals import analyze
from any4.models import llama
from any4.profiler import profile_decode_components
from any4.quant import nnq


def _tiny():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


class TestProfiler:
    def test_attention_mlp_breakdown(self):
        cfg, params = _tiny()
        prof = profile_decode_components(params, cfg, ctx=64, iters=3,
                                         warmup=1)
        assert set(prof) == {"layers.0", "layers.1", "totals"}
        for k in ("layers.0", "layers.1"):
            assert prof[k]["attention_ms"] > 0
            assert prof[k]["mlp_ms"] > 0
        assert 0.0 <= prof["totals"]["attention_share"] <= 1.0
        assert prof["totals"]["layers_profiled"] == 2

    def test_max_layers_extrapolates(self):
        cfg, params = _tiny()
        prof = profile_decode_components(params, cfg, ctx=64, iters=2,
                                         warmup=1, max_layers=1)
        assert prof["totals"]["layers_profiled"] == 1
        assert "layers.1" not in prof


class TestPlots:
    def test_write_plots_pdf(self):
        cfg, params = _tiny()
        rows = analyze.analyze_model(params, fmts=["int4"], group_size=32)
        with tempfile.TemporaryDirectory() as d:
            path = analyze.write_plots(params, rows, d, max_layers=2)
            assert os.path.exists(path)
            assert os.path.getsize(path) > 1000
            with open(path, "rb") as f:
                assert f.read(5) == b"%PDF-"


class TestNnqCossim:
    def test_cossim_objective_improves_y_cossim(self):
        rng = np.random.RandomState(0)
        w = jnp.asarray(rng.randn(16, 256), jnp.float32)
        from any4.ops.quant import group_codes_float
        wg, scales, zeros = group_codes_float(w, 4, 64)
        # deliberately poor init: uniform ramp
        lut0 = jnp.tile(jnp.linspace(0.0, 15.0, 16)[None], (16, 1))
        x = jnp.asarray(rng.randn(64, 256), jnp.float32)

        def y_cossim(lut, assign):
            vals = jnp.take_along_axis(lut, assign, axis=1) - 8.0
            vg = vals.reshape(16, 256 // 64, 64)
            wq = (vg * scales[..., None] + zeros[..., None]).reshape(16, 256)
            y, yq = x @ w.T, x @ wq.T
            num = jnp.sum(y * yq)
            den = jnp.linalg.norm(y) * jnp.linalg.norm(yq)
            return float(num / den)

        a0 = nnq._assign(wg, lut0)
        before = y_cossim(lut0, a0)
        lut, assign = nnq.learn_lut(w, lut0, scales, zeros, group_size=64,
                                    objective="y_cossim",
                                    sample_activations=x, steps=150)
        after = y_cossim(lut, assign.astype(jnp.int32))
        assert after >= before - 1e-6
        assert after > 0.9

    def test_w_cossim_objective_runs(self):
        rng = np.random.RandomState(1)
        w = jnp.asarray(rng.randn(8, 128), jnp.float32)
        from any4.ops.quant import group_codes_float
        wg, scales, zeros = group_codes_float(w, 4, 64)
        lut0 = jnp.tile(jnp.linspace(0.0, 15.0, 16)[None], (8, 1))
        lut, assign = nnq.learn_lut(w, lut0, scales, zeros, group_size=64,
                                    objective="w_cossim", steps=50)
        assert lut.shape == (8, 16)
        assert np.isfinite(np.asarray(lut)).all()
