"""quantize_model pytree-transform tests (reference quantize.py:32-85
behavior: targeted swap, skip lm_head, pseudo mode, calibration plumbing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.models import llama
from any4.ops import linear as lin
from any4.quant import api


@pytest.fixture(scope="module")
def tiny():
    cfg = llama.LlamaConfig(vocab_size=128, hidden_size=64,
                            intermediate_size=96, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            tie_word_embeddings=False)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


class TestQuantizeModel:
    def test_swaps_linear_leaves(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        for layer in qp["layers"]:
            for nm in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                       "up_proj", "down_proj"):
                assert isinstance(layer[nm], lin.QuantizedTensor), nm
            assert isinstance(layer["input_layernorm"], jax.Array)
        # embeddings and norms untouched
        assert isinstance(qp["embed_tokens"], jax.Array)

    def test_skips_lm_head_by_default(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        assert isinstance(qp["lm_head"], jax.Array)  # not quantized

    def test_include_lm_head(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32,
                                skip_modules=())
        assert isinstance(qp["lm_head"], lin.QuantizedTensor)

    def test_skip_modules_by_name(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32,
                                skip_modules="q_proj,lm_head")
        assert isinstance(qp["layers"][0]["q_proj"], jax.Array)
        assert isinstance(qp["layers"][0]["k_proj"], lin.QuantizedTensor)

    def test_original_unmodified(self, tiny):
        cfg, params = tiny
        before = np.asarray(params["layers"][0]["q_proj"], np.float32).copy()
        api.quantize_model(params, fmt="int4", group_size=32)
        np.testing.assert_array_equal(
            np.asarray(params["layers"][0]["q_proj"], np.float32), before)

    def test_pseudo_keeps_dense(self, tiny):
        cfg, params = tiny
        pp = api.quantize_model(params, fmt="int4", group_size=32,
                                pseudo=True)
        w = pp["layers"][0]["q_proj"]
        assert isinstance(w, jax.Array)
        assert w.shape == params["layers"][0]["q_proj"].shape
        # actually changed (quantization error nonzero)
        assert not np.array_equal(np.asarray(w, np.float32),
                                  np.asarray(params["layers"][0]["q_proj"],
                                             np.float32))

    def test_sample_weight_dict_routing(self, tiny):
        cfg, params = tiny
        k = cfg.hidden_size
        sw = {f"layers.{i}.{nm}": np.ones(k)
              for i in range(2)
              for nm in ("q_proj", "k_proj", "v_proj", "o_proj")}
        sw.update({f"layers.{i}.{nm}": np.ones(
            k if nm != "down_proj" else cfg.intermediate_size)
            for i in range(2)
            for nm in ("gate_proj", "up_proj", "down_proj")})
        qp = api.quantize_model(params, fmt="any4", group_size=32,
                                sample_weight=sw, kmeans_iters=4)
        assert isinstance(qp["layers"][0]["q_proj"], lin.QuantizedTensor)

    def test_all_quant_methods_registered(self):
        for name in ("intq", "anyq", "int4", "int8", "any4", "nf4", "fp4",
                     "mx4"):
            assert name in api.quant_methods

    @pytest.mark.parametrize("fmt", ["nf4", "fp4", "mx4"])
    def test_fixed_formats(self, tiny, fmt):
        cfg, params = tiny
        g = 32
        qp = api.quant_methods[fmt](params, group_size=g) if fmt != "mx4" \
            else api.quant_methods[fmt](params)
        qt = qp["layers"][0]["q_proj"]
        assert isinstance(qt, lin.QuantizedTensor) and qt.fmt == fmt

    def test_dequantize_model(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        dp = api.dequantize_model(qp)
        w = dp["layers"][0]["q_proj"]
        assert isinstance(w, jax.Array)
        assert w.shape == params["layers"][0]["q_proj"].shape

    def test_model_size_shrinks(self):
        # use realistic dims: k is padded to the 1024-wide pack block, so
        # compression only shows once k >= 1024 (real models always are)
        w = jax.random.normal(jax.random.PRNGKey(0), (256, 2048))
        params = {"q_proj": w}
        dense = api.model_size_bytes(params)
        qp = api.quantize_model(params, fmt="int4", group_size=128,
                                skip_modules=())
        assert api.model_size_bytes(qp) < dense * 0.45


class TestCalibrationIntegration:
    def test_online_calibrate_fn(self, tiny):
        cfg, params = tiny
        from any4 import calibrate as cal
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                                 cfg.vocab_size)
        fn = cal.make_calibrate_fn(params, cfg, ids)
        qp = api.quantize_model(params, fmt="any4", group_size=32,
                                calibrate_fn=fn, kmeans_iters=3,
                                scale_sample_weight=True)
        assert isinstance(qp["layers"][0]["q_proj"], lin.QuantizedTensor)


class TestOomRetry:
    def test_oom_retries_with_smaller_row_chunk(self, monkeypatch):
        """Device OOM during clustering retries with row_chunk=8 (the
        reference's CUDA-OOM -> CPU re-cluster analog, quantize.py:851)."""
        import jax
        from any4.models import llama
        from any4.ops import linear as lin
        from any4.quant import api

        cfg = llama.LlamaConfig.tiny(vocab=64, layers=1)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        calls = {"n": 0}
        real = lin.quantize_tensor

        def flaky(w, fmt="any4", group_size=128, row_shards=1, **kw):
            calls["n"] += 1
            if calls["n"] == 1 and "row_chunk" not in kw:
                raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory")
            return real(w, fmt, group_size, row_shards=row_shards, **kw)

        monkeypatch.setattr(lin, "quantize_tensor", flaky)
        qp = api.quantize_model(params, fmt="any4", group_size=32,
                                kmeans_iters=2)
        assert isinstance(qp["layers"][0]["q_proj"], lin.QuantizedTensor)
        assert calls["n"] >= 2  # first call failed, retry succeeded
