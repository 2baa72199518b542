"""Logit-level parity of the JAX model forwards against HF transformers.

The reference's ground truth IS the HF torch model (eval.py:168-177); in a
zero-egress container the strongest accuracy evidence is converting a
random-init transformers model (torch CPU) and pinning our forward to its
logits in float32: RoPE convention, GQA head repeat, attention biases, tied
embeddings, and OPT's +2 position offset are all covered.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from any4.models import llama, loader, opt  # noqa: E402


def _assert_logits_close(ours, theirs, atol=2e-4):
    ours = np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    scale = max(float(np.abs(theirs).max()), 1.0)
    np.testing.assert_allclose(ours / scale, theirs / scale, atol=atol,
                               rtol=0)


def _torch_logits(model, ids_np):
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids_np))
    return out.logits.float().numpy()


def _hf_llama(tie=True, theta=10000.0, head_dim=None, bias=False, seed=0):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        head_dim=head_dim, max_position_embeddings=128, rope_theta=theta,
        tie_word_embeddings=tie, attention_bias=bias,
        attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg).eval().float()
    return model


class TestLlamaParity:
    def test_logits_match_gqa_tied(self):
        model = _hf_llama(tie=True)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[1, 5, 9, 200, 7, 42, 3, 250]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = llama.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)

    def test_logits_match_untied_lm_head(self):
        model = _hf_llama(tie=False, seed=1)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        assert "lm_head" in params
        ids = np.array([[2, 30, 100, 7]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = llama.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)

    def test_logits_match_llama3_style_rope(self):
        # llama-3 convention: large rope_theta + explicit head_dim
        model = _hf_llama(tie=True, theta=500000.0, head_dim=16, seed=2)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        assert cfg.head_dim_ == 16
        ids = np.array([[9, 8, 7, 6, 5, 4]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = llama.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)

    def test_logits_match_attention_bias(self):
        # Qwen2-style attention biases route through q/k/v/o bias leaves
        model = _hf_llama(bias=True, seed=3)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        assert "q_bias" in params["layers"][0]
        ids = np.array([[11, 22, 33, 44, 55]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = llama.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)

    def test_decode_cache_matches_full_forward(self):
        """KV-cached single-token decode must produce the same logits the
        full-sequence forward produces at each position."""
        model = _hf_llama(seed=4)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[3, 14, 15, 92, 65, 35]], np.int64)
        ref = _torch_logits(model, ids)

        max_len = 8
        caches = llama.init_kv_caches(cfg, 1, max_len, dtype=jnp.float32)
        jids = jnp.asarray(ids, jnp.int32)
        # prefill first 3 tokens
        pre = 3
        mask = jnp.where(
            (jnp.arange(max_len)[None, :] <= jnp.arange(pre)[:, None]),
            0.0, -1e9)[None, None].astype(jnp.float32)
        logits, caches = llama.forward(
            params, cfg, jids[:, :pre], kv_caches=caches, cache_pos=None,
            mask=mask)
        _assert_logits_close(logits[0, -1], ref[0, pre - 1])
        # decode the rest one token at a time
        for t in range(pre, ids.shape[1]):
            positions = jnp.full((1, 1), t, jnp.int32)
            mask = llama.decode_mask(max_len, jnp.int32(t))
            logits, caches = llama.forward(
                params, cfg, jids[:, t:t + 1], positions=positions,
                kv_caches=caches, cache_pos=jnp.int32(t), mask=mask)
            _assert_logits_close(logits[0, -1], ref[0, t])


def _hf_mixtral(seed=0):
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=128, num_local_experts=4,
        num_experts_per_tok=2, attn_implementation="eager",
        router_jitter_noise=0.0)
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(cfg).eval().float()


class TestMixtralParity:
    """Pins the MoE forward (top-k routing renormalization, per-expert
    SwiGLU, router placement) to HF MixtralForCausalLM -- the reference's
    ground truth for its Mixtral-8x7B results (README.md:309-327)."""

    def test_logits_match(self):
        from any4.models import mixtral
        model = _hf_mixtral(seed=6)
        cfg, params = loader.convert_torch_mixtral(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[1, 5, 9, 200, 7, 42, 3, 250]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = mixtral.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)

    def test_decode_cache_matches_full_forward(self):
        from any4.models import mixtral
        model = _hf_mixtral(seed=7)
        cfg, params = loader.convert_torch_mixtral(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[3, 14, 15, 92, 65]], np.int64)
        ref = _torch_logits(model, ids)
        max_len = 8
        caches = llama.init_kv_caches(cfg, 1, max_len, dtype=jnp.float32)
        jids = jnp.asarray(ids, jnp.int32)
        pre = 2
        mask = jnp.where(
            (jnp.arange(max_len)[None, :] <= jnp.arange(pre)[:, None]),
            0.0, -1e9)[None, None].astype(jnp.float32)
        logits, caches = mixtral.forward(
            params, cfg, jids[:, :pre], kv_caches=caches, cache_pos=None,
            mask=mask)
        _assert_logits_close(logits[0, -1], ref[0, pre - 1])
        for t in range(pre, ids.shape[1]):
            positions = jnp.full((1, 1), t, jnp.int32)
            mask = llama.decode_mask(max_len, jnp.int32(t))
            logits, caches = mixtral.forward(
                params, cfg, jids[:, t:t + 1], positions=positions,
                kv_caches=caches, cache_pos=jnp.int32(t), mask=mask)
            _assert_logits_close(logits[0, -1], ref[0, t])

    def test_load_mixtral_safetensors_roundtrip(self, tmp_path):
        """save_pretrained -> load_mixtral reads the HF shard layout."""
        from any4.models import mixtral
        model = _hf_mixtral(seed=8)
        model.save_pretrained(tmp_path, safe_serialization=True)
        cfg, params = loader.load_mixtral(str(tmp_path), dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        assert cfg.num_local_experts == 4
        assert len(params["layers"][0]["experts"]) == 4
        ids = np.array([[2, 17, 200, 31]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = mixtral.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)


def _hf_gemma2(seed=0, sliding_window=4):
    cfg = transformers.Gemma2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128,
        sliding_window=sliding_window, query_pre_attn_scalar=16,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.Gemma2ForCausalLM(cfg).eval().float()


class TestGemma2Parity:
    """Pins the gemma2 feature set -- (1+w) norms, sqrt(d) embed scaling,
    query_pre_attn_scalar, attn/final logit softcapping, sliding-window
    layers, sandwich norms -- to HF Gemma2ForCausalLM logits."""

    def test_logits_match(self):
        model = _hf_gemma2(seed=10)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        assert cfg.rms_norm_offset == 1.0 and cfg.sandwich_norms
        assert cfg.attn_logit_softcapping == 50.0
        assert cfg.sliding_window == 4
        # long enough that sliding layers actually drop positions
        ids = np.array([[1, 5, 9, 200, 7, 42, 3, 250, 18, 77]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = llama.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref, atol=4e-4)

    def test_decode_cache_matches_full_forward(self):
        """KV-cached decode (sliding + full layers, softcaps) matches the
        full-sequence forward at every position."""
        model = _hf_gemma2(seed=11)
        cfg, params = loader.convert_torch_llama(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[3, 14, 15, 92, 65, 35, 89, 79]], np.int64)
        ref = _torch_logits(model, ids)
        max_len = 8
        caches = llama.init_kv_caches(cfg, 1, max_len, dtype=jnp.float32)
        jids = jnp.asarray(ids, jnp.int32)
        pre = 3
        mask = jnp.where(
            (jnp.arange(max_len)[None, :] <= jnp.arange(pre)[:, None]),
            0.0, -1e9)[None, None].astype(jnp.float32)
        logits, caches = llama.forward(
            params, cfg, jids[:, :pre], kv_caches=caches, cache_pos=None,
            mask=mask)
        _assert_logits_close(logits[0, -1], ref[0, pre - 1], atol=4e-4)
        for t in range(pre, ids.shape[1]):
            positions = jnp.full((1, 1), t, jnp.int32)
            mask = llama.decode_mask(max_len, jnp.int32(t))
            logits, caches = llama.forward(
                params, cfg, jids[:, t:t + 1], positions=positions,
                kv_caches=caches, cache_pos=jnp.int32(t), mask=mask)
            _assert_logits_close(logits[0, -1], ref[0, t], atol=4e-4)


class TestOPTParity:
    def test_logits_match(self):
        hf_cfg = transformers.OPTConfig(
            vocab_size=256, hidden_size=64, ffn_dim=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, word_embed_proj_dim=64,
            do_layer_norm_before=True)
        torch.manual_seed(5)
        model = transformers.OPTForCausalLM(hf_cfg).eval().float()
        cfg, params = loader.convert_torch_opt(model, dtype=jnp.float32)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": jnp.float32})
        ids = np.array([[2, 17, 200, 31, 90]], np.int64)
        ref = _torch_logits(model, ids)
        ours, _ = opt.forward(params, cfg, jnp.asarray(ids, jnp.int32))
        _assert_logits_close(ours, ref)
