"""Model-layer tests: functional Llama forward, decode/prefill consistency,
generation, quantized forward, checkpoints."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.models import checkpoint, generate, llama
from any4.ops import linear as lin
from any4.quant import api


@pytest.fixture(scope="module")
def tiny():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


class TestForward:
    def test_shapes_and_dtype(self, tiny):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 cfg.vocab_size)
        logits, caches = llama.forward(params, cfg, ids)
        assert logits.shape == (2, 8, cfg.vocab_size)
        assert caches is None

    def test_causality(self, tiny):
        # changing a later token must not affect earlier logits
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(2), (1, 8), 0,
                                 cfg.vocab_size)
        ids2 = ids.at[0, -1].set((ids[0, -1] + 1) % cfg.vocab_size)
        l1, _ = llama.forward(params, cfg, ids)
        l2, _ = llama.forward(params, cfg, ids2)
        np.testing.assert_allclose(np.asarray(l1[:, :-1], np.float32),
                                   np.asarray(l2[:, :-1], np.float32),
                                   atol=1e-5)
        assert not np.allclose(np.asarray(l1[:, -1], np.float32),
                               np.asarray(l2[:, -1], np.float32))

    def test_decode_matches_prefill(self, tiny):
        # running tokens one-by-one through the KV cache must reproduce the
        # full-sequence logits
        cfg, params = tiny
        t = 6
        ids = jax.random.randint(jax.random.PRNGKey(3), (1, t), 0,
                                 cfg.vocab_size)
        full, _ = llama.forward(params, cfg, ids)

        caches = llama.init_kv_caches(cfg, 1, t)
        logits0, caches = generate.prefill(params, cfg, ids[:, :1], caches)
        step_logits = [logits0]
        for i in range(1, t):
            li, caches = generate.decode_step(
                params, cfg, ids[:, i], jnp.int32(i), caches)
            step_logits.append(li)
        stepped = jnp.stack(step_logits, axis=1)
        np.testing.assert_allclose(np.asarray(stepped, np.float32),
                                   np.asarray(full, np.float32),
                                   atol=3e-2, rtol=3e-2)

    def test_capture_names_match_params(self, tiny):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(4), (1, 8), 0,
                                 cfg.vocab_size)
        cap = {}
        llama.forward(params, cfg, ids, capture=cap)
        for i in range(cfg.num_hidden_layers):
            for nm in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                       "up_proj", "down_proj"):
                assert f"layers.{i}.{nm}" in cap
        s_abs, s_sgn, c = cap["layers.0.q_proj"]
        assert s_abs.shape == (cfg.hidden_size,) and c == 8
        # |sum| <= sum of abs
        assert (np.abs(np.asarray(s_sgn)) <= np.asarray(s_abs) + 1e-5).all()


class TestGenerate:
    def test_greedy_deterministic(self, tiny):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(5), (2, 4), 0,
                                 cfg.vocab_size)
        o1 = generate.generate(params, cfg, ids, max_new_tokens=5)
        o2 = generate.generate(params, cfg, ids, max_new_tokens=5)
        assert o1.shape == (2, 9)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))

    def test_decode_loop_matches_step_loop(self, tiny):
        """The fused lax.scan decode burst (generate.decode_loop, one
        dispatch) must produce token-for-token the same greedy output as
        the per-step dispatch loop, including eos early-stop fill."""
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(7), (2, 4), 0,
                                 cfg.vocab_size)
        n_new = 6
        caches = llama.init_kv_caches(cfg, 2, 4 + n_new)
        logits, caches = generate.prefill(params, cfg, ids, caches)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        # reference: python step loop
        ref, cur, cc = [], tok, caches
        for i in range(n_new - 1):
            lg, cc = generate.decode_step(params, cfg, cur,
                                          jnp.int32(4 + i), cc)
            cur = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            ref.append(cur)
        toks, last_logits, pos, _, _ = generate.decode_loop(
            params, cfg, tok, jnp.int32(4), caches, n_new - 1)
        np.testing.assert_array_equal(
            np.asarray(toks), np.stack([np.asarray(r) for r in ref], 1))
        assert int(pos) == 4 + n_new - 1
        # eos path: force an eos hit and check fill
        eos = int(toks[0, 1])
        toks_e, _, _, _, done = generate.decode_loop(
            params, cfg, tok, jnp.int32(4), caches, n_new - 1,
            eos_token_id=eos)
        assert bool(done[0])
        after = np.asarray(toks_e[0])
        hit = int(np.argmax(after == eos))
        assert (after[hit:] == eos).all()

    def test_matches_forward_argmax(self, tiny):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(6), (1, 4), 0,
                                 cfg.vocab_size)
        out = generate.generate(params, cfg, ids, max_new_tokens=1)
        logits, _ = llama.forward(params, cfg, ids)
        expect = int(jnp.argmax(logits[0, -1]))
        assert int(out[0, -1]) == expect


class TestQuantizedForward:
    @pytest.mark.parametrize("fmt", ["int4", "int8"])
    def test_quantized_logits_close(self, tiny, fmt):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(7), (1, 8), 0,
                                 cfg.vocab_size)
        base, _ = llama.forward(params, cfg, ids)
        qp = api.quantize_model(params, fmt=fmt, group_size=32)
        ql, _ = llama.forward(qp, cfg, ids, interpret=True)
        base = np.asarray(base, np.float32)
        ql = np.asarray(ql, np.float32)
        # quantization perturbs logits but argmax should mostly agree and
        # magnitudes stay sane
        assert np.isfinite(ql).all()
        agree = (base.argmax(-1) == ql.argmax(-1)).mean()
        assert agree >= 0.5

    def test_pseudo_matches_real_dequant(self, tiny):
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(8), (1, 8), 0,
                                 cfg.vocab_size)
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        pp = api.quantize_model(params, fmt="int4", group_size=32,
                                pseudo=True)
        lq, _ = llama.forward(api.dequantize_model(qp), cfg, ids)
        lp, _ = llama.forward(pp, cfg, ids)
        np.testing.assert_allclose(np.asarray(lq, np.float32),
                                   np.asarray(lp, np.float32), atol=1e-2)


class TestCheckpoint:
    def test_roundtrip_quantized(self, tiny):
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_params(d, qp, cfg)
            loaded, cfg2 = checkpoint.load_params(d)
        assert cfg2.hidden_size == cfg.hidden_size
        qt0 = qp["layers"][0]["q_proj"]
        qt1 = loaded["layers"][0]["q_proj"]
        assert isinstance(qt1, lin.QuantizedTensor)
        assert qt1.fmt == qt0.fmt and qt1.shape == qt0.shape
        np.testing.assert_array_equal(np.asarray(qt1.packed),
                                      np.asarray(qt0.packed))
        ids = jax.random.randint(jax.random.PRNGKey(9), (1, 4), 0,
                                 cfg.vocab_size)
        l0, _ = llama.forward(qp, cfg, ids, interpret=True)
        l1, _ = llama.forward(loaded, cfg2, ids, interpret=True)
        np.testing.assert_allclose(np.asarray(l0, np.float32),
                                   np.asarray(l1, np.float32), atol=1e-5)


    def test_roundtrip_xla_fmts(self):
        """Grouped (3-D packed) and per-row-scale tensors survive the
        checkpoint round trip (round-5 XLA-dot formats)."""
        w = jax.random.normal(jax.random.PRNGKey(41), (64, 1024))
        for fmt in ("w8a8", "w8a8r"):
            qt = lin.quantize_tensor(w, fmt, group_size=128)
            with tempfile.TemporaryDirectory() as d:
                checkpoint.save_params(d, {"w": qt})
                loaded, _ = checkpoint.load_params(d)
            qt2 = loaded["w"]
            assert qt2.fmt == qt.fmt and qt2.group_size == qt.group_size
            np.testing.assert_array_equal(
                np.asarray(lin.dequantize_tensor(qt2)),
                np.asarray(lin.dequantize_tensor(qt)))

    def test_roundtrip_row_sharded_unaligned(self):
        """row_shards with a k that pads per shard: reloading without the
        persisted row_shards would reinterpret the shard padding as
        contiguous columns (ADVICE round-1 medium finding)."""
        w = jax.random.normal(jax.random.PRNGKey(40), (64, 1536))
        qt = lin.quantize_tensor(w, "int4", group_size=128, row_shards=2)
        # int4 keeps the row-planar layout: per-shard k=768 pads to
        # 1024 -> 2 * 1024/8 word columns, not 1536/8
        assert qt.fmt == "int4" and qt.packed.shape[1] == 256
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_params(d, {"w": qt})
            loaded, _ = checkpoint.load_params(d)
        qt2 = loaded["w"]
        assert qt2.row_shards == 2
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qt2)),
            np.asarray(lin.dequantize_tensor(qt)))


class TestFusedProjections:
    def test_fused_matches_unfused_dense(self, tiny):
        from any4.models import fuse
        cfg, params = tiny
        ids = jax.random.randint(jax.random.PRNGKey(30), (1, 8), 0,
                                 cfg.vocab_size)
        base, _ = llama.forward(params, cfg, ids)
        fused = fuse.fuse_projections(params)
        assert "qkv_proj" in fused["layers"][0]
        assert "q_proj" not in fused["layers"][0]
        out, _ = llama.forward(fused, cfg, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=2e-2, rtol=2e-2)

    def test_partial_bias_set_preserved(self, tiny):
        """A layer with only k/v biases (no q) must not lose them when
        fusing (ADVICE round-1 low finding)."""
        from any4.models import fuse
        from any4.quant.api import _copy_tree
        cfg, params = tiny
        params = _copy_tree(params)
        hd, nkv = cfg.head_dim_, cfg.num_key_value_heads
        layer = params["layers"][0]
        layer["k_bias"] = jnp.ones((nkv * hd,), jnp.float32)
        layer["v_bias"] = jnp.full((nkv * hd,), 2.0, jnp.float32)
        base, _ = llama.forward(params, cfg, jnp.zeros((1, 4), jnp.int32))
        fused = fuse.fuse_projections(params)
        flayer = fused["layers"][0]
        assert "qkv_bias" in flayer
        nq = cfg.num_attention_heads * hd
        np.testing.assert_array_equal(
            np.asarray(flayer["qkv_bias"][:nq]), 0.0)
        out, _ = llama.forward(fused, cfg, jnp.zeros((1, 4), jnp.int32))
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=2e-2, rtol=2e-2)

    def test_fused_matches_unfused_quantized(self, tiny):
        from any4.models import fuse
        cfg, params = tiny
        qp = api.quantize_model(params, fmt="int4", group_size=32)
        ids = jax.random.randint(jax.random.PRNGKey(31), (1, 8), 0,
                                 cfg.vocab_size)
        base, _ = llama.forward(qp, cfg, ids, interpret=True)
        fused = fuse.fuse_projections(qp)
        out, _ = llama.forward(fused, cfg, ids, interpret=True)
        # identical quantized values, just concatenated: outputs must match
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(base, np.float32),
                                   atol=1e-3, rtol=1e-3)

    def test_fused_decode_matches(self, tiny):
        from any4.models import fuse
        cfg, params = tiny
        fused = fuse.fuse_projections(params)
        ids = jax.random.randint(jax.random.PRNGKey(32), (1, 4), 0,
                                 cfg.vocab_size)
        o1 = generate.generate(params, cfg, ids, max_new_tokens=4)
        o2 = generate.generate(fused, cfg, ids, max_new_tokens=4)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


class TestQuantizedEmbeddings:
    """Quantized (tied) embedding tables: row-gather lookup + fused
    quantized LM-head matmul off the same packed table. No reference
    analog (tinygemm only swaps nn.Linear modules); this halves (w8a8) /
    quarters (4-bit) the decode-time read of the vocab matmul."""

    @pytest.fixture(scope="class")
    def tied(self):
        cfg = llama.LlamaConfig(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512,
            tie_word_embeddings=True)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        return cfg, params

    @pytest.mark.parametrize("efmt", ["int8", "w8a8", "nf4", "any4"])
    def test_lookup_matches_dequant_rows(self, tied, efmt):
        cfg, params = tied
        kw = dict(kmeans_iters=4) if efmt == "any4" else {}
        # embedding tables need the row-gatherable row-major packing
        # (quant.api passes layout="row" for the same reason)
        qt = lin.quantize_tensor(params["embed_tokens"], efmt,
                                 group_size=128, layout="row", **kw)
        ids = jax.random.randint(jax.random.PRNGKey(2), (2, 5), 0,
                                 cfg.vocab_size)
        out = lin.embedding_lookup(qt, ids)
        full = lin.dequantize_tensor(qt)
        ref = np.asarray(full)[np.asarray(ids)]
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   ref.astype(np.float32),
                                   atol=1e-6, rtol=1e-6)

    def test_tied_forward_close_to_dequant_reference(self, tied):
        cfg, params = tied
        qe = lin.quantize_tensor(params["embed_tokens"], "w8a8",
                                 group_size=128, layout="row")
        qparams = dict(params, embed_tokens=qe)
        ids = jax.random.randint(jax.random.PRNGKey(3), (2, 6), 0,
                                 cfg.vocab_size)
        logits_q, _ = llama.forward(qparams, cfg, ids)
        # reference: same dequantized table used densely (isolates the
        # int8-activation matmul noise, ~0.4% relative)
        de = lin.dequantize_tensor(qe, dtype=params["embed_tokens"].dtype)
        logits_ref, _ = llama.forward(dict(params, embed_tokens=de),
                                      cfg, ids)
        a = np.asarray(logits_q, np.float32)
        b = np.asarray(logits_ref, np.float32)
        denom = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) / denom < 2e-2

    def test_quantize_model_wiring(self, tied):
        cfg, params = tied
        qp = api.quantize_model(params, fmt="int4",
                                quantize_embeddings=True)
        assert isinstance(qp["embed_tokens"], lin.QuantizedTensor)
        assert qp["embed_tokens"].fmt == "int4"
        qp2 = api.quantize_model(params, fmt="w4a8",
                                 quantize_embeddings="w8a8")
        assert qp2["embed_tokens"].fmt == "w8a8"
        ids = jax.random.randint(jax.random.PRNGKey(4), (1, 4), 0,
                                 cfg.vocab_size)
        logits, _ = llama.forward(qp2, cfg, ids)
        assert logits.shape == (1, 4, cfg.vocab_size)

    def test_generate_runs_quantized_embeddings(self, tied):
        cfg, params = tied
        qp = api.quantize_model(params, fmt="int8",
                                quantize_embeddings="int8")
        ids = jax.random.randint(jax.random.PRNGKey(5), (1, 4), 0,
                                 cfg.vocab_size)
        out = generate.generate(qp, cfg, ids, max_new_tokens=4)
        assert out.shape == (1, 8)

    def test_rejects_multi_row_packings(self, tied):
        cfg, params = tied
        with pytest.raises(AssertionError, match="row-gatherable"):
            api.quantize_model(params, fmt="w4a8",
                               quantize_embeddings=True)
        qt = lin.quantize_tensor(params["embed_tokens"], "int4p",
                                 group_size=128)
        with pytest.raises(AssertionError):
            lin.embedding_lookup(qt, jnp.zeros((1, 2), jnp.int32))

    def test_checkpoint_roundtrip(self, tied):
        cfg, params = tied
        qp = api.quantize_model(params, fmt="int4",
                                quantize_embeddings="w8a8")
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_params(d, qp)
            loaded, _ = checkpoint.load_params(d)
        qe = loaded["embed_tokens"]
        assert isinstance(qe, lin.QuantizedTensor) and qe.fmt == "w8a8"
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qp["embed_tokens"])),
            np.asarray(lin.dequantize_tensor(qe)))
