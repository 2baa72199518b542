"""Paged KV cache + continuous batching engine tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.models import generate, llama
from any4.serving import engine as eng
from any4.serving import kv_cache as kvc


def _np_attention(q, kctx, vctx, lens):
    """numpy softmax attention reference: q [b, nq, d], kctx/vctx
    [b, s, h, d] dense contexts, lens [b] visible lengths."""
    q = np.asarray(q, np.float64)
    kctx = np.asarray(kctx, np.float64)
    vctx = np.asarray(vctx, np.float64)
    b, nq, d = q.shape
    h = kctx.shape[2]
    out = np.zeros((b, nq, d))
    for bi in range(b):
        L = int(lens[bi])
        for qh in range(nq):
            kh = qh // (nq // h)
            lg = kctx[bi, :L, kh] @ q[bi, qh] / np.sqrt(d)
            pr = np.exp(lg - lg.max())
            out[bi, qh] = (pr / pr.sum()) @ vctx[bi, :L, kh]
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


class TestPagedKV:
    def test_allocator_and_release(self):
        a = kvc.PageAllocator(num_pages=9, max_seqs=2, pages_per_seq=4)
        assert a.ensure(0, 33, 16)      # 3 pages
        assert len(a.seq_pages[0]) == 3
        assert a.ensure(1, 64, 16)      # 4 pages
        assert not a.ensure(0, 80, 16)  # would need 5 > pages_per_seq
        a.release(1)
        assert a.ensure(0, 64, 16)
        assert 0 not in [p for ps in a.seq_pages for p in ps]  # reserved

    def test_write_then_gather_roundtrip(self):
        # head-major pool [h, P, ps, d]
        pages = jnp.zeros((2, 4, 8, 4))
        kv = jax.random.normal(jax.random.PRNGKey(0), (1, 10, 2, 4))
        pos = np.arange(10)
        table = np.array([2, 3, 0, 0])
        page_ids = jnp.asarray(table[pos // 8])[None]
        offsets = jnp.asarray(pos % 8)[None]
        pages = kvc.write_tokens(pages, kv, page_ids, offsets)
        ctx = kvc.gather_ctx(pages, jnp.asarray(table)[None])
        np.testing.assert_allclose(np.asarray(ctx[0, :10]),
                                   np.asarray(kv[0]), atol=1e-6)

    def test_paged_attention_matches_dense(self):
        # fallback path math check: gather + masked attention vs direct
        h, P, ps, d = 2, 5, 4, 8
        nq = 4
        key = jax.random.PRNGKey(1)
        kp = jax.random.normal(key, (h, P, ps, d))
        vp = jax.random.normal(jax.random.PRNGKey(2), (h, P, ps, d))
        q = jax.random.normal(jax.random.PRNGKey(3), (2, nq, d))
        table = jnp.asarray([[1, 2], [3, 4]])
        lens = jnp.asarray([6, 3])
        out = kvc.paged_attention(q, kp, vp, lens, table)
        # manual reference
        for bi in range(2):
            kctx = np.concatenate([np.asarray(kp[:, p]) for p in
                                   np.asarray(table[bi])], axis=1)  # [h,s,d]
            vctx = np.concatenate([np.asarray(vp[:, p]) for p in
                                   np.asarray(table[bi])], axis=1)
            L = int(lens[bi])
            for qh in range(nq):
                kh = qh // (nq // h)
                lg = np.asarray(q[bi, qh], np.float32) @ \
                    kctx[kh, :L].T.astype(np.float32) / np.sqrt(d)
                pr = np.exp(lg - lg.max())
                pr /= pr.sum()
                ref = pr @ vctx[kh, :L].astype(np.float32)
                np.testing.assert_allclose(np.asarray(out[bi, qh]), ref,
                                           atol=2e-2, rtol=2e-2)


class TestEngine:
    def test_single_request_matches_generate(self, tiny):
        cfg, params = tiny
        prompt = np.asarray(
            jax.random.randint(jax.random.PRNGKey(1), (6,), 0,
                               cfg.vocab_size))
        ref = generate.generate(params, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=6)
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8)
        e.submit(prompt, max_new_tokens=6)
        done = e.run()
        assert len(done) == 1
        got = np.asarray(done[0].out_tokens)
        expect = np.asarray(ref[0, 6:])
        np.testing.assert_array_equal(got, expect)

    def test_continuous_batching_multiple_requests(self, tiny):
        cfg, params = tiny
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (4, 7, 5, 6, 3)]
        refs = [np.asarray(generate.generate(
            params, cfg, jnp.asarray(p[None]), max_new_tokens=4)[0, len(p):])
            for p in prompts]
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=32, page_size=8)
        uids = [e.submit(p, max_new_tokens=4) for p in prompts]
        done = e.run()
        assert len(done) == 5
        by_uid = {r.uid: r for r in done}
        for uid, ref in zip(uids, refs):
            np.testing.assert_array_equal(
                np.asarray(by_uid[uid].out_tokens), ref)

    def test_burst_decode_matches_single_step(self, tiny):
        """burst>1 fuses decode steps into one dispatch (lax.scan); token
        streams must match the per-step engine exactly, across slot churn,
        eos early-stop and page-capacity-limited bursts."""
        cfg, params = tiny
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (4, 7, 5, 6, 3)]
        e1 = eng.Engine(params, cfg, max_slots=2, max_ctx=32, page_size=8)
        u1 = [e1.submit(p, max_new_tokens=6) for p in prompts]
        r1 = {r.uid: r.out_tokens for r in e1.run()}
        eb = eng.Engine(params, cfg, max_slots=2, max_ctx=32, page_size=8)
        ub = [eb.submit(p, max_new_tokens=6) for p in prompts]
        rb = {r.uid: r.out_tokens for r in eb.run(burst=4)}
        for a, b in zip(u1, ub):
            np.testing.assert_array_equal(r1[a], rb[b])
        # eos inside a burst
        prompt = prompts[0]
        ref = r1[u1[0]]
        if len(ref) >= 2:
            eos = int(ref[1])
            ee = eng.Engine(params, cfg, max_slots=1, max_ctx=32,
                            page_size=8)
            ee.submit(prompt, max_new_tokens=6, eos_token_id=eos)
            out = ee.run(burst=4)[0].out_tokens
            assert out[-1] == eos and len(out) <= 2

    def test_pages_recycled(self, tiny):
        cfg, params = tiny
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=32, page_size=8,
                       num_pages=6)
        free0 = len(e.alloc.free)
        for _ in range(3):
            e.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
        done = e.run()
        assert len(done) == 3
        assert len(e.alloc.free) == free0

    def test_eos_stops_early(self, tiny):
        cfg, params = tiny
        prompt = np.asarray([5, 6, 7], np.int32)
        ref = generate.generate(params, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=8)
        toks = np.asarray(ref[0, 3:])
        eos = int(toks[2])  # stop no later than the 3rd generated token
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8)
        e.submit(prompt, max_new_tokens=8, eos_token_id=eos)
        done = e.run()
        out = done[0].out_tokens
        # the tiny random model may emit the eos token even earlier
        assert len(out) <= 3 and out[-1] == eos


class TestFlashPagedDecode:
    @pytest.mark.parametrize("hd", [16, 64])
    def test_matches_dense_reference(self, hd):
        """Paged decode attention (gather + XLA einsums) at any head_dim
        must match a numpy softmax reference over the gathered context."""
        h, P, ps = 2, 9, 8
        b, nq = 3, 4
        rng = np.random.RandomState(0)
        kp = jnp.asarray(rng.randn(h, P, ps, hd), jnp.float32)
        vp = jnp.asarray(rng.randn(h, P, ps, hd), jnp.float32)
        q = jnp.asarray(rng.randn(b, nq, hd), jnp.float32)
        table = jnp.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [4, 3, 2, 1]],
                            jnp.int32)
        lens = jnp.asarray([5, 17, 32], jnp.int32)
        out = kvc.paged_attention(q, kp, vp, lens, table)
        ref = _np_attention(q, kvc.gather_ctx(kp, table),
                            kvc.gather_ctx(vp, table), lens)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


class TestPrefillBuckets:
    def test_varied_prompt_lengths_one_bucket_program(self, tiny):
        """Prompts of different lengths land in shared power-of-two
        buckets and still decode identically to the unpadded generator."""
        cfg, params = tiny
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8)
        rng = np.random.RandomState(7)
        for n in (3, 9, 13, 15):  # buckets: 16, 16, 16, 16
            p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
            ref = generate.generate(params, cfg, jnp.asarray(p[None]),
                                    max_new_tokens=4)
            e.submit(p, max_new_tokens=4)
            done = e.run()
            np.testing.assert_array_equal(
                np.asarray(done[0].out_tokens), np.asarray(ref[0, n:]))


class TestTPEngine:
    """North-star configuration: sharded decode + paged KV + continuous
    batching in one engine (BASELINE.json)."""

    @pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2+ devices")
    def test_tp_engine_matches_single(self, tiny):
        from any4.parallel import tp
        cfg, params = tiny
        mesh = tp.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        sharded, specs = tp.shard_params(params, mesh, cfg=cfg)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (5, 8, 3)]
        single = eng.Engine(params, cfg, max_slots=2, max_ctx=32,
                            page_size=8)
        uids_s = [single.submit(p, max_new_tokens=4) for p in prompts]
        ref = {u: r.out_tokens for u, r in
               zip(uids_s, sorted(single.run(), key=lambda r: r.uid))}
        e = eng.Engine(sharded, cfg, max_slots=2, max_ctx=32, page_size=8,
                       mesh=mesh, param_spec=specs)
        uids = [e.submit(p, max_new_tokens=4) for p in prompts]
        done = {r.uid: r.out_tokens for r in e.run()}
        for u_s, u in zip(uids_s, uids):
            np.testing.assert_array_equal(done[u], ref[u_s])

    @pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2+ devices")
    def test_tp_engine_quantized_weights_fused(self, tiny):
        """The full flagship stack at once: any4-quantized fused-projection
        weights, tensor-parallel decode, paged KV."""
        from any4.models import fuse
        from any4.parallel import tp
        from any4.quant import api
        cfg, params = tiny
        qparams = api.quantize_model(params, fmt="any4", group_size=32,
                                     kmeans_iters=3, row_parallel_shards=2)
        fused = fuse.fuse_projections(qparams)
        mesh = tp.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        sharded, specs = tp.shard_params(fused, mesh, cfg=cfg)
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        # Teacher-forced logits parity: free-running greedy token equality
        # is fragile -- the TP psum sums k-shard partials in a different
        # float order than the single-device dot, and an exact bf16
        # logits tie then flips argmax (observed: top-2 both 2.765625).
        # Forcing the same token stream through both engines compares the
        # actual TP decode math step by step.
        forced = [7, 11, 13, 17]

        def run_forced(params_, mesh_=None, specs_=None):
            e = eng.Engine(params_, cfg, max_slots=1, max_ctx=32,
                           page_size=8, mesh=mesh_, param_spec=specs_)
            cap = []
            it = iter(forced)

            def sample(lg):
                cap.append(np.asarray(lg, np.float32))
                return jnp.full((lg.shape[0],), next(it), jnp.int32)

            e.sample_fn = sample
            e.submit(prompt, max_new_tokens=4)
            e.run()
            return cap

        ls = run_forced(fused)
        lt = run_forced(sharded, mesh, specs)
        assert len(ls) == len(lt) == 4
        for a, b in zip(ls, lt):
            np.testing.assert_allclose(a, b, atol=0.1)


class TestTPEngineW4A8:
    @pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2+ devices")
    def test_tp_engine_w4a8_teacher_forced(self):
        """North-star stack on the int8-MXU format: w4a8 weights,
        tensor-parallel decode, paged KV. Teacher-forced logits parity
        (see TestTPEngine for why free-running token equality is
        fragile); tolerance also covers per-shard vs full-k activation
        absmax grouping."""
        from any4.parallel import tp
        from any4.quant import api
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=256,
                                intermediate_size=256,
                                num_hidden_layers=2,
                                num_attention_heads=2,
                                num_key_value_heads=2, head_dim=128,
                                tie_word_embeddings=True,
                                dtype=jnp.float32)
        params = llama.init_params(cfg, jax.random.PRNGKey(60))
        qparams = api.quantize_model(params, fmt="w4a8", group_size=128,
                                     row_parallel_shards=2)
        mesh = tp.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        sharded, specs = tp.shard_params(qparams, mesh, cfg=cfg)
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        forced = [7, 11, 13, 17]

        def run_forced(params_, mesh_=None, specs_=None):
            e = eng.Engine(params_, cfg, max_slots=1, max_ctx=32,
                           page_size=8, mesh=mesh_, param_spec=specs_)
            cap = []
            it = iter(forced)

            def sample(lg):
                cap.append(np.asarray(lg, np.float32))
                return jnp.full((lg.shape[0],), next(it), jnp.int32)

            e.sample_fn = sample
            e.submit(prompt, max_new_tokens=4)
            e.run()
            return cap

        ls = run_forced(qparams)
        lt = run_forced(sharded, mesh, specs)
        assert len(ls) == len(lt) == 4
        for a, b in zip(ls, lt):
            np.testing.assert_allclose(a, b, atol=0.15)


class TestQuantizedKV:
    def test_int8_kv_write_gather_roundtrip(self):
        pages = (jnp.zeros((2, 4, 8, 4), jnp.int8),
                 jnp.ones((2, 4, 8), jnp.float32))
        kv = jax.random.normal(jax.random.PRNGKey(0), (1, 10, 2, 4))
        pos = np.arange(10)
        table = np.array([2, 3, 0, 0])
        page_ids = jnp.asarray(table[pos // 8])[None]
        offsets = jnp.asarray(pos % 8)[None]
        pages = kvc.write_tokens(pages, kv, page_ids, offsets)
        ctx = kvc.gather_ctx(pages, jnp.asarray(table)[None])
        # int8 round trip: ~1% relative error
        np.testing.assert_allclose(np.asarray(ctx[0, :10]),
                                   np.asarray(kv[0]), atol=0.03)

    def test_engine_with_quantized_kv(self, tiny):
        cfg, params = tiny
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        ref = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8)
        ref.submit(prompt, max_new_tokens=4)
        expect = ref.run()[0].out_tokens
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8,
                       kv_quantize=True)
        e.submit(prompt, max_new_tokens=4)
        got = e.run()[0].out_tokens
        # int8 KV perturbs logits slightly; greedy tokens usually agree on
        # the first steps
        assert len(got) == 4
        assert got[0] == expect[0]


class TestOversizedPrompt:
    def test_long_prompt_truncated_not_stuck(self, tiny):
        """A prompt longer than max_ctx must be truncated and served, not
        block the pending queue forever."""
        cfg, params = tiny
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=32, page_size=8)
        rng = np.random.RandomState(5)
        long_prompt = rng.randint(0, cfg.vocab_size, 50).astype(np.int32)
        short = rng.randint(0, cfg.vocab_size, 4).astype(np.int32)
        e.submit(long_prompt, max_new_tokens=2)
        e.submit(short, max_new_tokens=2)
        done = e.run(max_steps=200)
        assert len(done) == 2
        # truncation keeps the most recent context: same tokens as
        # submitting the tail directly
        ref = eng.Engine(params, cfg, max_slots=1, max_ctx=32, page_size=8)
        ref.submit(long_prompt[-31:], max_new_tokens=2)
        np.testing.assert_array_equal(done[0].out_tokens,
                                      ref.run()[0].out_tokens)


class TestFlashPagedDecodeQuantized:
    def test_quantized_pool_matches_dequantized_dense(self):
        """int8 KV pages + per-token scales (folded into the logits and
        probabilities) must match a numpy reference over the dequantized
        pool, to the bf16 rounding of the q8 path's dots."""
        h, P, ps, hd = 2, 9, 8, 64
        b, nq = 2, 4
        rng = np.random.RandomState(1)
        kq = jnp.asarray(rng.randint(-127, 128, (h, P, ps, hd)), jnp.int8)
        vq = jnp.asarray(rng.randint(-127, 128, (h, P, ps, hd)), jnp.int8)
        ks = jnp.asarray(rng.rand(h, P, ps) * 0.02 + 0.001, jnp.float32)
        vs = jnp.asarray(rng.rand(h, P, ps) * 0.02 + 0.001, jnp.float32)
        q = jnp.asarray(rng.randn(b, nq, hd), jnp.float32)
        table = jnp.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], jnp.int32)
        lens = jnp.asarray([7, 25], jnp.int32)
        out = kvc.paged_attention(q, (kq, ks), (vq, vs), lens, table)
        # the pool writer (write_tokens) stores to_int8 codes with amax
        # scales, so the dequant reference is code * amax / 127.5
        kd = kq.astype(jnp.float32) * ks[..., None] / 127.5
        vd = vq.astype(jnp.float32) * vs[..., None] / 127.5
        ref = _np_attention(q, kvc.gather_ctx(kd, table),
                            kvc.gather_ctx(vd, table), lens)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(np.asarray(out) / scale, ref / scale,
                                   atol=2e-2)

    def test_engine_quantized_kv_hd64_uses_flash(self):
        """hd=64 + int8 KV through the engine: outputs stay sane."""
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=256,
                                intermediate_size=256, num_hidden_layers=1,
                                num_attention_heads=4,
                                num_key_value_heads=2, head_dim=64,
                                tie_word_embeddings=True)
        params = llama.init_params(cfg, jax.random.PRNGKey(4))
        ref = eng.Engine(params, cfg, max_slots=1, max_ctx=32, page_size=8)
        ref.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
        expect = ref.run()[0].out_tokens
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=32, page_size=8,
                       kv_quantize=True)
        e.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
        got = e.run()[0].out_tokens
        assert len(got) == 3
        assert got[0] == expect[0]  # int8 KV perturbs logits only slightly

    @pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2+ devices")
    def test_tp_engine_with_quantized_kv(self, tiny):
        from any4.parallel import tp
        cfg, params = tiny
        mesh = tp.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        sharded, specs = tp.shard_params(params, mesh, cfg=cfg)
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        e = eng.Engine(sharded, cfg, max_slots=1, max_ctx=32, page_size=8,
                       mesh=mesh, param_spec=specs, kv_quantize=True)
        e.submit(prompt, max_new_tokens=3)
        done = e.run(max_steps=50)
        assert len(done) == 1 and len(done[0].out_tokens) == 3


class TestEngineW4A8:
    def test_engine_w4a8_matches_generate(self):
        """The int8-MXU format serves end-to-end: engine prefill (chunked
        int8 kernel) + burst decode match sequential generate on the same
        quantized weights."""
        from any4.quant import api
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=128,
                                intermediate_size=256,
                                num_hidden_layers=2,
                                num_attention_heads=2,
                                num_key_value_heads=2, head_dim=64,
                                tie_word_embeddings=True,
                                dtype=jnp.float32)
        params = llama.init_params(cfg, jax.random.PRNGKey(50))
        qparams = api.quantize_model(params, fmt="w4a8", group_size=128)
        prompt = np.asarray(
            jax.random.randint(jax.random.PRNGKey(51), (5,), 0,
                               cfg.vocab_size))
        ref = generate.generate(qparams, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=5)
        e = eng.Engine(qparams, cfg, max_slots=2, max_ctx=64, page_size=8)
        e.submit(prompt, max_new_tokens=5)
        done = e.run()
        np.testing.assert_array_equal(np.asarray(done[0].out_tokens),
                                      np.asarray(ref[0, 5:]))


class TestGemmaEngine:
    """The engine's hand-rolled _decode_impl must reproduce the gemma2
    feature set (norm offset, embed scaling, q scaling, attn/final
    softcapping, sliding-window layers, sandwich norms) that the
    llama.forward-based prefill already has -- a gemma checkpoint used to
    prefill correctly then decode with llama math (silently wrong
    tokens)."""

    def _gemma_cfg(self):
        return llama.LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16,
            max_position_embeddings=512, tie_word_embeddings=True,
            hidden_act="gelu_pytorch_tanh", rms_norm_offset=1.0,
            embed_scale=8.0, query_pre_attn_scalar=16.0,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
            sliding_window=8, sandwich_norms=True)

    @pytest.mark.parametrize("kv_layout", ["paged", "contig"])
    def test_gemma_engine_matches_generate(self, kv_layout):
        cfg = self._gemma_cfg()
        params = llama.init_params(cfg, jax.random.PRNGKey(5))
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (5, 11, 7)]
        # long enough decode that sliding layers drop early positions
        refs = [np.asarray(generate.generate(
            params, cfg, jnp.asarray(p[None]),
            max_new_tokens=12)[0, len(p):]) for p in prompts]
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                       kv_layout=kv_layout)
        uids = [e.submit(p, max_new_tokens=12) for p in prompts]
        done = e.run(burst=4)
        by_uid = {r.uid: r for r in done}
        for uid, ref in zip(uids, refs):
            np.testing.assert_array_equal(
                np.asarray(by_uid[uid].out_tokens), ref)

    def test_gemma_engine_quantized_kv(self):
        """int8 KV pools take the _dense_attend_q8 path; softcap/window
        must be applied there too (tokens may differ from bf16 KV, so
        compare against a teacher-forced bf16-KV engine is too strict --
        instead check the quantized engine still matches generate when
        the KV error is below the argmax margin on a tiny model)."""
        cfg = self._gemma_cfg()
        params = llama.init_params(cfg, jax.random.PRNGKey(6))
        rng = np.random.RandomState(4)
        prompt = rng.randint(0, cfg.vocab_size, size=6).astype(np.int32)
        ref = np.asarray(generate.generate(
            params, cfg, jnp.asarray(prompt[None]),
            max_new_tokens=8)[0, len(prompt):])
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                       kv_quantize=True, kv_layout="contig")
        e.submit(prompt, max_new_tokens=8)
        done = e.run(burst=4)
        got = np.asarray(done[0].out_tokens)
        # int8 KV introduces quantization error; require the first tokens
        # to agree (argmax margins shrink as error accumulates)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[:4], ref[:4])


class TestMixtralEngine:
    def test_moe_engine_matches_generate(self):
        """The engine serves MoE models: expert layers are detected in
        the param tree and routed through mixtral.moe_ffn in the decode
        step (prefill through mixtral.forward)."""
        from any4.models import mixtral
        cfg = mixtral.MixtralConfig.tiny(vocab=128, layers=2)
        params = mixtral.init_params(cfg, jax.random.PRNGKey(80))
        prompt = np.asarray(
            jax.random.randint(jax.random.PRNGKey(81), (6,), 0,
                               cfg.vocab_size))
        ref = generate.generate(params, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=5)
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8)
        e.submit(prompt, max_new_tokens=5)
        done = e.run()
        np.testing.assert_array_equal(np.asarray(done[0].out_tokens),
                                      np.asarray(ref[0, 6:]))

    def test_moe_engine_quantized(self):
        from any4.models import mixtral
        from any4.quant import api
        cfg = mixtral.MixtralConfig.tiny(vocab=128, layers=1)
        params = mixtral.init_params(cfg, jax.random.PRNGKey(82))
        qparams = api.quantize_model(params, fmt="int4", group_size=32)
        prompt = np.asarray([5, 3, 7], np.int32)
        ref = generate.generate(qparams, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=4)
        e = eng.Engine(qparams, cfg, max_slots=1, max_ctx=32, page_size=8)
        e.submit(prompt, max_new_tokens=4)
        done = e.run()
        np.testing.assert_array_equal(np.asarray(done[0].out_tokens),
                                      np.asarray(ref[0, 3:]))


class TestEngineQuantizedEmbeddings:
    def test_engine_quantized_embeddings_matches_generate(self):
        """Quantized (tied) embedding tables serve end-to-end: the engine's
        decode step gathers token rows from the packed table and runs the
        tied lm_head through the fused quantized kernel -- outputs must
        match sequential generate on the same params exactly."""
        from any4.quant import api
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=128,
                                intermediate_size=256,
                                num_hidden_layers=2,
                                num_attention_heads=2,
                                num_key_value_heads=2, head_dim=64,
                                tie_word_embeddings=True,
                                dtype=jnp.float32)
        params = llama.init_params(cfg, jax.random.PRNGKey(90))
        qparams = api.quantize_model(params, fmt="w4a8", group_size=128,
                                     quantize_embeddings="w8a8")
        prompt = np.asarray(
            jax.random.randint(jax.random.PRNGKey(91), (5,), 0,
                               cfg.vocab_size))
        ref = generate.generate(qparams, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=5)
        e = eng.Engine(qparams, cfg, max_slots=2, max_ctx=64, page_size=8)
        e.submit(prompt, max_new_tokens=5)
        done = e.run()
        np.testing.assert_array_equal(np.asarray(done[0].out_tokens),
                                      np.asarray(ref[0, 5:]))


class TestContigLayout:
    """Contiguous-slot KV layout: gather-free decode over fixed per-slot
    regions (a reshape + slice view). Must reproduce the paged engine's
    tokens exactly -- same math, different memory plan."""

    def test_contig_engine_matches_generate(self, tiny):
        cfg, params = tiny
        prompt = np.asarray(
            jax.random.randint(jax.random.PRNGKey(2), (6,), 0,
                               cfg.vocab_size))
        ref = generate.generate(params, cfg, jnp.asarray(prompt[None]),
                                max_new_tokens=6)
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                       kv_layout="contig")
        assert e.max_ctx == 64 and e.alloc.contiguous
        e.submit(prompt, max_new_tokens=6)
        done = e.run()
        np.testing.assert_array_equal(np.asarray(done[0].out_tokens),
                                      np.asarray(ref[0, 6:]))

    def test_contig_burst_continuous_batching(self, tiny):
        cfg, params = tiny
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (4, 7, 5)]
        refs = [np.asarray(generate.generate(
            params, cfg, jnp.asarray(p[None]),
            max_new_tokens=4)[0, len(p):]) for p in prompts]
        e = eng.Engine(params, cfg, max_slots=2, max_ctx=32, page_size=8,
                       kv_layout="contig")
        uids = [e.submit(p, max_new_tokens=4) for p in prompts]
        done = e.run(burst=2)
        by_uid = {r.uid: r for r in done}
        for uid, ref in zip(uids, refs):
            np.testing.assert_array_equal(
                np.asarray(by_uid[uid].out_tokens), ref)

    def test_flash_contig_matches_dense(self):
        # contig view attention == paged gather attention == numpy
        # softmax over the same pool
        rng = np.random.RandomState(4)
        b, h, rep, d, ps = 2, 2, 2, 32, 8
        max_ctx, ctx_bucket = 512, 64
        pps = max_ctx // ps
        P = b * pps
        k_pages = jnp.asarray(rng.standard_normal((h, P, ps, d))
                              ).astype(jnp.float32)
        v_pages = jnp.asarray(rng.standard_normal((h, P, ps, d))
                              ).astype(jnp.float32)
        table = jnp.asarray(np.arange(P, dtype=np.int32).reshape(b, pps)
                            [:, :ctx_bucket // ps])
        seq_lens = jnp.asarray([37, 20], jnp.int32)
        q = jnp.asarray(rng.standard_normal((b, h * rep, d))
                        ).astype(jnp.float32)
        want = kvc._dense_paged_attention(q, k_pages, v_pages, seq_lens,
                                          table)
        got = kvc.contig_attention(q, k_pages, v_pages, seq_lens, table)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        ref = _np_attention(q, kvc.gather_ctx(k_pages, table),
                            kvc.gather_ctx(v_pages, table), seq_lens)
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-5)

    def test_contig_attention_quantized_pool_impls_agree(self):
        # int8 pools + per-token scales: the contiguous slice view and
        # the paged gather over the same pool agree, and both match the
        # f32 reference over the dequantized pool to bf16 tolerance
        rng = np.random.RandomState(7)
        b, h, rep, d, ps = 2, 2, 2, 32, 8
        max_ctx, ctx_bucket = 128, 64
        pps = max_ctx // ps
        P = b * pps
        kf = rng.standard_normal((h, P, ps, d)).astype(np.float32)
        vf = rng.standard_normal((h, P, ps, d)).astype(np.float32)

        def quantize(x):
            # the engine's writer (write_tokens): to_int8 codes + amax
            amax = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-6)
            return (kvc.to_int8(jnp.asarray(x), jnp.asarray(amax)),
                    jnp.asarray(amax[..., 0], jnp.float32))

        k_pages, v_pages = quantize(kf), quantize(vf)
        table = jnp.asarray(np.arange(P, dtype=np.int32).reshape(b, pps)
                            [:, :ctx_bucket // ps])
        seq_lens = jnp.asarray([50, 23], jnp.int32)
        q = jnp.asarray(rng.standard_normal((b, h * rep, d))
                        ).astype(jnp.float32)
        dense = kvc.contig_attention(q, k_pages, v_pages, seq_lens, table)
        paged = kvc.paged_attention(q, k_pages, v_pages, seq_lens, table)
        np.testing.assert_allclose(np.asarray(dense), np.asarray(paged),
                                   rtol=1e-6, atol=1e-6)
        deq = [kvc.from_int8(c, a[..., None], jnp.float32)
               for c, a in (k_pages, v_pages)]
        ref = _np_attention(q, kvc.gather_ctx(deq[0], table),
                            kvc.gather_ctx(deq[1], table), seq_lens)
        np.testing.assert_allclose(np.asarray(dense), ref,
                                   rtol=2e-2, atol=2e-2)

    def test_contig_engine_with_quantized_kv(self, tiny):
        cfg, params = tiny
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        ref = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8,
                         kv_layout="contig")
        ref.submit(prompt, max_new_tokens=4)
        expect = ref.run()[0].out_tokens
        e = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8,
                       kv_layout="contig", kv_quantize=True)
        e.submit(prompt, max_new_tokens=4)
        got = e.run()[0].out_tokens
        assert len(got) == 4
        assert got[0] == expect[0]  # int8 KV perturbs logits only slightly

    def test_contig_allocator_fixed_ranges(self):
        a = kvc.PageAllocator(4 * 8, 4, 8, contiguous=True)
        assert a.ensure(2, 64, 8)
        assert not a.ensure(2, 65, 8)      # beyond the slot's region
        t0 = a.table.copy()
        a.release(2)
        np.testing.assert_array_equal(a.table, t0)   # ranges never move
        assert a.version == 0


class TestPipelinedBursts:
    """run(pipeline=True) overlaps the token fetch of burst k with the
    dispatch of burst k+1; outputs must equal the sequential engine's."""

    @pytest.mark.parametrize("layout,depth", [("paged", 2), ("contig", 2),
                                              ("contig", 3), ("paged", 4)])
    def test_pipeline_matches_sequential(self, tiny, layout, depth):
        cfg, params = tiny
        rng = np.random.RandomState(9)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (4, 7, 5, 6)]
        want = []
        e0 = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                        kv_layout=layout)
        uids0 = [e0.submit(p, max_new_tokens=6) for p in prompts]
        by0 = {r.uid: r for r in e0.run(burst=2)}
        e1 = eng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                        kv_layout=layout)
        uids1 = [e1.submit(p, max_new_tokens=6) for p in prompts]
        by1 = {r.uid: r for r in e1.run(burst=2, pipeline=True,
                                        pipeline_depth=depth)}
        for u0, u1 in zip(uids0, uids1):
            np.testing.assert_array_equal(
                np.asarray(by0[u0].out_tokens),
                np.asarray(by1[u1].out_tokens))

    def test_pipeline_eos_truncates_speculation(self, tiny):
        cfg, params = tiny
        prompt = np.asarray([5, 9, 3, 7], np.int32)
        e0 = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8)
        e0.submit(prompt, max_new_tokens=12)
        ref = e0.run(burst=2)[0].out_tokens
        eos = ref[3]   # force an EOS mid-run (stops at its FIRST hit)
        want = ref[:ref.index(eos) + 1]
        e1 = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8)
        e1.submit(prompt, max_new_tokens=12, eos_token_id=eos)
        got = e1.run(burst=2, pipeline=True)[0].out_tokens
        assert got == want
        # and the sequential engine agrees
        e2 = eng.Engine(params, cfg, max_slots=1, max_ctx=64, page_size=8)
        e2.submit(prompt, max_new_tokens=12, eos_token_id=eos)
        assert e2.run(burst=2)[0].out_tokens == want


class TestUpstreamQuantizedPages:
    """The int8 pool codec: per-token codes rint(x * 127.5 / amax) with
    3-D [h, P, ps] scale pools, broadcast over head_dim at decode (ps !=
    hd on purpose, so a wrong axis raises)."""

    def test_scale_axis_restored_and_dequant_correct(self):
        h, P, ps, d = 2, 3, 16, 64     # ps != d on purpose
        x = jax.random.normal(jax.random.PRNGKey(0), (h, P, ps, d),
                              jnp.float32)
        amax = jnp.max(jnp.abs(x), axis=-1)              # 3-D [h, P, ps]
        codes = kvc.to_int8(x, amax[..., None])
        assert codes.dtype == jnp.int8
        # one code step of slack: an exact .5 may round either way after
        # f32 rounding of x * 127.5 / amax
        want = np.rint(np.asarray(x) * 127.5 / np.asarray(amax)[..., None])
        assert np.abs(np.asarray(codes, np.float32) - want).max() <= 1
        rec = kvc.from_int8(codes, amax[..., None], jnp.float32)
        assert rec.shape == x.shape
        np.testing.assert_allclose(np.asarray(rec), np.asarray(x),
                                   atol=float(jnp.max(amax)) / 100.0)
