"""Tensor-parallel shard_map tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.models import llama
from any4.parallel import tp
from any4.quant import api

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def tiny():
    cfg = llama.LlamaConfig(vocab_size=128, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=8, num_key_value_heads=4,
                            head_dim=8, tie_word_embeddings=True,
                            dtype=jnp.float32)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


class TestTPForward:
    def test_dense_tp_matches_single(self, tiny):
        cfg, params = tiny
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(params, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(params, cfg, ids)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=1e-3, rtol=1e-3)

    def test_quantized_tp_matches_single(self, tiny):
        cfg, params = tiny
        # row-parallel weights must be packed per k-shard so that array
        # sharding splits at logical k boundaries
        qparams = api.quantize_model(params, fmt="int4", group_size=32,
                                     row_parallel_shards=4)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(2), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=5e-2, rtol=5e-2)

    def test_decode_step_with_cache(self, tiny):
        cfg, params = tiny
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(params, mesh)
        step = tp.make_tp_forward(cfg, mesh, specs, with_cache=True)
        from jax.sharding import NamedSharding, PartitionSpec as P
        batch, max_len = 4, 8
        caches = llama.init_kv_caches(cfg, batch, max_len)
        caches = [
            (jax.device_put(k, NamedSharding(mesh, P("dp", None, "tp", None))),
             jax.device_put(v, NamedSharding(mesh, P("dp", None, "tp", None))))
            for k, v in caches]
        token = jnp.zeros((batch,), jnp.int32)
        logits, caches2 = step(sharded, token, jnp.int32(0), caches)
        assert logits.shape == (batch, cfg.vocab_size)
        # reference single-device decode
        ref_caches = llama.init_kv_caches(cfg, batch, max_len)
        positions = jnp.zeros((batch, 1), jnp.int32)
        mask = llama.decode_mask(max_len, jnp.int32(0))
        ref, _ = llama.forward(params, cfg, token[:, None],
                               positions=positions, kv_caches=ref_caches,
                               cache_pos=jnp.int32(0), mask=mask)
        np.testing.assert_allclose(np.asarray(logits, np.float32),
                                   np.asarray(ref[:, -1], np.float32),
                                   atol=1e-3, rtol=1e-3)


class TestFusedTP:
    def test_fused_tp_matches_single(self, tiny):
        """Fused qkv/gateup weights must be interleave-resharded: a
        contiguous P('tp') split would give shard 0 all q rows (ADVICE
        round-1 high finding)."""
        from any4.models import fuse
        cfg, params = tiny
        fused = fuse.fuse_projections(params)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(fused, mesh, cfg=cfg)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(params, cfg, ids)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=1e-3, rtol=1e-3)

    def test_fused_quantized_tp_matches_single(self, tiny):
        from any4.models import fuse
        cfg, params = tiny
        qparams = api.quantize_model(params, fmt="any4", group_size=32,
                                     kmeans_iters=3, row_parallel_shards=4)
        fused = fuse.fuse_projections(qparams)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(fused, mesh, cfg=cfg)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(4), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(fused, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=5e-2, rtol=5e-2)

    def test_fused_without_cfg_rejected(self, tiny):
        from any4.models import fuse
        cfg, params = tiny
        fused = fuse.fuse_projections(params)
        mesh = tp.make_mesh(dp=2, tp=4)
        with pytest.raises(ValueError, match="interleave-reshard"):
            tp.shard_params(fused, mesh)


class TestBiasesTP:
    def test_col_and_row_biases_match_single(self, tiny):
        """q/k/v biases shard over tp; o_proj bias must survive the psum
        exactly once (ADVICE round-1 low findings)."""
        cfg, params = tiny
        from any4.quant.api import _copy_tree
        params = _copy_tree(params)
        key = jax.random.PRNGKey(7)
        hd, nq, nkv = cfg.head_dim_, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        for layer in params["layers"]:
            k1, k2, k3, k4, key = jax.random.split(key, 5)
            layer["q_bias"] = jax.random.normal(k1, (nq * hd,), jnp.float32)
            layer["k_bias"] = jax.random.normal(k2, (nkv * hd,), jnp.float32)
            layer["v_bias"] = jax.random.normal(k3, (nkv * hd,), jnp.float32)
            layer["o_bias"] = jax.random.normal(k4, (cfg.hidden_size,),
                                                jnp.float32)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(params, mesh, cfg=cfg)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(8), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(params, cfg, ids)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=1e-3, rtol=1e-3)


class TestPrefillTP:
    def test_quantized_prefill_dequant_path(self, tiny):
        """m > FUSED_M_MAX routes through dequantize-then-matmul inside
        shard_map; the row-sharded dequant must detect shard-local leaves
        (ADVICE round-1 medium finding)."""
        cfg, params = tiny
        qparams = api.quantize_model(params, fmt="int4", group_size=32,
                                     row_parallel_shards=4)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        t = 40  # local m = 2*40/dp2 = 40 > FUSED_M_MAX
        ids = jax.random.randint(jax.random.PRNGKey(9), (2, t), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=5e-2, rtol=5e-2)


class TestInt4PairTP:
    def test_row_parallel_int4p_matmul(self):
        """Pair-packed int4 under row-parallel sharding: per-shard padded
        packing + psum of partial products matches the unsharded kernel."""
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from any4.ops import linear as lin

        n, k, S = 128, 2560, 2  # k/S = 1280 pads to 2048 per shard
        w = jax.random.normal(jax.random.PRNGKey(20), (n, k))
        qt = lin.quantize_tensor(w, "int4p", group_size=128, row_shards=S)
        x = jax.random.normal(jax.random.PRNGKey(21), (1, k))
        y_ref = lin.linear(x, qt)

        mesh = tp.make_mesh(dp=1, tp=S, devices=jax.devices()[:S])
        qspec = tp._qt_spec("row", qt)
        sharded = jax.tree_util.tree_map(
            lambda leaf, spec: jax.device_put(
                leaf, NamedSharding(mesh, spec)),
            qt, qspec, is_leaf=lambda v: isinstance(v, P))

        def local(xs, q):
            return jax.lax.psum(lin.linear(xs, q), "tp")

        fwd = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(None, "tp"), qspec), out_specs=P(None, None),
            check_vma=False))
        y = fwd(x, sharded)
        np.testing.assert_allclose(np.asarray(y, np.float32),
                                   np.asarray(y_ref, np.float32),
                                   atol=2e-2, rtol=2e-2)


class TestSpecs:
    def test_param_specs_structure(self, tiny):
        cfg, params = tiny
        qparams = api.quantize_model(params, fmt="any4", group_size=32,
                                     kmeans_iters=2)
        specs = tp.param_specs(qparams)
        from jax.sharding import PartitionSpec as P
        qspec = specs["layers"][0]["q_proj"]
        assert qspec.packed == P("tp", None)
        assert qspec.scales == P(None, "tp")
        assert qspec.lut == P("tp", None)
        ospec = specs["layers"][0]["o_proj"]
        assert ospec.packed == P(None, "tp")
        assert ospec.scales == P("tp", None)

    def test_mesh_shapes(self):
        mesh = tp.make_mesh(dp=2, tp=4)
        assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 4
        with pytest.raises(AssertionError):
            tp.make_mesh(dp=3, tp=4)


class TestW4A8TP:
    def test_quantized_tp_matches_single_w4a8(self, tiny):
        """int8-MXU format under full TP: per-shard activation
        quantization (each row-parallel shard absmax-scales its own
        k-slice) is a finer grouping than the single-device full-k
        scaling, so tolerance covers both that and the 4-bit weights.
        w4a8 needs 128-wide groups, so this uses a wider model than the
        shared tiny fixture (per-shard k must be a multiple of 128)."""
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=512,
                                intermediate_size=512, num_hidden_layers=1,
                                num_attention_heads=8,
                                num_key_value_heads=4, head_dim=64,
                                tie_word_embeddings=True,
                                dtype=jnp.float32)
        params = llama.init_params(cfg, jax.random.PRNGKey(39))
        qparams = api.quantize_model(params, fmt="w4a8", group_size=128,
                                     row_parallel_shards=4)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(40), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=8e-2, rtol=8e-2)

    @pytest.mark.parametrize("fmt", ["w8a8g", "w8a8r", "any4q8r"])
    def test_quantized_tp_matches_single_xla_fmts(self, tiny, fmt):
        """Round-5 XLA-dot formats under full TP: the grouped layout
        shards n on packed axis 1 / k on axis 0; the per-row-scale
        layout shards plain [n, k] with replicated per-row scales whose
        rank-1 affine partials psum linearly."""
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=512,
                                intermediate_size=512, num_hidden_layers=1,
                                num_attention_heads=8,
                                num_key_value_heads=4, head_dim=64,
                                tie_word_embeddings=True,
                                dtype=jnp.float32)
        params = llama.init_params(cfg, jax.random.PRNGKey(41))
        kw = dict(kmeans_iters=4) if fmt == "any4q8r" else {}
        qparams = api.quantize_model(params, fmt=fmt, group_size=128,
                                     row_parallel_shards=4, **kw)
        assert qparams["layers"][0]["q_proj"].fmt == fmt
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(42), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=8e-2, rtol=8e-2)

    def test_interleave_rows_grouped_and_rowscale(self):
        """Fused-projection reshard for the XLA-dot layouts (round 5):
        output rows live on packed axis 1 (grouped) / axis 0 (rowscale)."""
        from any4.models.fuse import concat_quantized
        from any4.ops import linear as lin
        from any4.parallel.tp import _interleave_rows
        k, tpn = 256, 2
        for fmt in ("w8a8", "w8a8r"):
            parts = []
            for s in range(2):
                w = jax.random.normal(jax.random.PRNGKey(50 + s), (64, k))
                parts.append(lin.quantize_tensor(w, fmt, group_size=128))
            fused = concat_quantized(parts)
            out = _interleave_rows(fused, [64, 64], tpn)
            ref = np.concatenate(
                [np.asarray(lin.dequantize_tensor(p, dtype=jnp.float32))
                 for p in parts])
            order = np.concatenate([np.r_[0:32, 64:96], np.r_[32:64, 96:128]])
            np.testing.assert_allclose(
                np.asarray(lin.dequantize_tensor(out, dtype=jnp.float32)),
                ref[order], rtol=1e-5, atol=1e-6)

    def test_quantized_embeddings_tp_matches_single(self, tiny):
        """Quantized (tied) embedding tables under TP: the table is
        replicated, the lookup gathers per shard, and the tied lm_head
        runs the fused quantized kernel on replicated weights after the
        last row-parallel psum."""
        cfg, params = tiny
        qparams = api.quantize_model(params, fmt="int4", group_size=32,
                                     row_parallel_shards=4,
                                     quantize_embeddings="int8")
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs)
        ids = jax.random.randint(jax.random.PRNGKey(77), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = llama.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=5e-2, rtol=5e-2)

    def test_interleave_rows_w4a8(self):
        """Fused quad-packed weights permute WORD rows (four logical
        rows each)."""
        from any4.models import fuse
        from any4.ops import linear as lin

        k = 512
        wq = jax.random.normal(jax.random.PRNGKey(41), (64, k))
        wk = jax.random.normal(jax.random.PRNGKey(42), (32, k))
        parts = [lin.quantize_tensor(w, "w4a8", group_size=128)
                 for w in (wq, wk)]
        fused = fuse.concat_quantized(parts)
        out = tp._interleave_rows(fused, [64, 32], 2)
        dense = jnp.concatenate(
            [lin.dequantize_tensor(p, dtype=jnp.float32) for p in parts])
        order = np.concatenate([np.arange(0, 32), np.arange(64, 80),
                                np.arange(32, 64), np.arange(80, 96)])
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(out, dtype=jnp.float32)),
            np.asarray(dense)[order], rtol=1e-6, atol=1e-6)


class TestPairPackedReshard:
    def test_interleave_rows_int4p(self):
        """Fused pair-packed weights permute WORD rows (two logical rows
        each); per-row indexing would scramble the codes silently."""
        import jax.numpy as jnp
        from any4.models import fuse
        from any4.ops import linear as lin

        k = 1024
        wq = jax.random.normal(jax.random.PRNGKey(30), (64, k))
        wk = jax.random.normal(jax.random.PRNGKey(31), (32, k))
        parts = [lin.quantize_tensor(w, "int4p", group_size=128)
                 for w in (wq, wk)]
        fused = fuse.concat_quantized(parts)
        out = tp._interleave_rows(fused, [64, 32], 2)
        dense = jnp.concatenate(
            [lin.dequantize_tensor(p, dtype=jnp.float32) for p in parts])
        order = np.concatenate([np.arange(0, 32), np.arange(64, 80),
                                np.arange(32, 64), np.arange(80, 96)])
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(out, dtype=jnp.float32)),
            np.asarray(dense)[order], rtol=1e-6, atol=1e-6)


class TestMixtralTP:
    """Tensor-parallel MoE: experts split their FFN dim over tp (w1/w3
    column-, w2 row-parallel), router replicated, one psum after the
    routed combine (models/mixtral.moe_ffn)."""

    @pytest.fixture(scope="class")
    def tiny_moe(self):
        from any4.models import mixtral
        cfg = mixtral.MixtralConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, head_dim=8, num_local_experts=4,
            num_experts_per_tok=2, tie_word_embeddings=True,
            dtype=jnp.float32)
        params = mixtral.init_params(cfg, jax.random.PRNGKey(70))
        return cfg, params

    def test_dense_moe_tp_matches_single(self, tiny_moe):
        from any4.models import mixtral
        cfg, params = tiny_moe
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(params, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs,
                                 forward_fn=mixtral.forward)
        ids = jax.random.randint(jax.random.PRNGKey(71), (4, 8), 0,
                                 cfg.vocab_size)
        ref, _ = mixtral.forward(params, cfg, ids)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=1e-3, rtol=1e-3)

    def test_quantized_moe_tp_matches_single(self, tiny_moe):
        from any4.models import mixtral
        cfg, params = tiny_moe
        qparams = api.quantize_model(params, fmt="int4", group_size=32,
                                     row_parallel_shards=4)
        mesh = tp.make_mesh(dp=2, tp=4)
        sharded, specs = tp.shard_params(qparams, mesh)
        fwd = tp.make_tp_forward(cfg, mesh, specs,
                                 forward_fn=mixtral.forward)
        ids = jax.random.randint(jax.random.PRNGKey(72), (2, 8), 0,
                                 cfg.vocab_size)
        ref, _ = mixtral.forward(qparams, cfg, ids, interpret=True)
        out = fwd(sharded, ids)
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=5e-2, rtol=5e-2)
