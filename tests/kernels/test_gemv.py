"""Quantized-linear tests: the 4-bit lookup GEMV kernel in Pallas
interpret mode, and the XLA formulations, on the CPU.

Mirrors the reference's kernel test strategy (tests/tinygemm/):
- ``test_identity_mul``: W = I must reproduce the input exactly
  (test_tinygemm_any4.py:117-139);
- ``test_general_k``: k sweep exercising block-remainder/padding paths
  (test_tinygemm_any4.py:141-163);
- ``test_general_mul``: random weights, checked against the pure-jnp
  dequantize reference (the "fake backend");
- any4 tests negate the LUT to prove the LUT path is actually exercised
  (test_tinygemm_any4.py:24-26).

``INTERPRET`` runs the kernel interpreted; ``tests/test_chip.py`` runs it
compiled on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.ops import linear as lin
from any4.ops import packing, quant
from any4.ops.pallas import gemv

INTERPRET = True
FMTS = ["int4", "any4", "nf4", "fp4", "mx4", "int8"]


def _mm(x, qt, out_dtype=jnp.float32):
    """The production dispatch with the kernel interpreted: row-planar
    4-bit formats at g % 128 == 0 and m <= 16 run the lookup GEMV, every
    other case its XLA formulation."""
    return lin.linear(jnp.asarray(x), qt,
                      interpret=INTERPRET).astype(out_dtype)


def _ref(x, qt):
    wd = lin.dequantize_tensor(qt, dtype=jnp.float32)
    return np.asarray(x, np.float32) @ np.asarray(wd).T


def _assert_close(y, ref, tol=2e-2):
    """Error bounded relative to the output magnitude (the kernel computes
    in bf16 like the reference's tensor-core path, so per-element rtol is
    meaningless for near-zero outputs; reference tests use absolute bounds,
    e.g. test_tinygemm_any4.py avg-error 1e-1)."""
    y = np.asarray(y, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(y / scale, ref / scale, atol=tol, rtol=0)


class TestIdentityMul:
    @pytest.mark.parametrize("fmt", ["int4", "int8"])
    def test_identity(self, fmt):
        k = 1024
        w = jnp.eye(k, dtype=jnp.float32)
        # int4 runs the lookup kernel, which rounds lut*s+z to bf16
        # exactly like the reference's dequantize-to-bf16-then-mma, so
        # identity is EXACT in the bf16 domain (reference
        # test_identity_mul uses torch.equal); row-major int8 runs
        # dequantize-then-dot, equally exact
        qt = lin.quantize_tensor(w, fmt, group_size=128, layout="row")
        x = jax.random.normal(jax.random.PRNGKey(0), (4, k),
                              jnp.float32).astype(jnp.bfloat16)
        y = _mm(x, qt, out_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(
            np.asarray(y.astype(jnp.float32)),
            np.asarray(x.astype(jnp.float32)))

    def test_identity_any4(self):
        # any4's learned LUT reconstructs the identity's 0/1 only to the
        # k-means fit, so identity holds to that fit, not bit-exactly
        k = 1024
        w = jnp.eye(k, dtype=jnp.float32)
        qt = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=25)
        x = jax.random.normal(jax.random.PRNGKey(0), (4, k),
                              jnp.float32).astype(jnp.bfloat16)
        y = _mm(x, qt, out_dtype=jnp.bfloat16)
        np.testing.assert_allclose(
            np.asarray(y.astype(jnp.float32)),
            np.asarray(x.astype(jnp.float32)), rtol=2e-2, atol=2e-2)


class TestGeneralK:
    @pytest.mark.parametrize("k", [1024, 2048, 1536, 2560])
    def test_k_sweep_int4(self, k):
        w = jax.random.normal(jax.random.PRNGKey(1), (128, k))
        # non-multiples of the 1024 pack block exercise the padding path
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(2), (2, k))
        y = _mm(x, qt)
        _assert_close(y, _ref(x, qt))

    @pytest.mark.parametrize("m", [1, 3, 16, 33, 64, 130])
    def test_m_sweep(self, m):
        k, n = 1024, 256
        w = jax.random.normal(jax.random.PRNGKey(3), (n, k))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(4), (m, k))
        y = _mm(x, qt)
        assert y.shape == (m, n)
        _assert_close(y, _ref(x, qt))

    @pytest.mark.parametrize("n", [128, 384, 1000])
    def test_n_padding(self, n):
        k = 1024
        w = jax.random.normal(jax.random.PRNGKey(5), (n, k))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(6), (2, k))
        y = _mm(x, qt)
        assert y.shape == (2, n)
        _assert_close(y, _ref(x, qt))


class TestGeneralMul:
    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("g", [64, 128, 256])
    def test_matches_dequant_reference(self, fmt, g):
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(7), (n, k))
        kw = dict(kmeans_iters=10) if fmt == "any4" else {}
        qt = lin.quantize_tensor(w, fmt, group_size=g, **kw)
        x = jax.random.normal(jax.random.PRNGKey(8), (4, k))
        y = _mm(x, qt)
        ref = _ref(x, qt)
        _assert_close(y, ref)

    @pytest.mark.parametrize("fmt", ["int4", "mx4"])
    @pytest.mark.parametrize("g", [32, 64])
    def test_small_groups(self, fmt, g):
        # g=32 is mx4's DEFAULT group size (quant_methods["mx4"]), so the
        # kernel must be exercised there, not only at g=64
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(9), (n, k))
        qt = lin.quantize_tensor(w, fmt, group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(10), (2, k))
        y = _mm(x, qt)
        _assert_close(y, _ref(x, qt))

    @pytest.mark.parametrize("fmt", ["int4", "any4", "nf4"])
    def test_select_variant_matches_gather(self, fmt):
        # the XLA path decodes codes with a 16-way select chain
        # (dequantize_tensor); the kernel gathers from the table. Both
        # round lut*s+z to bf16 per element, so with bf16 activations
        # the two agree to f32 summation order
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(21), (n, k))
        kw = dict(kmeans_iters=6) if fmt == "any4" else {}
        qt = lin.quantize_tensor(w, fmt, group_size=128, **kw)
        # f32 activations that bf16 represents exactly
        x = jax.random.normal(jax.random.PRNGKey(22), (2, k)
                              ).astype(jnp.bfloat16).astype(jnp.float32)
        yg = lin.linear(x, qt, interpret=True)
        ys = lin.linear(x, qt)
        xb = x
        wb = lin.dequantize_tensor(qt, dtype=jnp.bfloat16).astype(
            jnp.float32)
        ref = np.asarray(xb) @ np.asarray(wb).T
        _assert_close(yg, ref, tol=1e-5)
        _assert_close(ys, ref, tol=5e-3)

    def test_binary_weights_exact(self):
        # W in {0,1}: int4 grouping is exact, so the kernel must match the
        # f32 matmul to float tolerance (reference test_general_mul)
        n, k = 256, 2048
        w = jax.random.bernoulli(jax.random.PRNGKey(11), 0.5,
                                 (n, k)).astype(jnp.float32)
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(12), (4, k))
        y = _mm(x, qt)
        # products with {0,1} weights are exact; compare at the kernel's
        # bf16 input rounding
        xb = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
        ref = xb @ np.asarray(w).T
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-3)


class TestAny4LutIsUsed:
    def test_negated_lut_negates_output(self):
        """Negating LUT and zeros must negate the result -- proving the LUT
        path is used, not the uniform int4 fast path (reference
        test_tinygemm_any4.py:24-26,50-52)."""
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(13), (n, k))
        qt = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=10)
        x = jax.random.normal(jax.random.PRNGKey(14), (2, k))
        y = _mm(x, qt)
        from dataclasses import replace
        qt2 = replace(qt, lut=-qt.lut, zeros=-qt.zeros)
        y2 = _mm(x, qt2)
        np.testing.assert_allclose(np.asarray(y2), -np.asarray(y),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("per_row", [False, True])
    def test_per_row_variants_fused_matches_dequant(self, per_row):
        """Kernel vs dequant parity for BOTH LUT layouts -- the
        reference treats global-LUT any4 as a first-class variant
        (test_tinygemm_any4.py:194-220, per_row in {False, True};
        `Any4_Global_Grouped` dispatch, TinyGemm_int4.cu:622-746)."""
        n, k = 128, 2048
        w = jax.random.normal(jax.random.PRNGKey(40), (n, k))
        qt = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=10,
                                 per_row=per_row)
        # the kernel's row-planar packing: LUT [n, 16] per row or [1, 16]
        assert qt.fmt == "any4"
        assert qt.lut.shape == ((n, 16) if per_row else (1, 16))
        x = jax.random.normal(jax.random.PRNGKey(41), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        ref = _ref(x, qt)
        assert np.isfinite(np.asarray(y, np.float32)).all()
        _assert_close(np.asarray(y, np.float32), ref)

    def test_per_row_luts_differ(self):
        # two rows with identical codes/scales but different LUTs must give
        # different outputs
        n, k, g = 128, 1024, 128
        codes = jax.random.randint(jax.random.PRNGKey(15), (n, k), 0, 16)
        packed = packing.pack_int4(codes.astype(jnp.uint8))
        scales = jnp.ones((k // g, n))   # transposed [k/g, n] layout
        zeros = jnp.zeros((k // g, n))
        lut_a = jnp.tile(jnp.linspace(-1, 1, 16)[None], (n, 1))
        lut_b = lut_a * jnp.arange(1, n + 1, dtype=jnp.float32)[:, None]
        x = jax.random.normal(jax.random.PRNGKey(16), (1, k))
        ya = gemv.lut_gemv(x, packed, scales, zeros, lut_a, group_size=g,
                           interpret=INTERPRET)
        yb = gemv.lut_gemv(x, packed, scales, zeros, lut_b, group_size=g,
                           interpret=INTERPRET)
        # bf16 rounding of LUT values inside the kernel: ~0.4% relative,
        # compared at the common (divided-out) magnitude
        _assert_close(np.asarray(yb)[0] / np.arange(1, n + 1),
                      np.asarray(ya)[0], tol=1e-2)


class TestInt4Pair:
    """Pair-packed int4 (fmt='int4p'): same numbers as int4, a storage
    layout computed through dequantize-then-dot."""

    def test_pack_roundtrip(self):
        codes = jax.random.randint(jax.random.PRNGKey(60), (32, 1536),
                                   0, 16).astype(jnp.uint8)
        packed = packing.pack_int4_pair(codes)
        assert packed.shape == (16, 2048 // 4)
        out = packing.unpack_int4_pair(packed, 1536)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))

    def test_pack_roundtrip_sharded(self):
        codes = jax.random.randint(jax.random.PRNGKey(61), (8, 1024),
                                   0, 16).astype(jnp.uint8)
        packed = packing.pack_int4_pair(codes, shards=2)
        out = packing.unpack_int4_pair(packed, 1024, shards=2)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))

    def test_dequant_matches_int4(self):
        w = jax.random.normal(jax.random.PRNGKey(62), (64, 2048))
        qa = lin.quantize_tensor(w, "int4", group_size=128)
        qb = lin.quantize_tensor(w, "int4p", group_size=128)
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qb, dtype=jnp.float32)))

    @pytest.mark.parametrize("g", [128, 256])
    def test_fused_matches_dequant(self, g):
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(63), (n, k))
        qt = lin.quantize_tensor(w, "int4p", group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(64), (2, k))
        y = _mm(x, qt)
        _assert_close(y, _ref(x, qt))

    def test_identity_near_exact(self):
        """int4p reconstructs the identity exactly, so the dot reproduces
        the input to within 1 bf16 ulp."""
        k = 1024
        w = jnp.eye(k, dtype=jnp.float32)
        qt = lin.quantize_tensor(w, "int4p", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(65), (4, k),
                              jnp.float32).astype(jnp.bfloat16)
        y = _mm(x, qt, out_dtype=jnp.bfloat16)
        np.testing.assert_allclose(
            np.asarray(y.astype(jnp.float32)),
            np.asarray(x.astype(jnp.float32)), rtol=4e-3, atol=1e-5)

    def test_n_k_padding(self):
        n, k = 130, 1408
        w = jax.random.normal(jax.random.PRNGKey(66), (n, k))
        qt = lin.quantize_tensor(w, "int4p", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(67), (1, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        assert y.shape == (1, n)
        _assert_close(np.asarray(y, np.float32), _ref(x, qt)[:, :n])


class TestInt8Pair:
    """Split-byte int8 (fmt='int8p'): same numbers as int8, two nibble
    planes with scales (s, 16s) in the pair-packed layout."""

    def test_dequant_matches_int8(self):
        w = jax.random.normal(jax.random.PRNGKey(70), (32, 1024))
        qa = lin.quantize_tensor(w, "int8", group_size=128)
        qb = lin.quantize_tensor(w, "int8p", group_size=128)
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qb, dtype=jnp.float32)),
            rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("g", [128, 256])
    def test_fused_matches_dequant(self, g):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(71), (n, k))
        qt = lin.quantize_tensor(w, "int8p", group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(72), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        wd = lin.dequantize_tensor(qt, dtype=jnp.float32)
        ref = np.asarray(x, np.float32) @ np.asarray(wd).T
        _assert_close(np.asarray(y, np.float32), ref, tol=5e-3)

    def test_same_bytes_as_int8(self):
        w = jax.random.normal(jax.random.PRNGKey(73), (64, 2048))
        qa = lin.quantize_tensor(w, "int8", group_size=128, layout="row")
        qb = lin.quantize_tensor(w, "int8p", group_size=128)
        assert qb.packed.size * 4 == qa.packed.size  # int32 words vs int8


def _int_emulation(x, qt):
    """float64 emulation of the int8-activation path's exact integer
    group dots + per-group f32 affine:
    ``y = sx * sum_g [P_g s_g + sum(xq_g) z_g]`` over centered codes."""
    xq, sx = lin.quantize_activations(x)
    xq = np.asarray(xq, np.int64)
    codes = np.asarray(lin._grouped_codes(qt), np.int64)   # [G, n, 128]
    G = codes.shape[0]
    g = qt.group_size
    # stored scales are [kp/g, n]; expand to 128-granularity rows
    s = np.repeat(np.asarray(qt.scales, np.float64), g // 128, axis=0)[:G]
    z = np.repeat(np.asarray(qt.zeros, np.float64), g // 128, axis=0)[:G]
    k = xq.shape[1]
    xq = np.pad(xq, ((0, 0), (0, G * 128 - k)))
    ref = np.zeros((xq.shape[0], codes.shape[1]))
    for gi in range(G):
        xg = xq[:, gi * 128:(gi + 1) * 128]
        P = xg @ codes[gi].T
        ref += P * s[gi][None] + xg.sum(axis=1, keepdims=True) * z[gi][None]
    return ref * np.asarray(sx, np.float64)


class TestW4A8:
    """Quad-packed int4 weights x int8 activations (fmt='w4a8'): same
    weight numbers as int4; activations per-row absmax-int8. No reference
    analog (tinygemm is weight-only); the integer group dots are exact,
    so the path must match a float64 emulation of the same integer math
    to f32-accumulation tolerance."""

    def test_pack_roundtrip(self):
        codes = jax.random.randint(jax.random.PRNGKey(80), (32, 1536),
                                   0, 16).astype(jnp.uint8)
        packed = packing.pack_int4_quad(codes)
        assert packed.shape == (8, 2048 // 2)
        out = packing.unpack_int4_quad(packed, 1536)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))

    def test_pack_roundtrip_sharded(self):
        codes = jax.random.randint(jax.random.PRNGKey(81), (8, 1024),
                                   0, 16).astype(jnp.uint8)
        packed = packing.pack_int4_quad(codes, shards=2)
        out = packing.unpack_int4_quad(packed, 1024, shards=2)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))

    def test_dequant_matches_int4(self):
        w = jax.random.normal(jax.random.PRNGKey(82), (64, 2048))
        qa = lin.quantize_tensor(w, "int4", group_size=128)
        qb = lin.quantize_tensor(w, "w4a8", group_size=128)
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qb, dtype=jnp.float32)))

    @pytest.mark.parametrize("g", [128, 256])
    def test_fused_matches_integer_emulation(self, g):
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(83), (n, k))
        qt = lin.quantize_tensor(w, "w4a8", group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(84), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        # the packed codes are 0..15 around the int4 midpoint 8
        codes = np.asarray(packing.unpack_int4_quad(qt.packed, k), np.int64)
        np.testing.assert_array_equal(
            np.asarray(lin._grouped_codes(qt)).transpose(1, 0, 2)
            .reshape(n, -1)[:, :k], codes - 8)
        _assert_close(np.asarray(y, np.float32), _int_emulation(x, qt),
                      tol=1e-4)

    def test_linear_matches_fakequant(self):
        # end-to-end tolerance vs dequantized weights + fake-quantized
        # activations (the semantics the format promises)
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(85), (n, k))
        qt = lin.quantize_tensor(w, "w4a8", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(86), (3, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        xq, sx = lin.quantize_activations(x)
        xd = np.asarray(xq, np.float32) * np.asarray(sx, np.float32)
        wd = np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32))
        _assert_close(np.asarray(y, np.float32), xd @ wd.T, tol=1e-3)

    def test_prefill_chunked_matches_fakequant(self):
        # prefill-shaped m (> _XLA_GROUPED_M_MAX) dequantizes the weight
        # and runs XLA's dot on the float activations; the decode-shaped
        # integer path on each <= _XLA_GROUPED_M_MAX chunk of the same
        # rows differs from it only by the activation quantization
        n, k, m = 128, 1024, lin._XLA_GROUPED_M_MAX + 40
        w = jax.random.normal(jax.random.PRNGKey(87), (n, k))
        qt = lin.quantize_tensor(w, "w4a8", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(88), (m, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        wd = np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32))
        _assert_close(np.asarray(y, np.float32),
                      np.asarray(x, np.float32) @ wd.T, tol=1e-4)
        step = lin._XLA_GROUPED_M_MAX
        chunks = np.concatenate([
            np.asarray(lin.linear(x[i:i + step], qt), np.float32)
            for i in range(0, m, step)])
        xq, sx = lin.quantize_activations(x)
        xd = np.asarray(xq, np.float32) * np.asarray(sx, np.float32)
        _assert_close(chunks, xd @ wd.T, tol=1e-3)
        _assert_close(chunks, np.asarray(y, np.float32), tol=2e-2)

    def test_prefill_3d_batch_shape(self):
        # lead dims flatten and restore around the prefill path
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(96), (n, k))
        qt = lin.quantize_tensor(w, "w4a8", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(97), (2, 160, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        assert y.shape == (2, 160, n)
        wd = np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32))
        _assert_close(np.asarray(y, np.float32),
                      np.einsum("btk,nk->btn", np.asarray(x), wd),
                      tol=1e-4)

    def test_row_sharded(self):
        n, k = 64, 2048
        w = jax.random.normal(jax.random.PRNGKey(89), (n, k))
        qt = lin.quantize_tensor(w, "w4a8", group_size=128, row_shards=2)
        x = jax.random.normal(jax.random.PRNGKey(90), (1, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        q0 = lin.quantize_tensor(w, "w4a8", group_size=128)
        y0 = lin.linear(x, q0, interpret=INTERPRET)
        _assert_close(np.asarray(y, np.float32),
                      np.asarray(y0, np.float32), tol=1e-3)

    @pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
    def test_fused_act_quant_matches_external(self, fmt):
        # decode-shaped m quantizes activations per row (full-row absmax,
        # f32 round/clip) and scales the f32 group sums back by sx; the
        # result must match the float64 integer emulation built on the
        # external quantize_activations at every decode m
        n, k = 128, 4096
        w = jax.random.normal(jax.random.PRNGKey(98), (n, k))
        qt = lin.quantize_tensor(w, "w8a8q" if fmt == "w8a8" else fmt,
                                 group_size=128)
        for m in (1, 16, 64):
            x = jax.random.normal(jax.random.PRNGKey(99 + m), (m, k))
            y = lin.linear(x, qt).astype(jnp.float32)
            _assert_close(np.asarray(y), _int_emulation(x, qt), tol=1e-5)


class TestW8A8:
    """int8 weights x int8 activations (fmt='w8a8'): the packed array IS
    the centered int8 code matrix; one int8 dot per 128-group."""

    def test_dequant_matches_int8(self):
        w = jax.random.normal(jax.random.PRNGKey(91), (32, 1024))
        qa = lin.quantize_tensor(w, "int8", group_size=128)
        qb = lin.quantize_tensor(w, "w8a8", group_size=128)
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qb, dtype=jnp.float32)))

    @pytest.mark.parametrize("g", [128, 256])
    def test_linear_matches_fakequant(self, g):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(92), (n, k))
        qt = lin.quantize_tensor(w, "w8a8", group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(93), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        xq, sx = lin.quantize_activations(x)
        xd = np.asarray(xq, np.float32) * np.asarray(sx, np.float32)
        wd = np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32))
        _assert_close(np.asarray(y, np.float32), xd @ wd.T, tol=1e-3)

    def test_n_k_padding(self):
        n, k = 130, 1408
        w = jax.random.normal(jax.random.PRNGKey(94), (n, k))
        qt = lin.quantize_tensor(w, "w8a8", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(95), (1, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        assert y.shape == (1, n)
        xq, sx = lin.quantize_activations(x)
        xd = np.asarray(xq, np.float32) * np.asarray(sx, np.float32)
        wd = np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32))
        _assert_close(np.asarray(y, np.float32), xd @ wd.T, tol=1e-3)


class TestMx4Nan:
    """MX4 e8m0 NaN semantics (reference test_tinygemm_mx4.py:450
    test_nan + quantize_mx4 NaN exponent storage, utils.py:137-191)."""

    def test_nan_input_poisons_group(self):
        from any4.ops import quant
        w = np.zeros((8, 64), np.float32)
        w[0, 3] = np.nan
        codes, exps = quant.mx4_quantize(jnp.asarray(w), 32)
        exps = np.asarray(exps)
        assert exps[0, 0] == 255           # e8m0 NaN byte
        assert (exps[1:] != 255).all()
        deq = np.asarray(quant.mx4_dequantize(codes, jnp.asarray(exps), 32))
        assert np.isnan(deq[0, :32]).all()  # whole group poisoned
        assert np.isfinite(deq[1:]).all()

    def test_e8m0_nan_byte_decodes_nan(self):
        from any4.ops import quant
        s = np.asarray(quant.mx4_scales(jnp.asarray([[255]], jnp.uint8)))
        assert np.isnan(s).all()
        s254 = np.asarray(quant.mx4_scales(jnp.asarray([[254]], jnp.uint8)))
        assert np.isfinite(s254).all()      # right below NaN stays finite

    def test_kernel_propagates_nan_scale(self):
        """Poison one group's e8m0 exponent post-quantization (the
        reference pokes w_e[0][0]=255) -- the output must go NaN, and stay
        finite at 254. g=32 (mx4's default) runs the XLA path."""
        self._nan_scale(32)

    def test_lookup_kernel_propagates_nan_scale(self):
        # g=128 runs the lookup kernel
        self._nan_scale(128)

    def _nan_scale(self, g):
        from dataclasses import replace
        from any4.ops import quant
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(50), (n, k))
        qt = lin.quantize_tensor(w, "mx4", group_size=g)
        x = jnp.ones((1, k), jnp.float32)
        y0 = np.asarray(_mm(x, qt), np.float32)
        assert np.isfinite(y0).all()
        poisoned = replace(qt, scales=qt.scales.at[0, 0].set(jnp.nan))
        y1 = np.asarray(_mm(x, poisoned), np.float32)
        assert np.isnan(y1[0, 0])
        assert np.isfinite(y1[0, 1:]).all()


class TestLinearDispatch:
    def test_linear_fused_vs_dequant_consistent(self):
        # interpret=True runs the kernel; without it the CPU runs the
        # XLA formulation
        n, k = 256, 1024
        w = jax.random.normal(jax.random.PRNGKey(17), (n, k))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(18), (2, k))
        assert lin.lut_kernel_applies(qt, 2, interpret=True)
        assert not lin.lut_kernel_applies(qt, 2)
        y_fused = lin.linear(x, qt, interpret=INTERPRET)
        y_deq = lin.linear(x, qt)
        _assert_close(np.asarray(y_fused, np.float32),
                      np.asarray(y_deq, np.float32))

    def test_bias_and_batch_dims(self):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(19), (n, k))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        bias = jax.random.normal(jax.random.PRNGKey(20), (n,))
        x = jax.random.normal(jax.random.PRNGKey(21), (2, 3, k))
        y = lin.linear(x, qt, bias=bias, interpret=INTERPRET)
        assert y.shape == (2, 3, n)
        ref = _ref(x.reshape(-1, k), qt).reshape(2, 3, n) + np.asarray(bias)
        _assert_close(np.asarray(y, np.float32), ref)

    def test_dense_weight_passthrough(self):
        w = jax.random.normal(jax.random.PRNGKey(22), (64, 128))
        x = jax.random.normal(jax.random.PRNGKey(23), (2, 128))
        y = lin.linear(x, w)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(x) @ np.asarray(w).T,
                                   rtol=1e-4, atol=1e-5)


class TestQuantizedTensor:
    def test_pytree_roundtrip(self):
        w = jax.random.normal(jax.random.PRNGKey(24), (64, 1024))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        leaves, treedef = jax.tree_util.tree_flatten(qt)
        qt2 = jax.tree_util.tree_unflatten(treedef, leaves)
        # int4 stays in the kernel's row-planar packing
        assert qt2.fmt == "int4" and qt2.shape == (64, 1024)
        np.testing.assert_array_equal(np.asarray(qt2.packed),
                                      np.asarray(qt.packed))

    @pytest.mark.parametrize("fmt", FMTS)
    def test_compression_ratio(self, fmt):
        n, k = 256, 4096
        w = jax.random.normal(jax.random.PRNGKey(25), (n, k))
        kw = dict(kmeans_iters=2) if fmt == "any4" else {}
        g = 32 if fmt == "mx4" else 128
        qt = lin.quantize_tensor(w, fmt, group_size=g, **kw)
        dense_bytes = n * k * 2
        assert qt.nbytes < dense_bytes * (0.45 if "8" not in fmt else 0.85)

    def test_dequantize_matches_pure_math(self):
        w = jax.random.normal(jax.random.PRNGKey(26), (64, 2048))
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        codes, scales, zeros = quant.group_quantize(w, 4, 128)
        expect = quant.group_dequantize(codes, scales, zeros, 4, 128)
        got = lin.dequantize_tensor(qt, dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=1e-5, atol=1e-5)


class TestTransposedLUT:
    """Transposed-layout LUT formats (fmt='any4t'/'nf4t'/'fp4t'): codes
    packed k-major (packing.pack_int4_transposed), a storage layout read
    through dequantize-then-dot. Numbers must match the row-planar
    layout's kernel."""

    def _transposed(self, qt, fmt):
        codes = packing.unpack_int4(qt.packed, qt.shape[1])
        pt = packing.pack_int4_transposed(codes)
        lut_t = (qt.lut.T if qt.lut.shape[0] == qt.shape[0]
                 else qt.lut.reshape(1, 16).T)
        from dataclasses import replace
        return replace(qt, packed=pt, lut=lut_t, fmt=fmt)

    def test_pack_transposed_roundtrip(self):
        codes = jax.random.randint(jax.random.PRNGKey(90), (32, 1536),
                                   0, 16, dtype=jnp.int32).astype(jnp.uint8)
        pt = packing.pack_int4_transposed(codes)
        assert pt.shape == (packing.padded_k(1536) // 8, 32)
        back = packing.unpack_int4_transposed(pt, 1536)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(codes))

    def test_pack_transposed_roundtrip_sharded(self):
        codes = jax.random.randint(jax.random.PRNGKey(91), (16, 2048),
                                   0, 16, dtype=jnp.int32).astype(jnp.uint8)
        pt = packing.pack_int4_transposed(codes, shards=2)
        back = packing.unpack_int4_transposed(pt, 2048, shards=2)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(codes))

    @pytest.mark.parametrize("m", [1, 4])
    def test_any4t_matches_any4(self, m):
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(92), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=4,
                                 layout="row")
        x = jax.random.normal(jax.random.PRNGKey(93), (m, k))
        y_ref = _mm(x, qt)
        y_t = _mm(x, self._transposed(qt, "any4t"))
        _assert_close(y_t, np.asarray(y_ref), tol=5e-3)

    @pytest.mark.parametrize("fmt", ["nf4", "fp4"])
    def test_lut4t_matches_lut4(self, fmt):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(94), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, fmt, group_size=128, layout="row")
        x = jax.random.normal(jax.random.PRNGKey(95), (1, k))
        y_ref = _mm(x, qt)
        y_t = _mm(x, self._transposed(qt, fmt + "t"))
        _assert_close(y_t, np.asarray(y_ref), tol=5e-3)

    def test_any4t_n_k_padding(self):
        # n not a lane multiple + k with a partial pack block (TP shard)
        n, k = 200, 1024
        w = jax.random.normal(jax.random.PRNGKey(96), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=4,
                                 layout="row")
        x = jax.random.normal(jax.random.PRNGKey(97), (1, k))
        y_t = _mm(x, self._transposed(qt, "any4t"))
        ref = _ref(x, qt)
        assert y_t.shape == (1, n)
        _assert_close(y_t, ref, tol=5e-3)

    def test_quantize_tensor_any4t_matches_any4(self):
        # the explicit transposed format: same numbers as any4,
        # transposed packing + [16, n] LUT, dispatched through linear()
        n, k = 128, 2048
        w = jax.random.normal(jax.random.PRNGKey(98), (n, k)) * 0.05
        qa = lin.quantize_tensor(w, "any4", group_size=128, kmeans_iters=4,
                                 seed=0, layout="row")
        qb = lin.quantize_tensor(w, "any4t", group_size=128, kmeans_iters=4,
                                 seed=0)
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qb, dtype=jnp.float32)),
            rtol=1e-5, atol=1e-6)
        x = jax.random.normal(jax.random.PRNGKey(99), (1, k))
        ya = lin.linear(x, qa, interpret=INTERPRET)
        yb = lin.linear(x, qb, interpret=INTERPRET)
        _assert_close(np.asarray(yb, np.float32), np.asarray(ya, np.float32),
                      tol=5e-3)
        assert qb.lut.shape == (16, n)
        assert qb.packed.shape == (packing.padded_k(k) // 8, n)

    def test_any4t_row_shards_dequant(self):
        n, k = 64, 2048
        w = jax.random.normal(jax.random.PRNGKey(100), (n, k)) * 0.05
        qa = lin.quantize_tensor(w, "any4t", group_size=128, kmeans_iters=4,
                                 seed=0)
        qs = lin.quantize_tensor(w, "any4t", group_size=128, kmeans_iters=4,
                                 seed=0, row_shards=2)
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qs, dtype=jnp.float32)),
            rtol=1e-5, atol=1e-6)


class TestTransposedInt8:
    """Transposed int8 formats (fmt='w8a8t'/'int8t';
    packing.pack_int8_transposed, codes [kp, n]) and the k-dependent int8
    routing between the quad and grouped layouts."""

    def test_pack_int8_transposed_roundtrip(self):
        q = jax.random.randint(jax.random.PRNGKey(50), (32, 1536),
                               -128, 128, dtype=jnp.int32).astype(jnp.int8)
        pt = packing.pack_int8_transposed(q)
        assert pt.shape == (packing.padded_k(1536), 32)
        back = packing.unpack_int8_transposed(pt, 1536)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(q))
        ps = packing.pack_int8_transposed(q[:, :1024].reshape(32, 1024), 2)
        back2 = packing.unpack_int8_transposed(ps, 1024, 2)
        np.testing.assert_array_equal(np.asarray(back2),
                                      np.asarray(q[:, :1024]))

    def test_int8_routing_is_k_dependent(self):
        # int8-weight formats route by k: the quad layout below k=4096,
        # the grouped layout from there. All layouts reconstruct
        # identically.
        w = jax.random.normal(jax.random.PRNGKey(51), (64, 1024))
        wl = jax.random.normal(jax.random.PRNGKey(52), (64, 4096)) * 0.1
        for fmt in ("int8", "w8a8"):
            qt = lin.quantize_tensor(w, fmt, group_size=128)
            assert qt.fmt == fmt + "q" and qt.packed.dtype == jnp.int32
            qg = lin.quantize_tensor(wl, fmt, group_size=128)
            assert qg.fmt == fmt + "g" \
                and qg.packed.shape == (32, 64, 128) \
                and qg.packed.dtype == jnp.int8
            qr = lin.quantize_tensor(w, fmt, group_size=128, layout="row")
            assert qr.fmt == fmt
            # same numbers in every layout
            np.testing.assert_allclose(
                np.asarray(lin.dequantize_tensor(qt, dtype=jnp.float32)),
                np.asarray(lin.dequantize_tensor(qr, dtype=jnp.float32)),
                rtol=0, atol=0)
            qgq = lin.quantize_tensor(wl, fmt + "q", group_size=128)
            np.testing.assert_allclose(
                np.asarray(lin.dequantize_tensor(qg, dtype=jnp.float32)),
                np.asarray(lin.dequantize_tensor(qgq, dtype=jnp.float32)),
                rtol=0, atol=0)
        # odd n cannot quad-pack: grouped at any k
        w3 = jax.random.normal(jax.random.PRNGKey(53), (63, 1024))
        assert lin.quantize_tensor(w3, "int8", group_size=128).fmt \
            == "int8g"
        # g < 128 keeps the row-major layout
        q32 = lin.quantize_tensor(w, "int8", group_size=64)
        assert q32.fmt == "int8"

    @pytest.mark.parametrize("fmt", ["int8t", "w8a8t"])
    def test_transposed_variants_match_dequant(self, fmt):
        # explicitly addressable; not the default
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(58), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, fmt, group_size=128)
        assert qt.fmt == fmt and qt.packed.shape == (1024, n)
        x = jax.random.normal(jax.random.PRNGKey(59), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        _assert_close(y, _ref(x, qt), tol=2e-2)

    @pytest.mark.parametrize("fmt", ["int8", "w8a8"])
    @pytest.mark.parametrize("m", [1, 4, 80, 200])
    def test_matches_dequant_reference(self, fmt, m):
        # k=2048 routes to the quad layout (k-dependent routing)
        n, k = 256, 2048
        w = jax.random.normal(jax.random.PRNGKey(52), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, fmt, group_size=128)
        assert qt.fmt.endswith("q")
        x = jax.random.normal(jax.random.PRNGKey(53), (m, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        ref = _ref(x, qt)
        # w8a8 adds per-row int8 activation quantization (~1/127 rel)
        _assert_close(y, ref, tol=2e-2 if fmt == "w8a8" else 5e-3)

    @pytest.mark.parametrize("fmt", ["int8", "w8a8"])
    @pytest.mark.parametrize("m", [1, 80, 200])
    def test_grouped_matches_dequant_reference(self, fmt, m):
        # k=4096 routes to the grouped XLA path; m=200 >
        # _XLA_GROUPED_M_MAX exercises its dequantize fallback
        n, k = 64, 4096
        w = jax.random.normal(jax.random.PRNGKey(54), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, fmt, group_size=128)
        assert qt.fmt.endswith("g")
        x = jax.random.normal(jax.random.PRNGKey(55), (m, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        ref = _ref(x, qt)
        _assert_close(y, ref, tol=2e-2 if fmt == "w8a8" else 5e-3)

    def test_w8a8t_external_act_quant_matches_fused(self):
        # the quad layout's integer group dots on the externally
        # quantized activations: same absmax, same round, same scale
        # point as the float64 emulation
        self._external_act_quant("w8a8q")

    @pytest.mark.parametrize("fmt", ["w8a8t", "w8a8"])
    def test_other_w8a8_layouts_match_emulation(self, fmt):
        # the transposed and row-major layouts unpack to the same codes
        self._external_act_quant(fmt)

    def _external_act_quant(self, fmt):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(54), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, fmt, group_size=128,
                                 layout="row" if fmt == "w8a8" else None)
        assert qt.fmt == fmt
        x = jax.random.normal(jax.random.PRNGKey(55), (2, k))
        y = lin.linear(x, qt).astype(jnp.float32)
        np.testing.assert_allclose(np.asarray(y), _int_emulation(x, qt),
                                   rtol=1e-5, atol=1e-5)

    def test_row_shards_dequant_and_linear(self):
        n, k = 64, 2048
        w = jax.random.normal(jax.random.PRNGKey(56), (n, k)) * 0.05
        qa = lin.quantize_tensor(w, "int8", group_size=128)
        qs = lin.quantize_tensor(w, "int8", group_size=128, row_shards=2)
        np.testing.assert_allclose(
            np.asarray(lin.dequantize_tensor(qa, dtype=jnp.float32)),
            np.asarray(lin.dequantize_tensor(qs, dtype=jnp.float32)),
            rtol=1e-5, atol=1e-6)
        x = jax.random.normal(jax.random.PRNGKey(57), (1, k))
        ya = lin.linear(x, qa, interpret=INTERPRET)
        ys = lin.linear(x, qs, interpret=INTERPRET)
        _assert_close(np.asarray(ys, np.float32), np.asarray(ya, np.float32),
                      tol=5e-3)


class TestAny4Q8:
    """any4q8: the learned per-row LUT snapped to an int8 grid with codes
    MATERIALIZED int8 at pack time -- any4-class accuracy on the int8
    group-dot path (8 bits/weight)."""

    def test_wmse_matches_any4(self):
        n, k = 128, 2048
        w = jax.random.normal(jax.random.PRNGKey(60), (n, k)) * 0.05
        qa = lin.quantize_tensor(w, "any4", group_size=128,
                                 kmeans_iters=8, seed=0)
        q8 = lin.quantize_tensor(w, "any4q8", group_size=128,
                                 kmeans_iters=8, seed=0)
        w0 = np.asarray(w)
        mse_a = float(np.mean((np.asarray(
            lin.dequantize_tensor(qa, dtype=jnp.float32)) - w0) ** 2))
        mse_8 = float(np.mean((np.asarray(
            lin.dequantize_tensor(q8, dtype=jnp.float32)) - w0) ** 2))
        # int8 LUT snapping adds <= (|lut|max/254)^2 of row-scale error
        assert mse_8 <= mse_a * 1.02, (mse_8, mse_a)

    def test_linear_matches_dequant(self):
        n, k = 128, 1024
        w = jax.random.normal(jax.random.PRNGKey(61), (n, k)) * 0.05
        # k < 4096 keeps the quad layout (k-dependent routing)
        qt = lin.quantize_tensor(w, "any4q8", group_size=128,
                                 kmeans_iters=6)
        assert qt.fmt == "any4q8" and qt.lut is None
        assert qt.packed.dtype == jnp.int32
        assert qt.packed.shape == (n // 4, k)
        x = jax.random.normal(jax.random.PRNGKey(62), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        _assert_close(y, _ref(x, qt), tol=2e-2)

    def test_grouped_at_large_k(self):
        # k >= 4096 routes to the grouped layout
        n, k = 64, 4096
        w = jax.random.normal(jax.random.PRNGKey(69), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, "any4q8", group_size=128,
                                 kmeans_iters=4)
        assert qt.fmt == "any4q8g" and qt.lut is None
        assert qt.packed.dtype == jnp.int8
        assert qt.packed.shape == (k // 128, n, 128)
        x = jax.random.normal(jax.random.PRNGKey(70), (2, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        _assert_close(y, _ref(x, qt), tol=2e-2)

    def test_any4q8r_rowscale(self):
        # per-row-scale variant: plain [n, k] int8 + rank-1 affine
        n, k = 64, 1024
        w = jax.random.normal(jax.random.PRNGKey(65), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, "any4q8r", kmeans_iters=8)
        assert qt.fmt == "any4q8r" and qt.packed.shape == (k, n)
        assert qt.packed.dtype == jnp.int8 and qt.scales.shape == (1, n)
        # whole-row any4 is coarser than g=128 but must stay sane: the
        # LUT-snapped reconstruction tracks the weight
        wd = np.asarray(lin.dequantize_tensor(qt, jnp.float32))
        w0 = np.asarray(w)
        assert np.mean((wd - w0) ** 2) < np.mean(w0 ** 2) * 0.05
        for m in (1, 3, 200):
            x = jax.random.normal(jax.random.PRNGKey(66), (m, k))
            y = lin.linear(x, qt)
            _assert_close(y, np.asarray(x, np.float32) @ wd.T, tol=2e-2)

    def test_w8a8r_rowscale_matches_dequant(self):
        n, k = 64, 1024
        w = jax.random.normal(jax.random.PRNGKey(67), (n, k)) * 0.05
        for fmt in ("w8a8r", "int8r"):
            qt = lin.quantize_tensor(w, fmt)
            assert qt.packed.shape == (k, n) and qt.scales.shape == (1, n)
            wd = np.asarray(lin.dequantize_tensor(qt, jnp.float32))
            x = jax.random.normal(jax.random.PRNGKey(68), (2, k))
            y = lin.linear(x, qt)
            _assert_close(y, np.asarray(x, np.float32) @ wd.T, tol=2e-2)

    def test_global_lut_variant(self):
        n, k = 64, 1024
        w = jax.random.normal(jax.random.PRNGKey(63), (n, k)) * 0.05
        qt = lin.quantize_tensor(w, "any4q8", group_size=128,
                                 kmeans_iters=6, per_row=False)
        x = jax.random.normal(jax.random.PRNGKey(64), (1, k))
        y = lin.linear(x, qt, interpret=INTERPRET)
        _assert_close(y, _ref(x, qt), tol=2e-2)


class TestDefaultRouting:
    """Format routing: the 4-bit formats default to the row-planar packing
    the lookup kernel reads; the pair-packed int4 layout and the
    transposed LUT layouts stay addressable with the same numbers."""

    def test_int4_defaults_to_pair_packing(self):
        w = jax.random.normal(jax.random.PRNGKey(1), (64, 256), jnp.float32)
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        assert qt.fmt == "int4"
        qpair = lin.quantize_tensor(w, "int4p", group_size=128)
        assert qpair.fmt == "int4p"
        qt_t = lin.quantize_tensor(w, "nf4", group_size=128,
                                   layout="transposed")
        assert qt_t.fmt == "nf4t"
        # identical numbers in either packing
        np.testing.assert_array_equal(
            np.asarray(lin.dequantize_tensor(qt, jnp.float32)),
            np.asarray(lin.dequantize_tensor(qpair, jnp.float32)))

    def test_int4_row_fallbacks(self):
        # odd n and sub-128 groups keep the planar packing
        w = jax.random.normal(jax.random.PRNGKey(2), (63, 256), jnp.float32)
        assert lin.quantize_tensor(w, "int4", group_size=128).fmt == "int4"
        w2 = jax.random.normal(jax.random.PRNGKey(3), (64, 256), jnp.float32)
        assert lin.quantize_tensor(w2, "int4", group_size=64).fmt == "int4"


class TestChunkedPrefill:
    """Prefill-shaped m (> gemv.M_MAX) runs dequantize-then-dot; the
    kernel over <= M_MAX-row chunks of the same rows must agree with it."""

    @pytest.mark.parametrize("fmt", ["int4", "any4", "nf4"])
    def test_chunked_matches_dequant_path(self, fmt):
        k, n, m = 256, 64, 40
        w = jax.random.normal(jax.random.PRNGKey(4), (n, k), jnp.float32)
        qt = lin.quantize_tensor(w, fmt, group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(5), (m, k), jnp.float32)
        y = np.concatenate([
            np.asarray(lin.linear(x[i:i + gemv.M_MAX], qt,
                                  interpret=INTERPRET))
            for i in range(0, m, gemv.M_MAX)])
        assert not lin.lut_kernel_applies(qt, m, interpret=True)
        ref = lin.linear(x, qt, interpret=INTERPRET)
        assert y.shape == (m, n)
        _assert_close(y, ref)

    def test_chunked_3d_batch_shape(self):
        k, n = 256, 32
        w = jax.random.normal(jax.random.PRNGKey(6), (n, k), jnp.float32)
        qt = lin.quantize_tensor(w, "int4", group_size=128)
        x = jax.random.normal(jax.random.PRNGKey(7), (2, 20, k), jnp.float32)
        y = lin.linear(x, qt, interpret=INTERPRET)
        ref = np.stack([np.concatenate([
            np.asarray(lin.linear(x[i, j:j + gemv.M_MAX], qt,
                                  interpret=INTERPRET))
            for j in range(0, 20, gemv.M_MAX)]) for i in range(2)])
        assert y.shape == (2, 20, n)
        _assert_close(y, ref)


def _random_lut_weight(key, n, k, g=128, table="per_row"):
    """Random codes, scales, zeros and table in the kernel's packing, with
    the bf16-rounded dense weight they reconstruct to."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    codes = jax.random.randint(k1, (n, k), 0, 16).astype(jnp.uint8)
    packed = packing.pack_int4(codes)
    kp = packed.shape[1] * packing.PLANES
    scales = jax.random.uniform(k2, (kp // g, n), jnp.float32, 0.5, 1.5)
    zeros = jax.random.normal(k3, (kp // g, n), jnp.float32) * 0.1
    if table == "per_row":
        lut = jax.random.normal(k4, (n, 16), jnp.float32)
    elif table == "global":
        lut = jax.random.normal(k4, (1, 16), jnp.float32)
    else:
        lut = jnp.asarray(gemv.INT4_RAMP, jnp.float32)[None, :]
    L = np.broadcast_to(np.asarray(lut), (n, 16))
    c = np.asarray(packing.unpack_int4(packed, kp)).astype(np.int64)
    W = np.take_along_axis(L, c, axis=1) \
        * np.repeat(np.asarray(scales).T, g, axis=1) \
        + np.repeat(np.asarray(zeros).T, g, axis=1)
    W = np.asarray(jnp.asarray(W, jnp.float32).astype(jnp.bfloat16)
                   .astype(jnp.float32))[:, :k]
    return (packed, scales, zeros, lut), W


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))


class TestLutGemv:
    """The lookup GEMV kernel itself in interpret mode: the m == 1 body
    and the m <= 16 tensor-core body, row padding, the three kinds of
    table, group sizes, split-k and NaN propagation -- each against the
    bf16 dense weight the codes reconstruct to."""

    @pytest.mark.parametrize("n", [1, 31, 32, 100])
    @pytest.mark.parametrize("m", [1, 2, 16])
    def test_shapes_and_padding(self, n, m):
        k = 1536                      # a partial 1024-wide pack block
        args, W = _random_lut_weight(jax.random.PRNGKey(n), n, k)
        x = jax.random.normal(jax.random.PRNGKey(m), (m, k), jnp.float32)
        y = gemv.lut_gemv(x, *args, group_size=128, interpret=True)
        assert y.shape == (m, n) and y.dtype == jnp.float32
        _assert_close(y, _bf16(x) @ W.T, tol=1e-5)

    @pytest.mark.parametrize("table", ["per_row", "global", "int4"])
    def test_tables(self, table):
        n, k = 64, 2048
        args, W = _random_lut_weight(jax.random.PRNGKey(3), n, k,
                                     table=table)
        x = jax.random.normal(jax.random.PRNGKey(4), (3, k), jnp.float32)
        y = gemv.lut_gemv(x, *args, group_size=128, interpret=True)
        _assert_close(y, _bf16(x) @ W.T, tol=1e-5)

    @pytest.mark.parametrize("g", [128, 256, 1024, 2048])
    def test_group_sizes(self, g):
        n, k = 32, 2048
        args, W = _random_lut_weight(jax.random.PRNGKey(g), n, k, g=g)
        x = jax.random.normal(jax.random.PRNGKey(5), (1, k), jnp.float32)
        y = gemv.lut_gemv(x, *args, group_size=g, interpret=True)
        _assert_close(y, _bf16(x) @ W.T, tol=1e-5)

    @pytest.mark.parametrize("n_blocks,k_blocks,expect", [
        (128, 4, 4),      # 4096 x 4096: every k block its own program
        (192, 4, 2),      # fused qkv
        (1792, 4, 1),     # fused gate/up: enough row blocks already
        (128, 14, 2),     # down projection, k = 14336
        (4008, 4, 1),     # the 128256-row head
        (1, 3, 3),
    ])
    def test_num_splits(self, n_blocks, k_blocks, expect):
        s = gemv.num_splits(n_blocks, k_blocks)
        assert s == expect and k_blocks % s == 0

    def test_split_k_partial_sums(self):
        # few rows, many k blocks: the grid splits k and XLA adds the
        # per-split partial sums
        n, k = 32, 8192
        assert gemv.num_splits(1, k // packing.PACK_BLOCK) == 8
        args, W = _random_lut_weight(jax.random.PRNGKey(6), n, k)
        x = jax.random.normal(jax.random.PRNGKey(7), (2, k), jnp.float32)
        y = gemv.lut_gemv(x, *args, group_size=128, interpret=True)
        _assert_close(y, _bf16(x) @ W.T, tol=1e-5)

    @pytest.mark.parametrize("shards", [2, 4])
    def test_row_shards(self, shards):
        # a row-parallel weight packs each k shard padded on its own; the
        # kernel reads the shard-padded words with shard-aligned x
        n, k = 64, 1536 * shards // 2
        w = jax.random.normal(jax.random.PRNGKey(8), (n, k))
        q1 = lin.quantize_tensor(w, "int4", group_size=128)
        qs = lin.quantize_tensor(w, "int4", group_size=128,
                                 row_shards=shards)
        x = jax.random.normal(jax.random.PRNGKey(9), (1, k))
        _assert_close(lin.linear(x, qs, interpret=True),
                      np.asarray(lin.linear(x, q1, interpret=True)),
                      tol=1e-5)

    def test_nan_activation_propagates(self):
        n, k = 32, 1024
        args, _ = _random_lut_weight(jax.random.PRNGKey(10), n, k)
        x = jnp.ones((1, k), jnp.float32).at[0, 5].set(jnp.nan)
        y = np.asarray(gemv.lut_gemv(x, *args, group_size=128,
                                     interpret=True))
        assert np.isnan(y).all()

    def test_rejects_prefill_shaped_m(self):
        args, _ = _random_lut_weight(jax.random.PRNGKey(11), 32, 1024)
        x = jnp.ones((gemv.M_MAX + 1, 1024), jnp.float32)
        with pytest.raises(AssertionError):
            gemv.lut_gemv(x, *args, group_size=128, interpret=True)


class TestDispatch:
    """linear() runs the kernel on "gpu", XLA on "cpu", and refuses any
    other platform; the kernel takes only its own formats and shapes."""

    @pytest.mark.parametrize("platform,expect", [("gpu", True),
                                                 ("cpu", False)])
    def test_platform_choice(self, monkeypatch, platform, expect):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        qt = lin.quantize_tensor(
            jax.random.normal(jax.random.PRNGKey(0), (32, 256)), "int4")
        assert lin.lut_kernel_applies(qt, 1) is expect

    @pytest.mark.parametrize("platform", ["rocm", "metal"])
    def test_other_platforms_raise(self, monkeypatch, platform):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        qt = lin.quantize_tensor(
            jax.random.normal(jax.random.PRNGKey(0), (32, 256)), "int4")
        with pytest.raises(NotImplementedError):
            lin.linear(jnp.ones((1, 256)), qt)

    @pytest.mark.parametrize("fmt,g,m,expect", [
        ("any4", 128, 1, True), ("nf4", 128, 16, True),
        ("int4", 256, 4, True), ("any4", 64, 1, False),
        ("any4", 128, 17, False), ("any4t", 128, 1, False),
        ("int4p", 128, 1, False), ("w4a8", 128, 1, False),
    ])
    def test_kernel_formats(self, monkeypatch, fmt, g, m, expect):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        kw = dict(kmeans_iters=2) if fmt.startswith("any4") else {}
        qt = lin.quantize_tensor(
            jax.random.normal(jax.random.PRNGKey(1), (32, 512)), fmt,
            group_size=g, **kw)
        assert lin.lut_kernel_applies(qt, m) is expect

    def test_gpu_linear_calls_kernel(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        calls = []

        def fake(x, packed, scales, zeros, lut, *, group_size,
                 interpret=False):
            calls.append((x.shape, packed.shape, lut.shape, group_size))
            return jnp.zeros((*x.shape[:-1], packed.shape[0]), x.dtype)
        monkeypatch.setattr(gemv, "lut_gemv", fake)
        qt = lin.quantize_tensor(
            jax.random.normal(jax.random.PRNGKey(2), (32, 256)), "int4")
        y = lin.linear(jnp.ones((2, 256)), qt)
        assert y.shape == (2, 32)
        assert calls == [((2, 256), (32, 128), (1, 16), 128)]
