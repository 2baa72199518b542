"""Native C++ data-plane tests: must agree bit-for-bit with the jnp ops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4 import native
from any4.ops import packing, quant

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain available")


class TestNativePack:
    @pytest.mark.parametrize("k,shards", [(2048, 1), (1536, 1), (4096, 4)])
    def test_matches_jnp_pack(self, k, shards):
        rng = np.random.RandomState(0)
        codes = rng.randint(0, 16, (16, k)).astype(np.uint8)
        got = native.pack_int4(codes, shards)
        expect = np.asarray(packing.pack_int4(jnp.asarray(codes), shards))
        np.testing.assert_array_equal(got, expect)

    def test_roundtrip(self):
        rng = np.random.RandomState(1)
        codes = rng.randint(0, 16, (8, 11008)).astype(np.uint8)
        packed = native.pack_int4(codes)
        out = native.unpack_int4(packed, 11008)
        np.testing.assert_array_equal(out, codes)


class TestNativeQuantize:
    def test_matches_jnp_group_quantize(self):
        rng = np.random.RandomState(2)
        w = rng.randn(32, 1024).astype(np.float32)
        c0, s0, z0 = native.group_quantize(w, 4, 128)
        c1, s1, z1 = quant.group_quantize(jnp.asarray(w), 4, 128)
        np.testing.assert_array_equal(c0, np.asarray(c1))
        np.testing.assert_allclose(s0, np.asarray(s1), rtol=1e-6)
        np.testing.assert_allclose(z0, np.asarray(z1), rtol=1e-6)

    def test_int8(self):
        rng = np.random.RandomState(3)
        w = rng.randn(8, 256).astype(np.float32)
        c0, s0, z0 = native.group_quantize(w, 8, 64)
        c1, s1, z1 = quant.group_quantize(jnp.asarray(w), 8, 64)
        np.testing.assert_array_equal(c0, np.asarray(c1))


class TestNativeQuantizePath:
    def test_quantize_tensor_numpy_input_uses_native_and_matches(self):
        """quantize_tensor on a host numpy array routes through the C++
        data plane and must produce bit-identical packed/scales to the jnp
        path (the native plane is the real pipeline stage for checkpoint
        conversion, not a bystander)."""
        from any4.ops import linear as lin
        rng = np.random.RandomState(5)
        w = rng.randn(64, 1536).astype(np.float32)
        qt_native = lin.quantize_tensor(w, "int4", group_size=128,
                                        row_shards=2)
        qt_jnp = lin.quantize_tensor(jnp.asarray(w), "int4", group_size=128,
                                     row_shards=2)
        np.testing.assert_array_equal(np.asarray(qt_native.packed),
                                      np.asarray(qt_jnp.packed))
        np.testing.assert_allclose(np.asarray(qt_native.scales),
                                   np.asarray(qt_jnp.scales), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(qt_native.zeros),
                                   np.asarray(qt_jnp.zeros), rtol=1e-6)
        assert qt_native.row_shards == 2


class TestNativeLutAssign:
    def test_matches_jnp(self):
        rng = np.random.RandomState(4)
        wg = (rng.rand(8, 512) * 15).astype(np.float32)
        lut = np.sort(rng.rand(8, 16) * 15, axis=1).astype(np.float32)
        got = native.lut_assign(wg, lut)
        d = np.abs(wg[:, :, None] - lut[:, None, :])
        expect = np.argmin(d, axis=2).astype(np.uint8)
        np.testing.assert_array_equal(got, expect)


class TestBf16:
    def test_widening(self):
        vals = np.array([1.0, -2.5, 0.0, 3.14159], np.float32)
        bf = jnp.asarray(vals).astype(jnp.bfloat16)
        raw = np.asarray(bf).view(np.uint16)
        out = native.bf16_to_f32(raw)
        np.testing.assert_array_equal(
            out, np.asarray(bf.astype(jnp.float32)))
