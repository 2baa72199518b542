"""Packed-layout round-trip tests (the analog of the reference's
tests/tinygemm/test_tinygemm_convert.py:20-96 layout round trips)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from any4.ops import packing


class TestPackInt4:
    @pytest.mark.parametrize("k", [1024, 2048, 4096])
    def test_roundtrip_exact_tiles(self, k):
        codes = jax.random.randint(
            jax.random.PRNGKey(0), (16, k), 0, 16).astype(jnp.uint8)
        packed = packing.pack_int4(codes)
        assert packed.shape == (16, k // 8) and packed.dtype == jnp.int32
        out = packing.unpack_int4(packed, k)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))

    @pytest.mark.parametrize("k", [640, 1536, 11008])
    def test_roundtrip_padded(self, k):
        codes = jax.random.randint(
            jax.random.PRNGKey(1), (4, k), 0, 16).astype(jnp.uint8)
        packed = packing.pack_int4(codes)
        kp = packing.padded_k(k)
        assert packed.shape == (4, kp // 8)
        out = packing.unpack_int4(packed, k)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))
        # padded region must unpack to code 0
        full = packing.unpack_int4(packed, kp)
        assert (np.asarray(full)[:, k:] == 0).all()

    def test_planar_layout_definition(self):
        """Pin the physical layout: nibble j of word [r, b*128 + l]
        holds codes[r, b*1024 + j*128 + l]."""
        k = 2048
        codes = np.random.RandomState(0).randint(0, 16, (2, k)).astype(np.uint8)
        packed = np.asarray(packing.pack_int4(jnp.asarray(codes)))
        for n in range(2):
            for (b, j, l) in [(0, 0, 0), (0, 3, 17), (1, 7, 127), (1, 5, 64)]:
                word = packed[n, b * 128 + l]
                nib = (word >> (4 * j)) & 0xF
                assert nib == codes[n, b * 1024 + j * 128 + l]

    def test_pad_group_arrays(self):
        scales = jnp.ones((4, 11008 // 128))
        zeros = jnp.ones((4, 11008 // 128))
        s, z = packing.pad_group_arrays(scales, zeros, 11008, 128)
        assert s.shape == (4, packing.padded_k(11008) // 128)
        assert (np.asarray(s)[:, 86:] == 0).all()
