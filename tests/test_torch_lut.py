"""Port vs reference: product tables, int4 packing and code decoding
(``repro_torch.core.lut``, ``repro_torch.kernels.lutmul.ref.decode_codes``)
— all integer, so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lutmul import ref as jref
from repro_torch.core import lut as tlut
from repro_torch.kernels.lutmul import ref as tref


@pytest.mark.parametrize("a_signed", [False, True])
def test_contraction_table_matches(a_signed):
    want = jlut.contraction_table(a_signed=a_signed)
    got = tlut.contraction_table(a_signed=a_signed)
    assert got.dtype == want.dtype and got.shape == (16, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w_bits,a_bits,w_signed,a_signed",
                         [(4, 4, True, False), (4, 4, True, True),
                          (2, 4, False, False), (4, 8, True, True)])
def test_product_table_matches(w_bits, a_bits, w_signed, a_signed):
    np.testing.assert_array_equal(
        tlut.product_table(w_bits, a_bits, w_signed, a_signed),
        jlut.product_table(w_bits, a_bits, w_signed, a_signed))


def test_table_semantics_row_weight_col_activation():
    t = tlut.contraction_table(a_signed=True)
    for w in range(-8, 8):
        for a in range(-8, 8):
            assert t[w & 0xF, a & 0xF] == w * a


@pytest.mark.parametrize("shape", [(6,), (3, 10), (2, 5, 8)])
def test_pack_int4_matches(shape):
    x = np.random.default_rng(0).integers(-8, 8, size=shape).astype(np.int8)
    want = np.asarray(jlut.pack_int4(jnp.asarray(x)))
    got = tlut.pack_int4(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("signed", [True, False])
def test_unpack_int4_matches(signed):
    p = np.random.default_rng(1).integers(0, 256, size=(7, 9)).astype(
        np.uint8)
    want = np.asarray(jlut.unpack_int4(jnp.asarray(p), signed=signed))
    got = tlut.unpack_int4(torch.from_numpy(p), signed=signed)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_unpack_roundtrip_k_major():
    x = torch.arange(-8, 8, dtype=torch.int8).repeat(3).reshape(3, 16)
    packed = tlut.pack_int4(x)
    assert packed.shape == (3, 8)
    # low nibble = even element
    assert int(packed[0, 0]) == ((-7 & 0xF) << 4) | (-8 & 0xF)
    assert torch.equal(tlut.unpack_int4(packed), x)


def test_pack_int4_odd_axis_raises():
    with pytest.raises(ValueError, match="even"):
        tlut.pack_int4(torch.zeros((3,), dtype=torch.int8))


@pytest.mark.parametrize("bits,signed", [(4, True), (4, False), (8, True),
                                         (3, True)])
def test_decode_codes_matches(bits, signed):
    c = np.random.default_rng(2).integers(0, 256, size=(5, 11)).astype(
        np.uint8)
    want = np.asarray(jref.decode_codes(jnp.asarray(c), bits, signed))
    got = tref.decode_codes(torch.from_numpy(c), bits, signed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
