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

from _torch_threads import one_torch_thread  # noqa: F401


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


# ---------------------------------------------------------------------------
# the T-MAC bitplane format
# ---------------------------------------------------------------------------

SPECS = [1, "ternary", 2, 3, 4]


@pytest.mark.parametrize("spec", SPECS)
def test_plane_decomposition_matches(spec):
    assert tlut.plane_decomposition(spec) == jlut.plane_decomposition(spec)
    assert tlut.weight_bits(spec) == jlut.weight_bits(spec)


@pytest.mark.parametrize("bad", [0, 5, 8, 1.58, "binary", None])
def test_validate_weight_bits_same_errors(bad):
    with pytest.raises(ValueError) as want:
        jlut.validate_weight_bits(bad)
    with pytest.raises(ValueError) as got:
        tlut.validate_weight_bits(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,keep", [(4, 2), (4, 3), (3, 2), (2, 2),
                                       (4, 4), (4, 1), ("ternary", 2),
                                       (1, 1)])
def test_truncate_plane_spec_matches(spec, keep):
    try:
        want = jlut.truncate_plane_spec(spec, keep)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tlut.truncate_plane_spec(spec, keep)
        assert str(got.value) == str(err)
        return
    assert tlut.truncate_plane_spec(spec, keep) == want


def _codes(spec, shape, seed=0):
    rng = np.random.default_rng(seed)
    if spec == "ternary":
        return rng.integers(-1, 2, size=shape)
    if spec == 1:
        return rng.choice([-1, 1], size=shape)
    return rng.integers(-(1 << (spec - 1)), 1 << (spec - 1), size=shape)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("shape", [(8, 3), (2, 16, 5)])
def test_planes_from_codes_and_back_match(spec, shape):
    codes = _codes(spec, shape).astype(np.int32)
    want = np.asarray(jlut.planes_from_codes(jnp.asarray(codes), spec))
    got = tlut.planes_from_codes(torch.from_numpy(codes), spec)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    dec = tlut.decode_planes(got, spec)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), codes)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jlut.decode_planes(jnp.asarray(want), spec)))


@pytest.mark.parametrize("shape", [(8, 1), (24, 7), (3, 16, 9)])
def test_pack_unpack_bitplanes_match(shape):
    bits = np.random.default_rng(2).integers(0, 2, size=shape).astype(
        np.uint8)
    want = np.asarray(jlut.pack_bitplanes(jnp.asarray(bits)))
    got = tlut.pack_bitplanes(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tlut.unpack_bitplanes(got).numpy(), bits)
    np.testing.assert_array_equal(
        tlut.unpack_bitplanes(got).numpy(),
        np.asarray(jlut.unpack_bitplanes(jnp.asarray(want))))


def test_bitplane_layout_bit_i_of_byte_j_is_row_8j_plus_i():
    bits = torch.zeros((16, 2), dtype=torch.uint8)
    bits[11, 1] = 1                                  # byte 1, bit 3
    packed = tlut.pack_bitplanes(bits)
    assert packed.tolist() == [[0, 0], [0, 8]]
    with pytest.raises(ValueError, match="K % 8"):
        tlut.pack_bitplanes(torch.zeros((12, 2), dtype=torch.uint8))
