"""The CUDA T-MAC kernel's in-register decode, on the CPU.

``csrc/lutmul_tmac.cu`` turns each lane's plane bytes into int8x4 A words
(the weight codes shifted up so the top bit slot is the sign bit) and
contracts them once on the int8 tensor cores.  ``ref.tmac_words`` performs
the same word operations in the same lane and k-slot order, and
``ref.tmac_words_ref`` the contraction on them.  Here both are held,
exactly, against the port's plain version (``ref.tmac_ref``), the
reference's planes decode and its group-table oracle, and the Pallas tmac
kernels run in interpret mode, on the same numpy inputs: every weight spec,
the drafter's truncated stacks, extreme codes, K not a multiple of 32.
Fused outputs are compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lutmul import ops as jops
from repro.kernels.lutmul import ref as jref
from repro_torch.core.lut import (decode_planes, plane_decomposition,
                                  unpack_bitplanes)
from repro_torch.kernels.lutmul import ops, ref

from _torch_threads import one_torch_thread  # noqa: F401

SPECS = [1, "ternary", 2, 3, 4]
# K = 40, 72, 136 are not multiples of the kernel's 32-deep step
SHAPES = [(1, 8, 1), (3, 40, 20), (9, 72, 17), (5, 136, 33)]


def _inputs(M, K, N, spec, abits, seed):
    rng = np.random.default_rng(seed)
    P = plane_decomposition(spec)[0]
    lo = -(1 << (abits - 1))
    a = rng.integers(lo, -lo, size=(M, K)).astype(np.int8)
    planes = rng.integers(0, 256, size=(P, K // 8, N)).astype(np.uint8)
    a_s = (rng.random((M, 1)) * 0.1 + 1e-3).astype(np.float32)
    w_s = (rng.random((1, N)) * 0.1 + 1e-3).astype(np.float32)
    return a, planes, a_s, w_s


def _word_bytes(words: torch.Tensor) -> np.ndarray:
    """int32 A words [K//8, N, 2] -> int8 codes [K, N] (k = 8j + 4h + i
    for byte i of word (j, n, h))."""
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    b = np.stack([(u >> (8 * i)) & 0xFF for i in range(4)], axis=-1)
    KB, N = u.shape[:2]
    return b.astype(np.uint8).view(np.int8).transpose(0, 2, 3, 1) \
        .reshape(8 * KB, N)


def _interpret(a, planes, spec, abits):
    return np.asarray(jops.lutmul_tmac(jnp.asarray(a), jnp.asarray(planes),
                                       spec, g=ops.tmac_group_size(abits),
                                       abits=abits, backend="interpret"))


def test_tmac_shift_puts_the_top_slot_on_the_sign_bit():
    assert [ref.tmac_shift(s) for s in SPECS] == [6, 6, 6, 5, 4]
    for spec in (2, 3, 4):          # the top plane alone is -2^(P-1)
        P = plane_decomposition(spec)[0]
        planes = torch.zeros((P, 1, 4), dtype=torch.uint8)
        planes[-1] = 0xFF
        assert (_word_bytes(ref.tmac_words(planes, spec)) == -128).all()


@pytest.mark.parametrize("spec", SPECS)
def test_words_lane_and_slot_order(spec):
    """One plane bit at (k, n) lands in word (k // 8, n, (k % 8) // 4), byte
    k % 4 — the A register and k slot of lane tig = (k // 8) % 4 — and
    nowhere else."""
    K, N = 64, 12
    P = plane_decomposition(spec)[0]
    base = torch.zeros((P, K // 8, N), dtype=torch.uint8)
    w0 = _word_bytes(ref.tmac_words(base, spec)).astype(np.int32)
    for k, n in ((0, 0), (5, 3), (13, 7), (30, 11), (63, 4)):
        planes = base.clone()
        planes[0, k // 8, n] = 1 << (k % 8)
        w = _word_bytes(ref.tmac_words(planes, spec)).astype(np.int32)
        diff = np.argwhere(w != w0)
        assert diff.tolist() == [[k, n]], (spec, k, n)
        word = ref.tmac_words(planes, spec)[k // 8, n, (k % 8) // 4]
        assert (int(word) >> (8 * (k % 4))) & 0xFF != 0


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("spec", SPECS)
def test_words_are_shifted_codes(spec, M, K, N):
    """Each A byte is the weight code shifted up by ``tmac_shift``: the
    port's and the reference's plane decode, exactly; the bits below the
    shift are zero."""
    _, planes, _, _ = _inputs(M, K, N, spec, 4, seed=K + N)
    tp = torch.from_numpy(planes)
    got = _word_bytes(ref.tmac_words(tp, spec)).astype(np.int32)
    sh = ref.tmac_shift(spec)
    assert not (got & ((1 << sh) - 1)).any()
    want = decode_planes(unpack_bitplanes(tp), spec).numpy()
    np.testing.assert_array_equal(got >> sh, want)
    jwant = np.asarray(jlut.decode_planes(
        jlut.unpack_bitplanes(jnp.asarray(planes)), spec))
    np.testing.assert_array_equal(got >> sh, jwant)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("abits", [4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_words_ref_matches_reference(spec, abits, M, K, N):
    """The contraction on the decoded words against the plain version,
    the reference's group-table oracle and the Pallas kernel in interpret
    mode."""
    a, planes, _, _ = _inputs(M, K, N, spec, abits, seed=M * K + N)
    g = ops.tmac_group_size(abits)
    want = _interpret(a, planes, spec, abits)
    np.testing.assert_array_equal(
        np.asarray(jref.lutmul_tmac_ref(jnp.asarray(a), jnp.asarray(planes),
                                        spec, g)), want)
    ta, tp = torch.from_numpy(a), torch.from_numpy(planes)
    got = ref.tmac_words_ref(ta, tp, spec)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ref.tmac_ref(ta, tp, spec))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", SPECS)
def test_words_fused_matches_interpret(spec, out):
    """The fused epilogue on the words' sums, bitwise against the Pallas
    fused tmac kernel in interpret mode."""
    abits = 8 if spec == "ternary" else 4
    a, planes, a_s, w_s = _inputs(5, 72, 24, spec, abits, seed=17)
    want = jops._fused_tmac(jnp.asarray(a), jnp.asarray(planes),
                            jnp.asarray(a_s), jnp.asarray(w_s), wbits=spec,
                            g=ops.tmac_group_size(abits), be="interpret",
                            out_dtype=getattr(jnp, out))
    acc = ref.tmac_words_ref(torch.from_numpy(a), torch.from_numpy(planes),
                             spec)
    got = ref.dequant_epilogue(acc, torch.from_numpy(a_s),
                               torch.from_numpy(w_s), getattr(torch, out))
    bits = np.int16 if out == "bfloat16" else np.int32
    t_bits = torch.int16 if out == "bfloat16" else torch.int32
    np.testing.assert_array_equal(got.view(t_bits).numpy(),
                                  np.asarray(want).view(bits))


@pytest.mark.parametrize("abits", [4, 8])
@pytest.mark.parametrize("keep", [2, 3])
def test_words_drafter_views(keep, abits):
    """The drafter's top planes of a w4 stack (a view at an offset, served
    as a ``keep``-bit stack): the words' sums against the Pallas kernel on
    the reference's own truncation, and the scale multiple."""
    a, planes, _, _ = _inputs(8, 72, 20, 4, abits, seed=keep)
    view, kspec, mult = ops.truncate_planes(torch.from_numpy(planes), 4, keep)
    jview, jspec, jmult = jops.truncate_planes(jnp.asarray(planes), 4, keep)
    assert (kspec, mult) == (jspec, jmult) == (keep, 1 << (4 - keep))
    assert view.storage_offset() == (4 - keep) * planes[0].size
    want = _interpret(a, np.asarray(jview), jspec, abits)
    got = ref.tmac_words_ref(torch.from_numpy(a), view, kspec)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("abits", [4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_words_extreme_codes(spec, abits):
    """All-ones planes (w = -1 for the int widths, 0 for ternary, +1 for
    w1) against the most negative activation code (-8 at a4, -128 at a8),
    K = 136."""
    M, K, N = 4, 136, 9
    P = plane_decomposition(spec)[0]
    lo = -(1 << (abits - 1))
    a = np.full((M, K), lo, np.int8)
    planes = np.full((P, K // 8, N), 0xFF, np.uint8)
    w = {1: 1, "ternary": 0}.get(spec, -1)
    want = _interpret(a, planes, spec, abits)
    assert (want == K * lo * w).all()
    got = ref.tmac_words_ref(torch.from_numpy(a), torch.from_numpy(planes),
                             spec)
    np.testing.assert_array_equal(got.numpy(), want)
