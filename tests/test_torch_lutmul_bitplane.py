"""The bitplane contraction the CUDA LUT kernel computes, on the CPU.

``csrc/lutmul.cu`` takes the product table as 16 selection words
(``core.lut.contraction_words``: the partial products ``T[w, 1], T[w, 2],
T[w, 4], T[w, 8]`` of each weight code, as int8 bytes) and contracts them
with the 0/1 bitplanes of the activation codes on the int8 tensor cores.
``ref.lutmul_bitplane_ref`` takes the same two stages step by step.  Here
both stages are held, exactly, against the reference: the words against
the columns of its product table, and the plain bitplane form against
``repro.kernels.lutmul.ref.lutmul_ref``, against its ``_onehot_contract``
block body and against ``lutmul_pallas(impl="onehot")`` in interpret mode,
on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lutmul import kernel as jkernel
from repro.kernels.lutmul import ops as jops
from repro.kernels.lutmul import ref as jref
from repro_torch.core import lut as tlut
from repro_torch.kernels.lutmul import kernel, ref

from _torch_threads import one_torch_thread  # noqa: F401

# ragged and CNN-like shapes: K = 16 is MobileNetV2's b1_0 expand, N = 96
# its expand width
SHAPES = [(9, K, N) for K in (16, 30, 96) for N in (1, 17, 96)] + [
    (200, 16, 96), (64, 96, 17)]


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 16, size=(M, K)).astype(np.uint8)
    w = rng.integers(0, 256, size=(K // 2, N)).astype(np.uint8)
    return a, w


def _bytes(words: np.ndarray) -> np.ndarray:
    """int32 [16] words -> int8 [16, 4], byte b = bits 8b .. 8b+7."""
    u = words.astype(np.int64) & 0xFFFFFFFF
    return np.stack([(u >> (8 * b)) & 0xFF for b in range(4)],
                    axis=1).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("a_signed", [True, False])
def test_contraction_words_are_table_columns(a_signed):
    """Byte b of word w is T[w, 2^b] of the reference's table; T[w, 8]
    carries the top bit's sign; every byte fits int8 (|64| at most)."""
    words = tlut.contraction_words(a_signed=a_signed)
    assert words.dtype == np.int32 and words.shape == (16,)
    t = np.asarray(jlut.contraction_table(a_signed=a_signed))
    got = _bytes(words)
    np.testing.assert_array_equal(got, t[:, [1, 2, 4, 8]])
    w = np.where(np.arange(16) >= 8, np.arange(16) - 16, np.arange(16))
    np.testing.assert_array_equal(got[:, 3], (-8 if a_signed else 8) * w)
    assert int(np.abs(got.astype(np.int32)).max()) == 64
    assert words[0] == 0                    # a padded weight code adds 0


def test_product_words_cache_per_device():
    cpu = torch.device("cpu")
    t = kernel.product_words(True, cpu)
    assert t is kernel.product_words(True, cpu)
    assert t is not kernel.product_words(False, cpu)
    assert t.dtype == torch.int32 and t.shape == (16,)
    np.testing.assert_array_equal(t.numpy(),
                                  tlut.contraction_words(a_signed=True))


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("a_signed", [True, False])
def test_bitplane_ref_matches_reference(M, K, N, a_signed):
    a, w = _inputs(M, K, N, seed=M * 1000 + K * 10 + N)
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    want = np.asarray(jref.lutmul_ref(ja, jw, a_signed))
    body = np.asarray(jkernel._onehot_contract(
        ja.astype(jnp.int32), jw,
        jnp.asarray(jlut.contraction_table(a_signed=a_signed))))
    np.testing.assert_array_equal(body, want)
    interp = np.asarray(jops.lutmul(ja, jw, a_signed=a_signed,
                                    backend="interpret", impl="onehot"))
    np.testing.assert_array_equal(interp, want)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    words = kernel.product_words(a_signed, torch.device("cpu"))
    got = ref.lutmul_bitplane_ref(ta, tw, words)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ref.lutmul_ref(ta, tw, a_signed))


@pytest.mark.parametrize("a_code", [8, 15])
@pytest.mark.parametrize("a_signed", [True, False])
def test_bitplane_ref_extreme_codes(a_code, a_signed):
    """Every weight code -8 against activation code 8 or 15: the |64|
    bytes of the words, summed over K."""
    M, K, N = 4, 96, 17
    a = np.full((M, K), a_code, np.uint8)
    w = np.full((K // 2, N), 0x88, np.uint8)
    want = np.asarray(jref.lutmul_ref(jnp.asarray(a), jnp.asarray(w),
                                      a_signed))
    av = a_code - 16 if a_signed and a_code >= 8 else a_code
    assert (want == K * -8 * av).all()
    got = ref.lutmul_bitplane_ref(torch.from_numpy(a), torch.from_numpy(w),
                                  kernel.product_words(a_signed, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
