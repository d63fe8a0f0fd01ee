"""The gather kernel's table and sums, on the CPU.

``csrc/lutmul_gather.cu`` stages the [16, 16] table in shared memory in
the order its lanes read it (``ref.gather_layout``) and makes one table
read per product; ``ref.lutmul_gather_ref`` takes those reads step by
step.  Here the layout is held to the table and to its bank pattern, and
the plain sums are held, exactly, against the reference's
``lutmul_pallas(impl="gather")`` in interpret mode on the same numpy
inputs: the signed and unsigned product tables and random asymmetric
int32 tables, some with entries near +-2^31 so that the sums wrap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lutmul import kernel as jkernel
from repro_torch.kernels.lutmul import kernel, ops, ref

from _torch_threads import one_torch_thread  # noqa: F401

# (bm, bk, bn) blocks of the reference kernel, and (M, K, N) in real rows,
# depth and columns: M and N are padded to the blocks with code 0 (the
# padded outputs are dropped), K is a multiple of bk (a padded k would add
# T[0, 0] to every sum)
BLOCKS = (8, 16, 16)
SHAPES = [(8, 16, 16), (16, 32, 32), (5, 16, 9), (13, 48, 40), (3, 64, 17)]
TABLES = ["signed", "unsigned", "random", "wrapping"]


def _table(kind: str, seed: int) -> np.ndarray:
    if kind in ("signed", "unsigned"):
        return np.asarray(jlut.contraction_table(a_signed=kind == "signed"),
                          dtype=np.int32)
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-5000, 5000, (16, 16)).astype(np.int32)
    t = rng.integers(2 ** 31 - 64, 2 ** 31, (16, 16)).astype(np.int64)
    t[::2] = -t[::2]                       # near -2^31 and +2^31 - 1
    return t.astype(np.int32)


def _pad(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((-(-x.shape[0] // rows) * rows,
                    -(-x.shape[1] // cols) * cols), x.dtype)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _reference_gather(a, w, table):
    bm, bk, bn = BLOCKS
    M, N = a.shape[0], w.shape[1]
    out = jkernel.lutmul_pallas(jnp.asarray(_pad(a, bm, bk)),
                                jnp.asarray(_pad(w, bk // 2, bn)),
                                jnp.asarray(table), bm=bm, bn=bn, bk=bk,
                                impl="gather", interpret=True)
    return np.asarray(out)[:M, :N]


@pytest.mark.parametrize("kind", TABLES)
def test_gather_layout_holds_the_table_conflict_free(kind):
    """T[w, a] sits at word (w << 6) | (g << 4) | a for g = 0, 1; a
    half-warp's reads (one w, 16 codes a) take 16 distinct banks, and the
    two halves' banks are disjoint."""
    table = _table(kind, seed=3)
    lay = ref.gather_layout(torch.from_numpy(table))
    assert lay.dtype == torch.int32 and lay.shape == (1024,)
    words = lay.numpy().reshape(16, 4, 16)
    for g in (0, 1):
        np.testing.assert_array_equal(words[:, g], table)
    assert not words[:, 2:].any()
    a = np.arange(16)
    for w in range(16):
        banks = [set(((w << 6) | (g << 4) | a) % 32) for g in (0, 1)]
        assert banks == [set(range(16)), set(range(16, 32))]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("kind", TABLES)
def test_lutmul_gather_ref_matches_reference_gather(kind, M, K, N):
    """The plain gather equals the reference's gather kernel in interpret
    mode bit for bit, and so do the CPU paths of the wrapper and of
    ``ops.lutmul(impl="gather", table=...)``."""
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    a = rng.integers(0, 16, (M, K)).astype(np.uint8)
    w = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    table = _table(kind, seed=M + K + N)
    want = _reference_gather(a, w, table)
    ta, tw, tt = (torch.from_numpy(v) for v in (a, w, table))
    for got in (ref.lutmul_gather_ref(ta, tw, tt),
                kernel.lutmul_gather(ta, tw, table=tt),
                ops.lutmul(ta, tw, impl="gather", table=tt, backend="ref"),
                ops.lutmul(ta, tw, impl="gather", table=tt, backend="cuda")):
        assert got.dtype == torch.int32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("signed", "unsigned"):
        np.testing.assert_array_equal(
            ref.lutmul_ref(ta, tw, a_signed=kind == "signed").numpy(), want)


def test_wrapping_sums_and_high_nibbles():
    """Sums wrap modulo 2^32 (K = 4 reads of 2^31 - 1 give -4), and an
    activation byte's high nibble is not read."""
    t = torch.full((16, 16), 2 ** 31 - 1, dtype=torch.int32)
    a = torch.full((3, 4), 0x5A, dtype=torch.uint8)
    w = torch.full((2, 5), 0x3C, dtype=torch.uint8)
    assert bool((ref.lutmul_gather_ref(a, w, t) == -4).all())
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(0, 256, (7, 16)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(0, 256, (8, 20)).astype(np.uint8))
    t = torch.from_numpy(_table("random", seed=1))
    np.testing.assert_array_equal(
        ref.lutmul_gather_ref(a, w, t).numpy(),
        _reference_gather(a.numpy() & 0xF, w.numpy(), t.numpy()))


def test_signed_product_table_is_symmetric():
    """Why the tests take the unsigned and random tables too: the signed
    product table equals its transpose, so a transposed staging would pass
    it; the unsigned one does not."""
    signed, unsigned = _table("signed", 0), _table("unsigned", 0)
    np.testing.assert_array_equal(signed, signed.T)
    assert (unsigned != unsigned.T).any()


def test_table_is_the_gather_impls_alone():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    w = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="impl='gather'"):
        ops.lutmul(a, w, table=torch.zeros((16, 16), dtype=torch.int32))
