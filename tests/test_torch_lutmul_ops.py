"""Port vs reference: the quantizers, the plain versions of the four kernel
entry points, and the pre-quantized matmul dispatch
(``repro_torch.kernels.lutmul``).

Integer accumulators and the f32 epilogue are compared bitwise: against
``repro.kernels.lutmul.ref`` and against the Pallas kernel bodies run in
interpret mode.  The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda_kernels.py``); on the CPU the wrappers take their
plain versions, which is what this file checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lutmul import ops as jops
from repro.kernels.lutmul import ref as jref
from repro.serve.quantize import quantize_leaf as jquantize_leaf
from repro_torch.kernels.lutmul import kernel, ops, ref

from _torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 2, 1), (5, 6, 3), (8, 128, 128), (13, 130, 70), (3, 258, 129)]


def _bits(x):
    """Raw bits of a float array (bf16 or f32) for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 16, size=(M, K)).astype(np.uint8)
    w = rng.integers(0, 256, size=(K // 2, N)).astype(np.uint8)
    a8 = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    w8 = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    a_s = (rng.random((M, 1)) * 0.1 + 1e-3).astype(np.float32)
    w_s = (rng.random((1, N)) * 0.1 + 1e-3).astype(np.float32)
    return a, w, a8, w8, a_s, w_s


@pytest.fixture(autouse=True)
def _reset_dispatch():
    yield
    ops.set_backend(None)
    ops.set_variant(None)


# ---------------------------------------------------------------------------
# quantizers: codes and scales bitwise, including .5 rounding boundaries
# ---------------------------------------------------------------------------

def _boundary_rows(bits):
    """Rows whose quantized values land exactly on k + 0.5 (round half to
    even decides the code), plus random rows."""
    qmax = 2 ** (bits - 1) - 1
    ks = np.arange(-qmax - 1, qmax, dtype=np.float32)
    rows = []
    for step in (1.0, 0.5, 0.25, 0.375):
        vals = (ks + 0.5) * step                       # on the .5 grid
        row = np.concatenate([vals, [qmax * step]])    # max sets the scale
        rows.append(row)
    width = max(len(r) for r in rows)
    rows = [np.pad(r, (0, width - len(r))) for r in rows]
    rng = np.random.default_rng(3)
    rows += list(rng.standard_normal((4, width)).astype(np.float32) * 3)
    rows.append(np.zeros(width, np.float32))          # all-zero row
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_activations_bitwise(bits):
    x = _boundary_rows(bits)
    jq, js = jops.quantize_activations(jnp.asarray(x), bits)
    tq, ts = ops.quantize_activations(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int8 and ts.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("bits,pack", [(4, False), (4, True), (8, False)])
def test_quantize_weights_bitwise(bits, pack):
    w = np.ascontiguousarray(_boundary_rows(bits).T)       # [K, N]
    if w.shape[0] % 2:
        w = w[:-1]
    jq, js = jops.quantize_weights(jnp.asarray(w), bits, pack=pack)
    before = ops.WEIGHT_QUANT_COUNT
    tq, ts = ops.quantize_weights(torch.from_numpy(w), bits, pack=pack)
    assert ops.WEIGHT_QUANT_COUNT == before + 1
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_quantize_activations_rejects_bits():
    with pytest.raises(ValueError, match="a4 or a8"):
        ops.quantize_activations(torch.zeros((2, 4)), 3)
    with pytest.raises(ValueError, match="nibble packing"):
        ops.quantize_weights(torch.zeros((4, 4)), 8, pack=True)


def test_rounding_is_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 7.0]])
    q, s = ops.quantize_activations(x, 4)
    assert float(s[0, 0]) == 1.0
    assert q[0].tolist() == [0, 2, 2, 0, -2, 7]


# ---------------------------------------------------------------------------
# plain versions == reference oracles == Pallas bodies in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("a_signed", [True, False])
def test_lutmul_plain_matches_reference(M, K, N, a_signed):
    a, w, *_ = _inputs(M, K, N)
    want = np.asarray(jref.lutmul_ref(jnp.asarray(a), jnp.asarray(w),
                                      a_signed))
    want_i = np.asarray(jops.lutmul(jnp.asarray(a), jnp.asarray(w),
                                    a_signed=a_signed, backend="interpret"))
    np.testing.assert_array_equal(want_i, want)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    for got in (ref.lutmul_ref(ta, tw, a_signed),
                kernel.lutmul(ta, tw, a_signed=a_signed),
                ops.lutmul(ta, tw, a_signed=a_signed, backend="ref"),
                ops.lutmul(ta, tw, a_signed=a_signed, backend="cuda")):
        assert got.dtype == torch.int32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("a_signed", [True, False])
def test_lutmul_gather_matches_onehot_and_reference(M, K, N, a_signed):
    """The gather formulation computes the onehot one's sums: both equal
    the reference's gather body in interpret mode."""
    a, w, *_ = _inputs(M, K, N, seed=2)
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    want = np.asarray(jops.lutmul_gather(ja, jw, a_signed=a_signed,
                                         backend="interpret"))
    np.testing.assert_array_equal(
        want, np.asarray(jops.lutmul(ja, jw, a_signed=a_signed,
                                     backend="interpret", impl="onehot")))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    onehot = ops.lutmul(ta, tw, a_signed=a_signed, backend="cuda",
                        impl="onehot")
    for got in (kernel.lutmul_gather(ta, tw, a_signed=a_signed),
                ops.lutmul_gather(ta, tw, a_signed=a_signed),
                ops.lutmul_gather(ta, tw, a_signed=a_signed, backend="ref"),
                ops.lutmul(ta, tw, a_signed=a_signed, backend="cuda",
                           impl="gather")):
        assert got.dtype == torch.int32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, onehot)


def test_lutmul_rejects_unknown_impl():
    a, w, *_ = _inputs(2, 4, 3)
    with pytest.raises(ValueError, match="impl"):
        ops.lutmul(torch.from_numpy(a), torch.from_numpy(w), impl="mxu")


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int_matmul_plain_matches_reference(M, K, N):
    _, _, a8, w8, _, _ = _inputs(M, K, N, seed=1)
    want = np.asarray(jref.int_matmul_ref(jnp.asarray(a8), jnp.asarray(w8)))
    want_i = np.asarray(jops.int_matmul(jnp.asarray(a8), jnp.asarray(w8),
                                        backend="interpret"))
    np.testing.assert_array_equal(want_i, want)
    ta, tw = torch.from_numpy(a8), torch.from_numpy(w8)
    for got in (ref.int_matmul_ref(ta, tw), kernel.int_matmul(ta, tw),
                ops.int_matmul(ta, tw, backend="ref"),
                ops.int_matmul(ta, tw, backend="cuda")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_int_matmul_plain_is_exact_past_float32():
    """The head's worst case, 128 * 128 * 3584 > 2^24: float64 keeps it."""
    K = 3584
    a = torch.full((1, K), -128, dtype=torch.int8)
    w = torch.full((K, 2), -128, dtype=torch.int8)
    w[0, 1] = -127                       # one off: invisible in float32
    got = ref.int_matmul_ref(a, w)
    assert got.tolist() == [[128 * 128 * K, 128 * 128 * K - 128]]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_fused_lut_plain_matches_interpret(M, K, N, out):
    a, w, _, _, a_s, w_s = _inputs(M, K, N, seed=2)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    want = jops._fused_lut(jnp.asarray(a), jnp.asarray(w), jnp.asarray(a_s),
                           jnp.asarray(w_s), a_signed=True, be="interpret",
                           out_dtype=jdt)
    want_r = jref.scaled_lutmul_ref(jnp.asarray(a), jnp.asarray(w),
                                    jnp.asarray(a_s), jnp.asarray(w_s),
                                    out_dtype=jdt)
    np.testing.assert_array_equal(_bits(want), _bits(want_r))
    args = [torch.from_numpy(v) for v in (a, w, a_s, w_s)]
    for got in (ref.scaled_lutmul_ref(*args, out_dtype=tdt),
                kernel.lutmul_fused(*args, out_dtype=tdt),
                ops._fused_lut(*args, a_signed=True, out_dtype=tdt)):
        assert got.dtype == tdt and got.shape == (M, N)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_fused_int_plain_matches_interpret(M, K, N, out):
    _, _, a8, w8, a_s, w_s = _inputs(M, K, N, seed=3)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    want = jops._fused_int(jnp.asarray(a8), jnp.asarray(w8), jnp.asarray(a_s),
                           jnp.asarray(w_s), be="interpret", out_dtype=jdt)
    args = [torch.from_numpy(v) for v in (a8, w8, a_s, w_s)]
    for got in (ref.scaled_int_matmul_ref(*args, out_dtype=tdt),
                kernel.int_matmul_fused(*args, out_dtype=tdt),
                ops._fused_int(*args, out_dtype=tdt)):
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# pre-quantized matmul: the serving dispatch, every backend and variant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,bits", [("w4a4_lut", 4), ("w4a4_mxu", 4),
                                       ("w8a8", 8)])
@pytest.mark.parametrize("backend,variant", [("ref", None),
                                             ("cuda", None),
                                             ("cuda", "unfused")])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prequant_matmul_matches_reference(mode, bits, backend, variant, cd):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    wf = rng.standard_normal((64, 48)).astype(np.float32)
    leaf = jquantize_leaf(jnp.asarray(wf), bits)
    want = jops.prequant_matmul(jnp.asarray(x), leaf["w_q"], leaf["w_scale"],
                                mode=mode, compute_dtype=getattr(jnp, cd),
                                backend="ref")
    ops.set_variant(variant)
    got = ops.prequant_matmul(
        torch.from_numpy(x), torch.from_numpy(np.asarray(leaf["w_q"])),
        torch.from_numpy(np.asarray(leaf["w_scale"])), mode=mode,
        compute_dtype=getattr(torch, cd), backend=backend)
    assert got.shape == (2, 5, 48) and got.dtype == getattr(torch, cd)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mode", ["w4a4_lut", "w4a4_mxu", "w8a8"])
def test_quantized_matmul_matches_reference(mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    want = jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode,
                                 compute_dtype=jnp.float32, backend="ref")
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               mode=mode, compute_dtype=torch.float32,
                               backend="ref")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_prequant_matmul_shape_errors():
    x = torch.zeros((2, 6))
    with pytest.raises(ValueError, match="must be K//2"):
        ops.prequant_matmul(x, torch.zeros((4, 3), dtype=torch.uint8),
                            torch.ones((1, 3)), mode="w4a4_lut")
    with pytest.raises(ValueError, match="even K"):
        ops.lutmul(torch.zeros((2, 5), dtype=torch.uint8),
                   torch.zeros((2, 3), dtype=torch.uint8))
    # a bitplane leaf packed for another K, and a well-formed one
    with pytest.raises(ValueError, match="K % 8"):
        ops.prequant_matmul(x, torch.zeros((2, 1, 3), dtype=torch.uint8),
                            torch.ones((1, 3)), mode="w2a4_tmac")
    with pytest.raises(ValueError, match="must be K//8"):
        ops.prequant_matmul(torch.zeros((2, 16)),
                            torch.zeros((2, 1, 3), dtype=torch.uint8),
                            torch.ones((1, 3)), mode="w2a4_tmac")
    planes = np.full((2, 1, 3), 255, np.uint8)         # every code -1
    y = ops.prequant_matmul(torch.ones((2, 8)), torch.from_numpy(planes),
                            torch.ones((1, 3)), mode="w2a4_tmac",
                            compute_dtype=torch.float32)
    want = jops.prequant_matmul(jnp.ones((2, 8)), jnp.asarray(planes),
                                jnp.ones((1, 3)), mode="w2a4_tmac",
                                compute_dtype=jnp.float32, backend="ref")
    np.testing.assert_array_equal(_bits(y), _bits(want))
    np.testing.assert_allclose(y.numpy(), -8.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# grammar, backend and variant selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["", "none", "w4a4_mxu", "w8a8", "w4a4_lut",
                                  "w2a4_tmac", "w1a8_tmac", "ternary_a4_tmac",
                                  "ternary_a8", "w3a4", "w4a8", "w5a4_tmac",
                                  "w4a6_tmac", "bogus", "w4a4lut"])
def test_parse_mode_matches_reference(mode):
    try:
        want = jops.parse_mode(mode)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            ops.parse_mode(mode)
        assert str(got.value) == str(err)
        return
    assert ops.parse_mode(mode) == want


def test_backend_selection(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    want = "cuda" if torch.cuda.is_available() else "ref"
    assert ops.get_backend() == want
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "cuda")
    assert ops.get_backend() == "cuda"
    ops.set_backend("ref")
    assert ops.get_backend() == "ref"
    with pytest.raises(ValueError, match="unknown backend"):
        ops.set_backend("pallas")
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "interpret")
    ops.set_backend(None)
    with pytest.raises(ValueError, match="REPRO_TORCH_KERNEL_BACKEND"):
        ops.get_backend()


def test_pick_variant_fused_on_cuda_only():
    assert ops.pick_variant("lutmul", 8, 64, 64, "cuda") == "fused"
    assert ops.pick_variant("lutmul", 8, 64, 64, "ref") == "unfused"
    ops.set_variant("unfused")
    assert ops.pick_variant("lutmul", 8, 64, 64, "cuda") == "unfused"
    with pytest.raises(ValueError, match="unknown variant"):
        ops.set_variant("autotune")


def test_cpu_tensors_never_launch():
    kernel.reset_launches()
    a, w, a8, w8, a_s, w_s = (torch.from_numpy(v) for v in _inputs(4, 8, 8))
    kernel.lutmul(a, w)
    kernel.lutmul_fused(a, w, a_s, w_s)
    kernel.int_matmul(a8, w8)
    kernel.int_matmul_fused(a8, w8, a_s, w_s)
    kernel.lutmul_gather(a, w)
    assert set(kernel.LAUNCHES.values()) == {0}
    from repro_torch.kernels.thresholds import kernel as tkernel
    tkernel.reset_launches()
    tkernel.threshold(a8.to(torch.int32), torch.zeros((8, 15)),
                      torch.ones((8,)))
    assert tkernel.LAUNCHES == {"threshold": 0}


def test_product_table_cache_per_device():
    t = kernel.product_table(True, torch.device("cpu"))
    assert t is kernel.product_table(True, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.shape == (16, 16)
    assert int(t[0xF, 0xF]) == 1 and int(t[0x7, 0x8]) == -56
