"""Port vs reference, the T-MAC bitplane family
(``repro_torch.kernels.lutmul``): the plane quantizer, the plain versions of
the two tmac entry points, and the tmac dispatch of ``prequant_matmul`` /
``quantized_matmul``.

Integer results are compared exactly and fused bf16/f32 outputs bitwise,
against ``repro.kernels.lutmul.ref.lutmul_tmac_ref`` and the Pallas kernel
bodies run in interpret mode.  Quantizer codes and scales are bitwise for
the int widths.  The ternary and w1 scales are per-channel means: the port
takes them in float64 and rounds once, XLA sums in float32 in its own
order, which lands up to 4 ulp away at these sizes, so they are held to
4 ulp (and their codes exactly at these sizes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.kernels.lutmul import ops as jops
from repro.kernels.lutmul import ref as jref
from repro.serve import quantize as jquant
from repro_torch.core.lut import plane_decomposition
from repro_torch.kernels.lutmul import kernel, ops, ref
from repro_torch.serve import quantize as tquant

from _torch_threads import one_torch_thread  # noqa: F401

SPECS = [1, "ternary", 2, 3, 4]
SHAPES = [(1, 8, 1), (5, 16, 3), (8, 64, 40), (3, 136, 17)]


def _bits(x):
    """Raw bits of a float array (bf16 or f32) for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _inputs(M, K, N, spec, abits, seed=0):
    rng = np.random.default_rng(seed)
    P = plane_decomposition(spec)[0]
    lo = -(1 << (abits - 1))
    a = rng.integers(lo, -lo, size=(M, K)).astype(np.int8)
    planes = rng.integers(0, 256, size=(P, K // 8, N)).astype(np.uint8)
    a_s = (rng.random((M, 1)) * 0.1 + 1e-3).astype(np.float32)
    w_s = (rng.random((1, N)) * 0.1 + 1e-3).astype(np.float32)
    return a, planes, a_s, w_s


@pytest.fixture(autouse=True)
def _reset_dispatch():
    yield
    ops.set_backend(None)
    ops.set_variant(None)


# ---------------------------------------------------------------------------
# the plane quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("shape", [(16, 6), (64, 33), (2, 24, 5)])
def test_quantize_weights_planes_matches(spec, shape):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[..., 0, :] *= 4                                  # absmax rows
    jp, js = jops.quantize_weights_planes(jnp.asarray(w), spec)
    before = ops.WEIGHT_QUANT_COUNT
    tp, ts = ops.quantize_weights_planes(torch.from_numpy(w), spec)
    assert ops.WEIGHT_QUANT_COUNT == before + 1
    assert tp.dtype == torch.uint8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    js = np.asarray(js)
    if spec in ("ternary", 1):           # a mean over K (module docstring)
        np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=4)
    else:
        np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_w4_planes_decode_to_the_nibble_codes():
    """The basis of tmac == lut transcripts: w4 bitplanes decode to exactly
    the codes of the nibble quantizer, with the same scale."""
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 24)).astype(np.float32))
    planes, ps = ops.quantize_weights_planes(w, 4)
    nib, ns = ops.quantize_weights(w, 4)
    codes = ref.decode_planes(ref.unpack_bitplanes(planes), 4)
    assert torch.equal(codes, nib.to(torch.int32))
    assert torch.equal(ps, ns)


def test_quantize_weights_planes_rejects():
    with pytest.raises(ValueError, match="K % 8"):
        ops.quantize_weights_planes(torch.zeros((12, 3)), 2)
    with pytest.raises(ValueError, match="weight bit width"):
        ops.quantize_weights_planes(torch.zeros((16, 3)), 5)


# ---------------------------------------------------------------------------
# the plain versions of the two tmac entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("abits", [4, 8])
def test_tmac_plain_matches_reference(M, K, N, spec, abits):
    a, planes, _, _ = _inputs(M, K, N, spec, abits, seed=K + N)
    g = ops.tmac_group_size(abits)
    want = np.asarray(jref.lutmul_tmac_ref(jnp.asarray(a),
                                           jnp.asarray(planes), spec, g))
    ta, tp = torch.from_numpy(a), torch.from_numpy(planes)
    for got in (ref.lutmul_tmac_ref(ta, tp, spec, g),
                ref.tmac_ref(ta, tp, spec),
                kernel.lutmul_tmac(ta, tp, spec, g=g),
                ops.lutmul_tmac(ta, tp, spec, abits=abits, backend="ref"),
                ops.lutmul_tmac(ta, tp, spec, abits=abits, backend="cuda")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("abits", [4, 8])
def test_tmac_plain_matches_interpret(spec, abits):
    """The Pallas tmac kernel body (interpret mode) gives the same int32."""
    a, planes, _, _ = _inputs(6, 136, 20, spec, abits, seed=7)
    g = ops.tmac_group_size(abits)
    want = np.asarray(jops.lutmul_tmac(jnp.asarray(a), jnp.asarray(planes),
                                       spec, g=g, abits=abits,
                                       backend="interpret"))
    got = ref.tmac_ref(torch.from_numpy(a), torch.from_numpy(planes), spec)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("abits", [4, 8])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_fused_tmac_plain_matches_interpret(spec, abits, out):
    """The fused epilogue bitwise against the Pallas fused tmac body."""
    a, planes, a_s, w_s = _inputs(5, 64, 24, spec, abits, seed=11)
    g = ops.tmac_group_size(abits)
    want = jops._fused_tmac(jnp.asarray(a), jnp.asarray(planes),
                            jnp.asarray(a_s), jnp.asarray(w_s), wbits=spec,
                            g=g, be="interpret",
                            out_dtype=getattr(jnp, out))
    args = [torch.from_numpy(v) for v in (a, planes)]
    scl = [torch.from_numpy(v) for v in (a_s, w_s)]
    td = getattr(torch, out)
    for got in (ref.scaled_tmac_ref(*args, spec, *scl, out_dtype=td),
                kernel.lutmul_tmac_fused(*args, spec, *scl, g=g,
                                         out_dtype=td),
                ops._fused_tmac(*args, *scl, wbits=spec, g=g,
                                out_dtype=td)):
        assert got.dtype == td
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_tmac_shape_and_group_errors():
    a = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="decomposes into 4 planes"):
        ops.lutmul_tmac(a, torch.zeros((2, 2, 3), dtype=torch.uint8), 4)
    with pytest.raises(ValueError, match="must be K//8"):
        ops.lutmul_tmac(a, torch.zeros((2, 1, 3), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="3D"):
        ops.lutmul_tmac(a, torch.zeros((2, 3), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="g=1"):
        ops.lutmul_tmac(a, torch.zeros((2, 2, 3), dtype=torch.uint8), 2,
                        g=2, abits=8)
    with pytest.raises(ValueError, match="K % 8"):
        ops.lutmul_tmac(torch.zeros((2, 12), dtype=torch.int8),
                        torch.zeros((2, 1, 3), dtype=torch.uint8), 2)


@pytest.mark.parametrize("wbits,keep", [(4, 2), (4, 3), (3, 2)])
def test_truncate_planes_matches_and_is_a_view(wbits, keep):
    _, planes, _, _ = _inputs(1, 32, 6, wbits, 4, seed=2)
    want, wk, wm = jops.truncate_planes(jnp.asarray(planes), wbits, keep)
    tp = torch.from_numpy(planes)
    got, gk, gm = ops.truncate_planes(tp, wbits, keep)
    assert (gk, gm) == (wk, wm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() == tp[wbits - keep].data_ptr()
    with pytest.raises(ValueError, match="2 <= keep"):
        ops.truncate_planes(tp, wbits, wbits)


@pytest.mark.parametrize("wbits,abits,K,N", [(1, 8, 4096, 64),
                                             (4, 4, 1024, 32)])
def test_pick_formulation_matches_heuristic(wbits, abits, K, N):
    for spec in SPECS:
        for ab in (4, 8):
            assert ops.pick_formulation(spec, ab, K, N, "ref") == \
                jops.pick_formulation(spec, ab, K, N, backend="ref")


# ---------------------------------------------------------------------------
# serving leaves and the quantized matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w4a4_tmac", "w2a4_tmac", "w3a8_tmac",
                                  "w1a4_tmac", "ternary_a8_tmac",
                                  "ternary_a4", "w2a8", "w4a4"])
def test_quantize_leaf_mode_matches(mode):
    w = np.random.default_rng(5).standard_normal((32, 12)).astype(
        np.float32)
    want = jquant.quantize_leaf_mode(jnp.asarray(w), mode)
    got = tquant.quantize_leaf_mode(torch.from_numpy(w), mode)
    assert sorted(got) == sorted(want)
    mean_scale = ops.parse_mode(mode)[1] in ("ternary", 1)
    for k in want:
        assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype))
        if k == "w_scale" and mean_scale:     # module docstring: 4 ulp
            np.testing.assert_array_max_ulp(got[k].numpy(),
                                            np.asarray(want[k]), maxulp=4)
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    deq = tquant.dequantize_weight(got, torch.float32).numpy()
    jdeq = np.asarray(jquant.dequantize_weight(want, jnp.float32))
    if mean_scale:
        np.testing.assert_array_max_ulp(deq, jdeq, maxulp=4)
    else:
        np.testing.assert_array_equal(deq, jdeq)


@pytest.mark.parametrize("mode", ["w4a4_tmac", "w2a4_tmac", "w3a8_tmac",
                                  "w1a4_tmac", "ternary_a8_tmac",
                                  "w1a8_tmac"])
@pytest.mark.parametrize("backend,variant", [("ref", None),
                                             ("cuda", "fused"),
                                             ("cuda", "unfused")])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prequant_matmul_tmac_matches_reference(mode, backend, variant, cd):
    """The same bitplane leaf and input through both packages: bitwise."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    leaf = jquant.quantize_leaf_mode(jnp.asarray(w), mode)
    want = jops.prequant_matmul(jnp.asarray(x), leaf["w_q"],
                                leaf["w_scale"], mode=mode,
                                compute_dtype=getattr(jnp, cd),
                                backend="ref")
    ops.set_variant(variant)
    got = ops.prequant_matmul(torch.from_numpy(x),
                              torch.from_numpy(np.array(leaf["w_q"])),
                              torch.from_numpy(np.array(leaf["w_scale"])),
                              mode=mode, compute_dtype=getattr(torch, cd),
                              backend=backend)
    assert got.shape == (2, 3, 24)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mode", ["w4a4_tmac", "w2a4", "ternary_a8_tmac",
                                  "w1a8_tmac"])
def test_quantized_matmul_tmac_matches_reference(mode):
    """Dynamic quantization through the tmac formulation: the int widths
    bitwise; ternary/w1 within 4 ulp (their mean-|w| scale, module
    docstring)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    want = np.asarray(jops.quantized_matmul(
        jnp.asarray(x), jnp.asarray(w), mode=mode,
        compute_dtype=jnp.float32, backend="ref"))
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               mode=mode, compute_dtype=torch.float32,
                               backend="ref").numpy()
    if ops.parse_mode(mode)[1] in ("ternary", 1):
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_jax_codes_through_the_port_bitwise():
    """The reference quantizer's own ternary codes and scale fed to the
    port: the outputs are bitwise, whatever ulp the two means differ by."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((128, 40)).astype(np.float32)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    leaf = jquant.quantize_leaf_mode(jnp.asarray(w), "ternary_a8_tmac")
    want = jops.prequant_matmul(jnp.asarray(x), leaf["w_q"],
                                leaf["w_scale"], mode="ternary_a8_tmac",
                                compute_dtype=jnp.bfloat16, backend="ref")
    tleaf = {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
    from repro_torch.models.layers import linear
    got = linear(tleaf, torch.from_numpy(x), "w4a8_tmac", torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cpu_tmac_tensors_never_launch():
    kernel.reset_launches()
    a, planes, a_s, w_s = (torch.from_numpy(v) for v in
                           _inputs(3, 16, 4, 2, 4))
    kernel.lutmul_tmac(a, planes, 2)
    kernel.lutmul_tmac_fused(a, planes, 2, a_s, w_s)
    assert kernel.LAUNCHES["lutmul_tmac"] == 0
    assert kernel.LAUNCHES["lutmul_tmac_fused"] == 0


def test_plane_codes_decode_like_reference():
    _, planes, _, _ = _inputs(1, 24, 5, 3, 4, seed=1)
    want = np.asarray(jlut.decode_planes(
        jlut.unpack_bitplanes(jnp.asarray(planes)), 3))
    got = ref.decode_planes(ref.unpack_bitplanes(torch.from_numpy(planes)),
                            3)
    np.testing.assert_array_equal(got.numpy(), want)
