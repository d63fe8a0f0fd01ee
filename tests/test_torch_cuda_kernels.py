"""The CUDA kernels on the card against their plain versions: int32
outputs exactly, fused outputs bitwise, at ragged shapes and at the K-split
and single-pass launch geometries.  Every test needs a CUDA GPU (marker
``gpu``) and skips elsewhere; the file imports no JAX, so it runs on a GPU
machine with ``python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lut import plane_decomposition
from repro_torch.kernels.lutmul import kernel, ops, ref

SHAPES = [(1, 2, 1), (5, 6, 3), (8, 128, 128), (13, 130, 70), (3, 258, 129),
          (8, 3584, 512), (20, 1030, 77), (64, 512, 96), (8, 18944, 64)]


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 16, size=(M, K)).astype(np.uint8)
    w = rng.integers(0, 256, size=(K // 2, N)).astype(np.uint8)
    a8 = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    w8 = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    a_s = (rng.random((M, 1)) * 0.1 + 1e-3).astype(np.float32)
    w_s = (rng.random((1, N)) * 0.1 + 1e-3).astype(np.float32)
    return a, w, a8, w8, a_s, w_s


# ---------------------------------------------------------------------------
# the CUDA kernels themselves (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, M, K, N):
    a, w, a8, w8, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                              for v in _inputs(M, K, N, seed=6))
    kernel.reset_launches()
    assert torch.equal(kernel.lutmul(a, w), ref.lutmul_ref(a, w))
    assert torch.equal(kernel.int_matmul(a8, w8), ref.int_matmul_ref(a8, w8))
    for dt in (torch.bfloat16, torch.float32):
        got = kernel.lutmul_fused(a, w, a_s, w_s, out_dtype=dt)
        want = ref.scaled_lutmul_ref(a, w, a_s, w_s, out_dtype=dt)
        assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32))
        got = kernel.int_matmul_fused(a8, w8, a_s, w_s, out_dtype=dt)
        want = ref.scaled_int_matmul_ref(a8, w8, a_s, w_s, out_dtype=dt)
        assert torch.equal(got, want)
    assert kernel.LAUNCHES == {"lutmul": 1, "lutmul_fused": 2,
                               "int_matmul": 1, "int_matmul_fused": 2,
                               "lutmul_tmac": 0, "lutmul_tmac_fused": 0}


@pytest.mark.gpu
def test_cuda_lut_workspace_left_zero(cuda_device):
    """The K-split LUT kernel is one launch: the last split block of each
    tile writes the output and re-zeroes the sums and arrival counters, so
    the cached workspace serves the next call (another shape, another
    stream) without clearing."""
    kernel.reset_launches()
    for i, (M, K, N) in enumerate([(8, 3584, 512), (5, 18944, 70),
                                   (8, 3584, 512), (64, 1030, 96)]):
        a, w, _, _, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                                for v in _inputs(M, K, N, seed=10 + i))
        assert torch.equal(kernel.lutmul(a, w), ref.lutmul_ref(a, w))
        got = kernel.lutmul_fused(a, w, a_s, w_s, out_dtype=torch.bfloat16)
        want = ref.scaled_lutmul_ref(a, w, a_s, w_s, out_dtype=torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernel.lutmul(a, w)
    side.synchronize()
    assert torch.equal(got, ref.lutmul_ref(a, w))
    assert kernel.LAUNCHES["lutmul"] == 5
    assert kernel.LAUNCHES["lutmul_fused"] == 4
    for ws in kernel._WORKSPACES.values():
        assert not ws.any()


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    a = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((4, 6), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        kernel.lutmul(a.to(torch.int8), w)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.lutmul(a, torch.zeros((6, 4), dtype=torch.uint8,
                                     device=cuda_device).T)
    with pytest.raises(ValueError, match="scales"):
        kernel.lutmul_fused(a, w, torch.ones((4, 1), device=cuda_device),
                            torch.ones((1, 5), device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["w4a4_lut", "w8a8"])
def test_cuda_prequant_matmul_matches_plain_backend(cuda_device, mode):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 1, 512), generator=g).to(cuda_device, torch.bfloat16)
    from repro_torch.serve.quantize import quantize_leaf
    leaf = quantize_leaf(torch.randn((512, 384), generator=g)
                         .to(cuda_device), 4 if mode == "w4a4_lut" else 8)
    got = ops.prequant_matmul(x, leaf["w_q"], leaf["w_scale"], mode=mode,
                              backend="cuda")
    want = ops.prequant_matmul(x, leaf["w_q"], leaf["w_scale"], mode=mode,
                               backend="ref")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_quantizer_matches_cpu_bitwise(cuda_device, bits):
    """IEEE division and round-half-to-even on both devices: the activation
    codes and scales of the card equal the CPU's bit for bit (a division by
    a Python scalar would become a reciprocal multiply on the card)."""
    g = torch.Generator().manual_seed(bits)
    x = torch.randn((64, 3584), generator=g) * 3
    x[0, :16] = torch.arange(-8, 8) + 0.5              # .5 boundaries
    x[0, 16] = 7.0
    q_cpu, s_cpu = ops.quantize_activations(x, bits)
    q_gpu, s_gpu = ops.quantize_activations(x.to(cuda_device), bits)
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))
    w = torch.randn((512, 96), generator=g)
    wq_cpu, ws_cpu = ops.quantize_weights(w, bits, pack=bits == 4)
    wq_gpu, ws_gpu = ops.quantize_weights(w.to(cuda_device), bits,
                                          pack=bits == 4)
    assert torch.equal(wq_gpu.cpu(), wq_cpu)
    assert torch.equal(ws_gpu.cpu(), ws_cpu)


# ---------------------------------------------------------------------------
# the T-MAC bitplane kernel (GPU only)
# ---------------------------------------------------------------------------

TMAC_SHAPES = [(1, 8, 1), (5, 16, 3), (8, 128, 128), (13, 136, 70),
               (3, 264, 129), (8, 3584, 512), (20, 1032, 77), (32, 512, 96),
               (8, 18944, 64), (9, 2056, 260)]


def _tmac_inputs(M, K, N, spec, abits, seed=0):
    rng = np.random.default_rng(seed)
    P = plane_decomposition(spec)[0]
    lo = -(1 << (abits - 1))
    a = rng.integers(lo, -lo, size=(M, K)).astype(np.int8)
    planes = rng.integers(0, 256, size=(P, K // 8, N)).astype(np.uint8)
    a_s = (rng.random((M, 1)) * 0.1 + 1e-3).astype(np.float32)
    w_s = (rng.random((1, N)) * 0.1 + 1e-3).astype(np.float32)
    return a, planes, a_s, w_s


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", TMAC_SHAPES)
@pytest.mark.parametrize("spec", [1, "ternary", 2, 3, 4])
@pytest.mark.parametrize("abits", [4, 8])
def test_cuda_tmac_matches_plain(cuda_device, M, K, N, spec, abits):
    """Both group sizes (g = 2 tables for a4, g = 1 for a8) at every weight
    spec, ragged M/N/K and both launch geometries: int32 exactly, the fused
    bf16/f32 outputs bitwise."""
    a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                           _tmac_inputs(M, K, N, spec, abits, seed=M + K))
    g = ops.tmac_group_size(abits)
    kernel.reset_launches()
    want = ref.tmac_ref(a, planes, spec)
    assert torch.equal(kernel.lutmul_tmac(a, planes, spec, g=g), want)
    for dt in (torch.bfloat16, torch.float32):
        got = kernel.lutmul_tmac_fused(a, planes, spec, a_s, w_s, g=g,
                                       out_dtype=dt)
        want = ref.scaled_tmac_ref(a, planes, spec, a_s, w_s, out_dtype=dt)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))
    assert kernel.LAUNCHES["lutmul_tmac"] == 1
    assert kernel.LAUNCHES["lutmul_tmac_fused"] == 2


@pytest.mark.gpu
def test_cuda_tmac_workspace_left_zero(cuda_device):
    """The K-split tmac kernel is one launch whose last split block of
    each tile re-zeroes the sums and counters: the cached workspace serves
    the next call (another shape, spec, group size, stream) unchanged."""
    kernel.reset_launches()
    calls = [(8, 3584, 512, 4, 4), (5, 18944, 70, "ternary", 8),
             (32, 3584, 512, 2, 4), (8, 1032, 96, 1, 8)]
    for i, (M, K, N, spec, abits) in enumerate(calls):
        a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                               _tmac_inputs(M, K, N, spec, abits, seed=i))
        g = ops.tmac_group_size(abits)
        assert torch.equal(kernel.lutmul_tmac(a, planes, spec, g=g),
                           ref.tmac_ref(a, planes, spec))
        got = kernel.lutmul_tmac_fused(a, planes, spec, a_s, w_s, g=g)
        want = ref.scaled_tmac_ref(a, planes, spec, a_s, w_s,
                                   out_dtype=torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernel.lutmul_tmac(a, planes, spec, g=g)
    side.synchronize()
    assert torch.equal(got, ref.tmac_ref(a, planes, spec))
    assert kernel.LAUNCHES["lutmul_tmac"] == 5
    assert kernel.LAUNCHES["lutmul_tmac_fused"] == 4
    for key, ws in kernel._WORKSPACES.items():
        assert not ws.any(), key


@pytest.mark.gpu
def test_cuda_tmac_unaligned_views(cuda_device):
    """A view at an odd offset is copied before the 8- and 4-byte loads."""
    a, planes, _, _ = (torch.from_numpy(v).to(cuda_device) for v in
                       _tmac_inputs(9, 64, 40, 3, 4, seed=3))
    a_off = torch.empty(a.numel() + 1, dtype=torch.int8,
                        device=cuda_device)[1:].view(9, 64)
    a_off.copy_(a)
    p_off = torch.empty(planes.numel() + 3, dtype=torch.uint8,
                        device=cuda_device)[3:].view(planes.shape)
    p_off.copy_(planes)
    assert torch.equal(kernel.lutmul_tmac(a_off, p_off, 3),
                       ref.tmac_ref(a, planes, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["w4a4_tmac", "w2a4_tmac", "w3a8_tmac",
                                  "ternary_a8_tmac", "w1a4_tmac"])
def test_cuda_tmac_prequant_matmul_matches_plain_backend(cuda_device, mode):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((8, 4, 512), generator=g).to(cuda_device, torch.bfloat16)
    from repro_torch.serve.quantize import quantize_leaf_mode
    leaf = quantize_leaf_mode(torch.randn((512, 384), generator=g)
                              .to(cuda_device), mode)
    got = ops.prequant_matmul(x, leaf["w_q"], leaf["w_scale"], mode=mode,
                              backend="cuda")
    want = ops.prequant_matmul(x, leaf["w_q"], leaf["w_scale"], mode=mode,
                               backend="ref")
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["ternary", 1, 3])
def test_cuda_plane_quantizer_matches_cpu_bitwise(cuda_device, spec):
    """The plane quantizer gives the card the CPU's codes and scales: the
    int widths divide by a device tensor, the ternary/w1 mean-|w| scale is
    a float64 mean rounded once."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn((3584, 96), generator=g)
    p_cpu, s_cpu = ops.quantize_weights_planes(w, spec)
    p_gpu, s_gpu = ops.quantize_weights_planes(w.to(cuda_device), spec)
    assert torch.equal(p_gpu.cpu(), p_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))


@pytest.mark.gpu
def test_cuda_verify_step_equals_sequential_decode(cuda_device):
    """On the card, in bf16: one verify forward over S tokens gives each
    row the bits of S sequential decode steps (logits and caches)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve.quantize import quantize_params_for_serving
    cfg = dataclasses.replace(configs.get_config("qwen2-7b", smoke=True,
                                                 quant="w4a4_tmac"),
                              d_model=256, n_heads=2, head_dim=128,
                              d_ff=512)
    params = quantize_params_for_serving(
        T.init_params(cfg, seed=0, device=cuda_device), mode="w4a4_tmac")
    B, S = 8, 4
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g,
                         device=cuda_device, dtype=torch.int32)
    pos = torch.tensor([0, 3, 5, -1, 9, 2, 2, 7], dtype=torch.int32,
                       device=cuda_device)
    c1 = T.init_cache(cfg, B, 32, device=cuda_device)
    for c in c1:
        for v in c.values():
            v.normal_(generator=g)
    c2 = [{k: v.clone() for k, v in c.items()} for c in c1]
    logits, c1 = T.verify_step(params, cfg, toks, c1, pos)
    live = pos >= 0
    for i in range(S):
        li, c2 = T.decode_step(params, cfg, toks[:, i], c2,
                               torch.where(live, pos + i, pos))
        assert torch.equal(logits[live, i], li[live]), i
    for a, b in zip(c1, c2):
        assert torch.equal(a["k"][live], b["k"][live])
        assert torch.equal(a["v"][live], b["v"][live])
