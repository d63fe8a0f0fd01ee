"""The CUDA kernels on the card against their plain versions: int32
outputs exactly, fused outputs bitwise, at ragged shapes and at the K-split
and single-pass launch geometries.  Every test needs a CUDA GPU (marker
``gpu``) and skips elsewhere; the file imports no JAX, so it runs on a GPU
machine with ``python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

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
                               "int_matmul": 1, "int_matmul_fused": 2}


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
