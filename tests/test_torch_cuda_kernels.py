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
from repro_torch.kernels.thresholds import kernel as tkernel
from repro_torch.kernels.thresholds import ref as tref

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
                               "lutmul_gather": 0, "int_matmul": 1,
                               "int_matmul_fused": 2, "lutmul_tmac": 0,
                               "lutmul_tmac_fused": 0}


# the LUT kernel's two tiles: up to 16 rows (decode) and taller (CNN stages)
LUT_M = [1, 7, 8, 9, 16, 33, 1568]
LUT_KN = [(K, N) for K in (2, 16, 30, 96, 3584) for N in (1, 15, 17, 96, 512)]


def _lut_equal(a, w, a_signed, a_s, w_s):
    """int32 exactly and both fused outputs bitwise, against the plain
    version and the plain bitplane form."""
    want = ref.lutmul_ref(a, w, a_signed)
    assert torch.equal(ref.lutmul_bitplane_ref(
        a, w, kernel.product_words(a_signed, a.device)), want)
    assert torch.equal(kernel.lutmul(a, w, a_signed=a_signed), want)
    for dt, bits in ((torch.bfloat16, torch.int16),
                     (torch.float32, torch.int32)):
        got = kernel.lutmul_fused(a, w, a_s, w_s, a_signed=a_signed,
                                  out_dtype=dt)
        exp = ref.scaled_lutmul_ref(a, w, a_s, w_s, a_signed, out_dtype=dt)
        assert torch.equal(got.view(bits), exp.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", LUT_KN)
@pytest.mark.parametrize("M", LUT_M)
def test_cuda_lutmul_tiles_match_plain(cuda_device, M, K, N):
    """Both tiles, ragged M, N and K, the K-split and single-pass grids,
    signed and unsigned tables, activation bytes with their high nibble
    set (the kernel reads the low one)."""
    a, w, _, _, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                            for v in _inputs(M, K, N, seed=M + K + N))
    a_hi = a | (torch.arange(M * K, device=cuda_device).reshape(M, K)
                .to(torch.uint8) << 4)
    kernel.reset_launches()
    for a_signed in (True, False):
        _lut_equal(a, w, a_signed, a_s, w_s)
    _lut_equal(a_hi, w, True, a_s, w_s)
    assert kernel.LAUNCHES["lutmul"] == 3
    assert kernel.LAUNCHES["lutmul_fused"] == 6


# the recurrent families' projections (K, N): zamba2-2.7b's in_proj (N =
# 10,448, a ragged last column tile) and out_proj, its shared block's
# attention and SwiGLU; rwkv6-1.6b's time and channel mix
RECURRENT_KN = [(2560, 10448), (5120, 2560), (2560, 2560), (2560, 10240),
                (10240, 2560), (2048, 2048), (2048, 7168), (7168, 2048)]
RECURRENT_HEADS = [(2048, 65536), (2560, 32000)]


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", RECURRENT_KN)
@pytest.mark.parametrize("M", [8, 512])
def test_cuda_lutmul_recurrent_family_shapes(cuda_device, M, K, N):
    """At a decode step's 8 rows and an admission's 8 x 64."""
    a, w, _, _, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                            for v in _inputs(M, K, N, seed=K + N))
    _lut_equal(a, w, True, a_s, w_s)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", RECURRENT_HEADS)
@pytest.mark.parametrize("M", [8, 512])
def test_cuda_int_matmul_recurrent_family_heads(cuda_device, M, K, N):
    _, _, a8, w8, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                              for v in _inputs(M, K, N, seed=K))
    assert torch.equal(kernel.int_matmul(a8, w8), ref.int_matmul_ref(a8, w8))
    got = kernel.int_matmul_fused(a8, w8, a_s, w_s, out_dtype=torch.bfloat16)
    want = ref.scaled_int_matmul_ref(a8, w8, a_s, w_s,
                                     out_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# the encoder-decoder and vision-language families: whisper-large-v3's
# projections (K, N) at a decode step's 8 rows, a prompt forward's 32 (8
# requests x 4 tokens) and an encoder prefill's 12,000 (8 requests x 1,500
# frames); qwen2-vl-72b's layer at 8 rows and its
# 152,064-column int8 head.  Operands are drawn on the card (the 72B shapes
# take seconds through numpy).
WHISPER_KN = [(1280, 1280), (1280, 5120), (5120, 1280)]
QWEN2VL_KN = [(8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192)]
QWEN2VL_HEAD = (8192, 152064)


def _card_inputs(M, K, N, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(0, 16, (M, K), generator=g, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                      dtype=torch.uint8)
    a_s = torch.rand((M, 1), generator=g, device=dev) * 0.1 + 1e-3
    w_s = torch.rand((1, N), generator=g, device=dev) * 0.1 + 1e-3
    return a, w, a_s, w_s


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", WHISPER_KN)
@pytest.mark.parametrize("M", [8, 32, 12000])
def test_cuda_lutmul_whisper_shapes(cuda_device, M, K, N):
    a, w, a_s, w_s = _card_inputs(M, K, N, K + N + M, cuda_device)
    _lut_equal(a, w, True, a_s, w_s)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", QWEN2VL_KN)
def test_cuda_lutmul_qwen2vl_layer_shapes(cuda_device, K, N):
    a, w, a_s, w_s = _card_inputs(8, K, N, K + N, cuda_device)
    _lut_equal(a, w, True, a_s, w_s)


def _card_head_equal(K, N, seed, dev):
    """An [8, K] x [K, N] int8 head drawn on the card: int32 exactly and
    the fused bf16 output bitwise against the plain versions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a8 = torch.randint(-128, 128, (8, K), generator=g, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    a_s = torch.rand((8, 1), generator=g, device=dev) + 1e-3
    w_s = torch.rand((1, N), generator=g, device=dev) + 1e-3
    assert torch.equal(kernel.int_matmul(a8, w8), ref.int_matmul_ref(a8, w8))
    got = kernel.int_matmul_fused(a8, w8, a_s, w_s, out_dtype=torch.bfloat16)
    want = ref.scaled_int_matmul_ref(a8, w8, a_s, w_s,
                                     out_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_cuda_int_matmul_qwen2vl_head(cuda_device):
    _card_head_equal(*QWEN2VL_HEAD, 7, cuda_device)


# phi3-medium-14b's layer (K, N) at a decode step's 8 rows and its
# 100,352-column int8 head; mixtral-8x22b's head, and one layer's expert
# banks (8 experts of 6,144 x 16,384 and 16,384 x 6,144) at the 3 rows of
# decode's capacity at 8 slots (max(1, int(8 * 2 / 8 * 1.25) + 1))
PHI3_KN = [(5120, 5120), (5120, 1280), (5120, 17920), (17920, 5120)]
PHI3_HEAD = (5120, 100352)
MIXTRAL_HEAD = (6144, 32768)
MIXTRAL_BANKS = [(6144, 16384), (16384, 6144)]
MIXTRAL_C = 3


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", PHI3_KN)
def test_cuda_lutmul_phi3_layer_shapes(cuda_device, K, N):
    a, w, a_s, w_s = _card_inputs(8, K, N, K + N, cuda_device)
    _lut_equal(a, w, True, a_s, w_s)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [PHI3_HEAD, MIXTRAL_HEAD])
def test_cuda_int_matmul_phi3_and_mixtral_heads(cuda_device, K, N):
    _card_head_equal(K, N, K + N, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", MIXTRAL_BANKS)
@pytest.mark.parametrize("variant", ["fused", "unfused"])
def test_cuda_mixtral_expert_bank_matches_plain(cuda_device, variant, K, N):
    """One mixtral-8x22b bank through ``moe.expert_matmul`` at decode's
    capacity: 8 LUT launches (one an expert), bf16 bitwise equal to the
    plain version on the card."""
    from repro_torch.models import moe
    from repro_torch.serve.quantize import quantize_leaf
    g = torch.Generator(device=cuda_device).manual_seed(K)
    bank = quantize_leaf(torch.randn((8, K, N), generator=g,
                                     device=cuda_device), 4)
    a = (torch.randn((8, MIXTRAL_C, K), generator=g, device=cuda_device)
         * 2).to(torch.bfloat16)
    kernel.reset_launches()
    ops.set_variant(variant)
    try:
        got = moe.expert_matmul(a, bank, torch.bfloat16, backend="cuda")
    finally:
        ops.set_variant(None)
    name = "lutmul" + ("_fused" if variant == "fused" else "")
    assert kernel.LAUNCHES[name] == 8 == sum(kernel.LAUNCHES.values())
    want = moe.expert_matmul(a, bank, torch.bfloat16, backend="ref")
    assert got.dtype == torch.bfloat16 and got.shape == (8, MIXTRAL_C, N)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_decode_attention_int8_softcap_matches_cpu(cuda_device, window):
    """gemma2-2b's int8 decode attention (8 query heads over 4 KV heads of
    256, soft-cap 50 on scores scaled up so it bites, a window or none)
    on the card against the same call on the CPU: the written codes and
    scales, and the output within float32 noise (exp, softmax and the
    probability codes at a .5 boundary may differ by an ulp or a code)."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(11)
    B, T, H, Hkv, D = 8, 96, 8, 4, 256
    p = A.init_attention(g, H * D, H, Hkv, D)
    p = {k: {"w": v["w"] * 8.0} for k, v in p.items()}
    x = torch.randn((B, 1, H * D), generator=g)
    cache = {}
    for name in ("k", "v"):
        cache[name], cache[name + "_scale"] = A.quantize_kv(
            torch.randn((B, T, Hkv, D), generator=g) * 4.0)
    pos = torch.tensor([95, 80, 63, 40, 17, 5, 0, -1], dtype=torch.int32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=D, window=window,
              logit_softcap=50.0, compute_dtype=torch.float32)
    c_cpu = {k: v.clone() for k, v in cache.items()}
    y_cpu, _ = A.decode_attention_int8(p, x, c_cpu, pos, **kw)
    dev = {k: {"w": v["w"].to(cuda_device)} for k, v in p.items()}
    c_gpu = {k: v.to(cuda_device) for k, v in cache.items()}
    y_gpu, out = A.decode_attention_int8(dev, x.to(cuda_device), c_gpu,
                                         pos.to(cuda_device), **kw)
    assert out is c_gpu
    live = pos >= 0
    for name in ("k", "v"):
        moved = (c_gpu[name].cpu() != c_cpu[name])[live]
        assert moved.float().mean() < 1e-3
        torch.testing.assert_close(c_gpu[name + "_scale"].cpu(),
                                   c_cpu[name + "_scale"], atol=0,
                                   rtol=1e-5)
    scale = float(y_cpu[live].abs().max())
    err = float((y_gpu.cpu() - y_cpu)[live].abs().max())
    assert err <= 1e-3 * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 1568])
@pytest.mark.parametrize("a_code", [8, 15])
@pytest.mark.parametrize("a_signed", [True, False])
def test_cuda_lutmul_extreme_codes(cuda_device, M, a_code, a_signed):
    """Every weight code -8 against activation code 8 or 15: the |64|
    bytes of the selection words, summed over K = 3584."""
    K, N = 3584, 96
    a = torch.full((M, K), a_code, dtype=torch.uint8, device=cuda_device)
    w = torch.full((K // 2, N), 0x88, dtype=torch.uint8, device=cuda_device)
    got = kernel.lutmul(a, w, a_signed=a_signed)
    av = a_code - 16 if a_signed and a_code >= 8 else a_code
    assert bool((got == K * -8 * av).all())
    assert torch.equal(got, ref.lutmul_ref(a, w, a_signed))


@pytest.mark.gpu
def test_cuda_lutmul_uses_tensor_cores(cuda_device):
    """Every instantiation of the LUT kernel (two tiles x three epilogues)
    contracts on the int8 tensor cores: IMMA in its SASS."""
    from repro_torch.kernels import build
    counts = {f: n for f, n in build.sass_counts("lutmul", "IMMA").items()
              if "lutmul_kernel" in f}
    assert len(counts) == 6 and min(counts.values()) > 0, counts


@pytest.mark.gpu
def test_cuda_lut_workspace_left_zero(cuda_device):
    """The K-split LUT kernel is one launch: the last split block of each
    tile writes the output and re-zeroes the sums and arrival counters, so
    the cached workspace serves the next call (another shape, either tile,
    another stream) without clearing."""
    kernel.reset_launches()
    for i, (M, K, N) in enumerate([(8, 3584, 512), (5, 18944, 70),
                                   (8, 3584, 512), (64, 1030, 96),
                                   (33, 3584, 17), (1568, 960, 160)]):
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
    assert kernel.LAUNCHES["lutmul"] == 7
    assert kernel.LAUNCHES["lutmul_fused"] == 6
    for ws in kernel._WORKSPACES.values():
        assert not ws.any()


# the int8 kernel: its one-row-tile (M <= 8) and 32-row blocks, ragged
# shapes (byte loads) and multiples of 16 (16-byte cp.async), K split or not
INT_M = [1, 7, 8, 9, 16, 31, 32, 33, 64, 1568]
INT_K = [2, 30, 130, 1024, 1030, 3584]
INT_N = [1, 3, 17, 129, 512, 1000]


def _int_equal(a8, w8, a_s, w_s):
    """int32 exactly and both fused outputs bitwise, against the plain
    versions."""
    assert torch.equal(kernel.int_matmul(a8, w8), ref.int_matmul_ref(a8, w8))
    for dt, bits in ((torch.bfloat16, torch.int16),
                     (torch.float32, torch.int32)):
        got = kernel.int_matmul_fused(a8, w8, a_s, w_s, out_dtype=dt)
        want = ref.scaled_int_matmul_ref(a8, w8, a_s, w_s, out_dtype=dt)
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("N", INT_N)
@pytest.mark.parametrize("K", INT_K)
@pytest.mark.parametrize("M", INT_M)
def test_cuda_int_matmul_grid_matches_plain(cuda_device, M, K, N):
    _, _, a8, w8, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                              for v in _inputs(M, K, N, seed=M * K + N))
    kernel.reset_launches()
    _int_equal(a8, w8, a_s, w_s)
    assert kernel.LAUNCHES["int_matmul"] == 1
    assert kernel.LAUNCHES["int_matmul_fused"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 32])
@pytest.mark.parametrize("w_code", [-128, 127])
def test_cuda_int_matmul_extreme_codes(cuda_device, M, w_code):
    """Activation code -128 against weight code -128 or 127 everywhere,
    summed over K = 3584: |acc| = 58.7 M, exact in int32."""
    K, N = 3584, 272
    a = torch.full((M, K), -128, dtype=torch.int8, device=cuda_device)
    w = torch.full((K, N), w_code, dtype=torch.int8, device=cuda_device)
    got = kernel.int_matmul(a, w)
    assert bool((got == K * -128 * w_code).all())
    assert torch.equal(got, ref.int_matmul_ref(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(8, 3584, 512), (32, 1024, 96),
                                   (9, 64, 40)])
def test_cuda_int_matmul_unaligned_views(cuda_device, M, K, N):
    """Views at odd byte offsets (w, a, both) take the byte loads."""
    _, _, a8, w8, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                              for v in _inputs(M, K, N, seed=K + N))
    for a_off, w_off in ((0, 1), (3, 0), (5, 7)):
        a_v = torch.empty(a8.numel() + a_off, dtype=torch.int8,
                          device=cuda_device)[a_off:].view(M, K)
        a_v.copy_(a8)
        w_v = torch.empty(w8.numel() + w_off, dtype=torch.int8,
                          device=cuda_device)[w_off:].view(K, N)
        w_v.copy_(w8)
        _int_equal(a_v, w_v, a_s, w_s)


@pytest.mark.gpu
def test_cuda_int_workspace_left_zero(cuda_device):
    """The K-split int8 kernel is one launch whose last split block of each
    tile re-zeroes the sums and arrival counters: the cached workspace
    serves the next call (another shape, either block, another stream)
    without clearing."""
    kernel.reset_launches()
    for i, (M, K, N) in enumerate([(8, 3200, 32000), (32, 3584, 512),
                                   (5, 18944, 70), (8, 3584, 512),
                                   (1568, 3584, 1000), (33, 1030, 17)]):
        _, _, a8, w8, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                                  for v in _inputs(M, K, N, seed=20 + i))
        _int_equal(a8, w8, a_s, w_s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernel.int_matmul(a8, w8)
    side.synchronize()
    assert torch.equal(got, ref.int_matmul_ref(a8, w8))
    assert kernel.LAUNCHES["int_matmul"] == 7
    assert kernel.LAUNCHES["int_matmul_fused"] == 12
    for key, ws in kernel._WORKSPACES.items():
        assert not ws.any(), key


@pytest.mark.gpu
def test_cuda_int_matmul_uses_tensor_cores(cuda_device):
    """Every instantiation of the int8 kernel (two blocks x three
    epilogues) contracts on the int8 tensor cores: IMMA in its SASS."""
    from repro_torch.kernels import build
    counts = {f: n for f, n in build.sass_counts("int_matmul", "IMMA").items()
              if "int_matmul_kernel" in f}
    assert len(counts) == 6 and min(counts.values()) > 0, counts


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
    """A view at an odd offset takes the byte loads (no 16-byte cp.async)."""
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


# the tmac kernel on the tensor cores: its one-row-tile (M <= 8) and
# 32-row blocks, ragged N (byte loads), K % 32 != 0, every spec (w1 with its
# const), K split or not
TMAC_M = [1, 8, 9, 31, 32, 33, 64]
TMAC_KN = [(40, 20), (72, 17), (136, 128), (264, 3), (1032, 40),
           (3584, 512)]
TMAC_SPECS = [1, "ternary", 2, 3, 4]


def _tmac_equal(a, planes, spec, a_s, w_s, g):
    """int32 exactly and both fused outputs bitwise, against the plain
    versions."""
    assert torch.equal(kernel.lutmul_tmac(a, planes, spec, g=g),
                       ref.tmac_ref(a, planes, spec))
    for dt, bits in ((torch.bfloat16, torch.int16),
                     (torch.float32, torch.int32)):
        got = kernel.lutmul_tmac_fused(a, planes, spec, a_s, w_s, g=g,
                                       out_dtype=dt)
        want = ref.scaled_tmac_ref(a, planes, spec, a_s, w_s, out_dtype=dt)
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", TMAC_SPECS)
@pytest.mark.parametrize("K,N", TMAC_KN)
@pytest.mark.parametrize("M", TMAC_M)
def test_cuda_tmac_grid_matches_plain(cuda_device, M, K, N, spec):
    kernel.reset_launches()
    for abits in (4, 8):
        a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                               _tmac_inputs(M, K, N, spec, abits,
                                            seed=M * K + N + abits))
        _tmac_equal(a, planes, spec, a_s, w_s, ops.tmac_group_size(abits))
    assert kernel.LAUNCHES["lutmul_tmac"] == 2
    assert kernel.LAUNCHES["lutmul_tmac_fused"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("spec", TMAC_SPECS)
@pytest.mark.parametrize("M", [8, 32])
@pytest.mark.parametrize("abits", [4, 8])
def test_cuda_tmac_extreme_codes(cuda_device, spec, M, abits):
    """All-ones planes (w = -1 for every int width, 0 for ternary, 1 for
    w1) against the most negative activation code, summed over K = 3584."""
    K, N = 3584, 272
    P = plane_decomposition(spec)[0]
    lo = -(1 << (abits - 1))
    a = torch.full((M, K), lo, dtype=torch.int8, device=cuda_device)
    planes = torch.full((P, K // 8, N), 255, dtype=torch.uint8,
                        device=cuda_device)
    w = {1: 1, "ternary": 0}.get(spec, -1)
    got = kernel.lutmul_tmac(a, planes, spec)
    assert bool((got == K * lo * w).all())
    assert torch.equal(got, ref.tmac_ref(a, planes, spec))


@pytest.mark.gpu
@pytest.mark.parametrize("keep", [2, 3])
@pytest.mark.parametrize("M", [8, 32])
def test_cuda_tmac_drafter_view_no_copy(cuda_device, keep, M):
    """The drafter's top planes are a view at an offset of the target's
    stack; at a served shape it is 16-byte aligned and the kernel reads it
    in place: each call allocates its output and nothing else."""
    K, N = 3584, 512
    a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                           _tmac_inputs(M, K, N, 4, 4, seed=keep))
    view, kspec, _ = ops.truncate_planes(planes, 4, keep)
    assert view.data_ptr() == planes.data_ptr() + (4 - keep) * K // 8 * N
    assert view.data_ptr() % 16 == 0
    want = ref.tmac_ref(a, view, kspec)
    want_bf = ref.scaled_tmac_ref(a, view, kspec, a_s, w_s,
                                  out_dtype=torch.bfloat16)
    kernel.lutmul_tmac(a, view, kspec)            # the workspace, cached
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = kernel.lutmul_tmac(a, view, kspec)
    got_bf = kernel.lutmul_tmac_fused(a, view, kspec, a_s, w_s)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 2
    assert torch.equal(got, want)
    assert torch.equal(got_bf.view(torch.int16), want_bf.view(torch.int16))


@pytest.mark.gpu
def test_cuda_tmac_workspace_left_zero_32_row_tiles(cuda_device):
    """The workspace geometry of both blocks (8 and 32 rows): split and
    unsplit calls of every spec leave the sums and the arrival counters
    zero, so the next call (another shape, block or stream) is right."""
    kernel.reset_launches()
    calls = [(32, 3584, 512, 4, 4), (8, 18944, 3584, 2, 4),
             (64, 1032, 96, "ternary", 8), (33, 3584, 17, 1, 4),
             (1, 72, 40, 3, 8), (9, 3200, 8640, "ternary", 8),
             (32, 18944, 3584, 4, 4)]
    for i, (M, K, N, spec, abits) in enumerate(calls):
        a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                               _tmac_inputs(M, K, N, spec, abits, seed=40 + i))
        _tmac_equal(a, planes, spec, a_s, w_s, ops.tmac_group_size(abits))
        for key, ws in kernel._WORKSPACES.items():
            assert not ws.any(), (key, M, K, N)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernel.lutmul_tmac(a, planes, spec)
    side.synchronize()
    assert torch.equal(got, ref.tmac_ref(a, planes, spec))
    assert kernel.LAUNCHES["lutmul_tmac"] == 8
    assert kernel.LAUNCHES["lutmul_tmac_fused"] == 14
    for key, ws in kernel._WORKSPACES.items():
        assert not ws.any(), key


@pytest.mark.gpu
def test_cuda_tmac_uses_tensor_cores(cuda_device):
    """Every instantiation of the tmac kernel (five specs x two blocks x
    three epilogues) contracts on the int8 tensor cores: IMMA in its
    SASS."""
    from repro_torch.kernels import build
    counts = {f: n for f, n in build.sass_counts("lutmul_tmac", "IMMA")
              .items() if "tmac_kernel" in f}
    assert len(counts) == 30 and min(counts.values()) > 0, counts


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


# ---------------------------------------------------------------------------
# the CNN path: threshold kernel, gather kernel, unsigned LUT at large M
# ---------------------------------------------------------------------------

THRESHOLD_SHAPES = [(1, 1, 15), (8, 8, 15), (100, 24, 15), (33, 7, 15),
                    (257, 129, 15), (5000, 96, 15), (64, 40, 0), (64, 40, 1),
                    (31, 70, 255),
                    # across the register / general boundary (L <= 16)
                    (64, 40, 3), (64, 40, 7), (100, 24, 16), (33, 7, 16),
                    (100, 24, 17), (33, 7, 17),
                    # MobileNetV2's narrow and wide stages at batch 32
                    (401_408, 16, 15), (401_408, 24, 15), (100_352, 16, 15),
                    (100_352, 24, 15), (1568, 1280, 15),
                    # N % 4 != 0: 4-byte accesses
                    (37, 30, 15), (5, 1022, 3), (1568, 161, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,L", THRESHOLD_SHAPES)
def test_cuda_threshold_matches_plain(cuda_device, M, N, L):
    """Ragged M and N, unsorted rows, signs +-1 and 0, +-inf and NaN
    thresholds, |acc| past 2^24 (the float conversion rounds to nearest
    even): the kernel's codes equal the plain version's exactly."""
    rng = np.random.default_rng(M * 7 + N + L)
    acc = rng.integers(-3000, 3000, (M, N)).astype(np.int32)
    acc[::3, ::2] = rng.integers(-(2 ** 31), 2 ** 31 - 1,
                                 acc[::3, ::2].shape)
    thr = rng.normal(0, 1500, (N, L)).astype(np.float32)
    if L:
        thr[::4, 0] = np.inf
        thr[1::5, -1] = -np.inf
        thr[2::6, L // 2] = np.nan
        big = np.float32(2 ** 24) + 2 * np.arange(L, dtype=np.float32)
        thr[3::7] = big
        acc[:, 3::7] = 2 ** 24 + 1 + 2 * rng.integers(0, L, (M, len(
            range(3, N, 7))))
    sign = rng.choice([-1.0, 1.0], N).astype(np.float32)
    sign[5::9] = 0.0
    a, t, sg = (torch.from_numpy(v).to(cuda_device) for v in (acc, thr, sign))
    tkernel.reset_launches()
    got = tkernel.threshold(a, t, sg)
    assert got.dtype == torch.int32
    assert torch.equal(got, tref.threshold_ref(a, t, sg))
    assert tkernel.LAUNCHES == {"threshold": 1}


def _sorted_threshold_inputs(M, N, L, special, seed):
    """Rows ascending, as ``make_thresholds`` gives them, some with -inf
    or +inf ends, signs +-1, 0 and -0; then ``special``: NaN signs, NaN
    thresholds (a NaN row is not sorted) or a mix of sorted and unsorted
    columns in one launch."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-3000, 3000, (M, N)).astype(np.int32)
    acc[::5, ::3] = rng.integers(-(2 ** 31), 2 ** 31 - 1,
                                 acc[::5, ::3].shape)
    thr = np.sort(rng.normal(0, 1500, (N, L)).astype(np.float32), axis=1)
    if L > 2:
        thr[::3, 0] = -np.inf
        thr[1::3, -1] = np.inf
    sign = rng.choice([-1.0, 1.0], N).astype(np.float32)
    sign[5::9] = 0.0
    sign[7::9] = -0.0
    if special == "nan_sign":
        sign[1::4] = np.nan
    elif special == "nan_thr" and L:
        thr[2::5, L // 2] = np.nan
    elif special == "mixed" and L > 1:
        thr[N // 2::3] = thr[N // 2::3, ::-1]
    return acc, thr, sign


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,L", [(5000, 96, 15), (401_408, 16, 15),
                                   (1568, 1280, 15), (100, 24, 16),
                                   (257, 129, 7), (64, 40, 3), (33, 7, 1),
                                   (31, 70, 255)])
@pytest.mark.parametrize("special", ["nan_sign", "nan_thr", "mixed"])
def test_cuda_threshold_sorted_rows_match_plain(cuda_device, M, N, L,
                                                special):
    """Sorted rows (the kernel searches them), with NaN signs, NaN
    thresholds or unsorted columns beside them: codes equal the plain
    version's exactly, in one launch."""
    acc, thr, sign = _sorted_threshold_inputs(M, N, L, special, M + N + L)
    a, t, sg = (torch.from_numpy(v).to(cuda_device) for v in (acc, thr, sign))
    tkernel.reset_launches()
    got = tkernel.threshold(a, t, sg)
    assert torch.equal(got, tref.threshold_ref(a, t, sg))
    assert tkernel.LAUNCHES == {"threshold": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,L", [(100, 24, 15), (1568, 1280, 15),
                                   (33, 8, 16), (9, 4, 3), (31, 70, 255)])
@pytest.mark.parametrize("offset", ["acc", "thresholds", "sign"])
def test_cuda_threshold_offset_views_match_plain(cuda_device, M, N, L,
                                                 offset):
    """A contiguous view 4 bytes into its storage (not 16-byte aligned)
    takes the 4-byte accesses: codes equal the plain version's."""
    acc, thr, sign = _sorted_threshold_inputs(M, N, L, "mixed", M * N + L)

    def place(x, shift):
        buf = torch.zeros(x.size + 4, dtype=torch.from_numpy(x).dtype,
                          device=cuda_device)
        view = buf[shift:shift + x.size].view(x.shape)
        view.copy_(torch.from_numpy(x))
        return view
    a = place(acc, 1 if offset == "acc" else 0)
    t = place(thr, 1 if offset == "thresholds" else 0)
    sg = place(sign, 1 if offset == "sign" else 0)
    assert a.is_contiguous() and t.is_contiguous() and sg.is_contiguous()
    tkernel.reset_launches()
    got = tkernel.threshold(a, t, sg)
    assert torch.equal(got, tref.threshold_ref(a, t, sg))
    assert tkernel.LAUNCHES == {"threshold": 1}


@pytest.mark.gpu
def test_cuda_threshold_rejects_bad_inputs(cuda_device):
    acc = torch.zeros((4, 6), dtype=torch.int32, device=cuda_device)
    thr = torch.zeros((6, 15), device=cuda_device)
    sign = torch.ones((6,), device=cuda_device)
    with pytest.raises(TypeError):
        tkernel.threshold(acc.float(), thr, sign)
    with pytest.raises(ValueError, match="acc's N"):
        tkernel.threshold(acc, thr[:5], sign)
    with pytest.raises(ValueError, match="shared"):
        tkernel.threshold(acc, torch.zeros((6, 1000), device=cuda_device),
                          sign)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", SHAPES + [(40, 16, 96), (100, 960, 160)])
@pytest.mark.parametrize("a_signed", [True, False])
def test_cuda_gather_matches_plain(cuda_device, M, K, N, a_signed):
    a, w, *_ = (torch.from_numpy(v).to(cuda_device)
                for v in _inputs(M, K, N, seed=M + N))
    kernel.reset_launches()
    got = kernel.lutmul_gather(a, w, a_signed=a_signed)
    assert torch.equal(got, ref.lutmul_ref(a, w, a_signed))
    assert torch.equal(got, kernel.lutmul(a, w, a_signed=a_signed))
    assert torch.equal(ops.lutmul(a, w, a_signed=a_signed, impl="gather"),
                       got)
    assert kernel.LAUNCHES["lutmul_gather"] == 2
    assert kernel.LAUNCHES["lutmul"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(100_000, 16, 96), (401_408, 16, 16),
                                   (524_280, 16, 24), (150_001, 96, 24)])
def test_cuda_lutmul_unsigned_large_m(cuda_device, M, K, N):
    """Unsigned activation codes at the CNN's row counts (M = 401,408 is
    b1_0_expand at batch 32)."""
    g = torch.Generator(device=cuda_device).manual_seed(M)
    a = torch.randint(0, 16, (M, K), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    w = torch.randint(0, 256, (K // 2, N), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    assert torch.equal(kernel.lutmul(a, w, a_signed=False),
                       ref.lutmul_ref(a, w, a_signed=False))


@pytest.mark.gpu
def test_cuda_row_limits_raise(cuda_device):
    """Both LUT kernels' row tiles ride grid.x: 524,281 rows (one past the
    65,535 8-row tiles of grid.y) through the LUT kernel and 2,097,121
    rows (one past the gather kernel's former grid.y cap of 65,535 32-row
    tiles) through the gather kernel each run in one launch and equal the
    plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.randint(0, 256, (8, 16), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    a = torch.randint(0, 16, (524_281, 16), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    kernel.reset_launches()
    assert torch.equal(kernel.lutmul(a, w, a_signed=False),
                       ref.lutmul_ref(a, w, a_signed=False))
    a = torch.randint(0, 16, (32 * 65535 + 1, 16), generator=g,
                      device=cuda_device, dtype=torch.uint8)
    assert torch.equal(kernel.lutmul_gather(a, w),
                       ref.lutmul_ref(a, w))
    assert kernel.LAUNCHES["lutmul"] == 1
    assert kernel.LAUNCHES["lutmul_gather"] == 1


def _gather_table(kind: str, seed: int, device) -> torch.Tensor:
    """The product tables, or a random asymmetric int32 table: small
    entries, or entries near +-2^31 so that every sum wraps."""
    if kind in ("signed", "unsigned"):
        return kernel.product_table(kind == "signed", device)
    rng = np.random.default_rng(seed)
    if kind == "random":
        t = rng.integers(-5000, 5000, (16, 16))
    else:
        t = rng.integers(2 ** 31 - 64, 2 ** 31, (16, 16))
        t[::2] = -t[::2]
    return torch.from_numpy(t.astype(np.int32)).to(device)


# both tiles (M <= 16 splits K in the block), ragged M, K and N, the
# vector and the byte paths
GATHER_SHAPES = [(1, 2, 1), (5, 6, 3), (8, 3584, 512), (16, 30, 17),
                 (17, 16, 16), (20, 1030, 77), (33, 24, 24), (300, 130, 40),
                 (257, 96, 1280), (1000, 16, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", GATHER_SHAPES)
@pytest.mark.parametrize("kind", ["signed", "unsigned", "random",
                                  "wrapping"])
def test_cuda_gather_tables_match_plain(cuda_device, kind, M, K, N):
    """Any [16, 16] table through the kernel equals the plain gather bit
    for bit, sums that wrap included; activation bytes with their high
    nibble set (the kernel reads the low one); and a misaligned view of
    the same codes (the byte path) gives the same sums."""
    rng = np.random.default_rng(M + 7 * K + 31 * N)
    a = torch.from_numpy(rng.integers(0, 256, (M, K)).astype(np.uint8)) \
        .to(cuda_device)
    w = torch.from_numpy(rng.integers(0, 256, (K // 2, N)).astype(np.uint8)) \
        .to(cuda_device)
    t = _gather_table(kind, M + K + N, cuda_device)
    kernel.reset_launches()
    got = kernel.lutmul_gather(a, w, table=t)
    assert torch.equal(got, ref.lutmul_gather_ref(a, w, t))
    if kind != "random" and kind != "wrapping":
        assert torch.equal(got, ref.lutmul_ref(a, w, kind == "signed"))
        assert torch.equal(kernel.lutmul_gather(a, w,
                                                a_signed=kind == "signed"),
                           got)
    a_off = torch.empty(M * K + 1, dtype=torch.uint8, device=cuda_device)
    a_off[1:] = a.reshape(-1)
    assert torch.equal(kernel.lutmul_gather(a_off[1:].view(M, K), w,
                                            table=t), got)
    assert torch.equal(ops.lutmul(a, w, impl="gather", table=t), got)
    assert kernel.LAUNCHES["lutmul_gather"] == (4 if kind in (
        "signed", "unsigned") else 3)


# MobileNetV2's stage shapes at batch 32 (K = 16-960; N = 16, 24, 96 and
# 1280) at its smallest and largest row counts (1280 columns only at 1568)
GATHER_CNN = [(M, K, N) for M in (1568, 401_408)
              for K, N in ((16, 16), (24, 24), (16, 96), (32, 16), (144, 24),
                           (960, 24), (320, 1280)) if M * N < 10 ** 8]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", GATHER_CNN)
def test_cuda_gather_cnn_shapes(cuda_device, M, K, N):
    """The unsigned product table against the plain matmul, a wrapping
    random table against the plain gather."""
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    a = torch.randint(0, 16, (M, K), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    w = torch.randint(0, 256, (K // 2, N), generator=g, device=cuda_device,
                      dtype=torch.uint8)
    assert torch.equal(kernel.lutmul_gather(a, w, a_signed=False),
                       ref.lutmul_ref(a, w, a_signed=False))
    t = _gather_table("wrapping", K + N, cuda_device)
    assert torch.equal(kernel.lutmul_gather(a, w, table=t),
                       ref.lutmul_gather_ref(a, w, t))


@pytest.mark.gpu
def test_cuda_gather_rejects_bad_tables(cuda_device):
    a = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    t = torch.zeros((16, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kernel.lutmul_gather(a, w, table=t.float())
    with pytest.raises(ValueError, match="16, 16"):
        kernel.lutmul_gather(a, w, table=t[:8])
    with pytest.raises(ValueError, match="contiguous"):
        kernel.lutmul_gather(a, w, table=t.T)
    with pytest.raises(ValueError, match="cpu"):
        kernel.lutmul_gather(a, w, table=t.cpu())


@pytest.mark.gpu
def test_cuda_threshold_builders_match_cpu_bitwise(cuda_device):
    """make_thresholds, compute_scale and fake_quant give the card the
    CPU's bits (IEEE divisions by tensors, a correctly rounded sqrt)."""
    from repro_torch.core import quantization as Q
    from repro_torch.core.thresholds import BNParams, make_thresholds
    g = torch.Generator().manual_seed(3)
    C = 960
    bn = dict(gamma=torch.rand(C, generator=g) * 4 - 2,
              beta=torch.randn(C, generator=g) * 0.3,
              mean=torch.randn(C, generator=g) * 0.2,
              var=torch.rand(C, generator=g) + 0.5)
    acc_scale = torch.rand(C, generator=g) * 0.05 + 1e-3
    out_scale = torch.full((C,), 6.0 / 15)
    t_cpu, s_cpu = make_thresholds(acc_scale, BNParams(**bn), Q.A4,
                                   out_scale)
    t_gpu, s_gpu = make_thresholds(
        acc_scale.to(cuda_device),
        BNParams(**{k: v.to(cuda_device) for k, v in bn.items()}), Q.A4,
        out_scale.to(cuda_device))
    assert torch.equal(t_gpu.cpu(), t_cpu)
    assert torch.equal(s_gpu.cpu(), s_cpu)
    x = torch.randn((4, 14, 14, 96), generator=g) * 3
    for cfg in (Q.W4, Q.A4, Q.W8, Q.A8):
        got = Q.compute_scale(x.to(cuda_device), cfg)
        want = Q.compute_scale(x, cfg)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        got = Q.fake_quant(x.to(cuda_device), cfg)
        assert torch.equal(got.cpu().view(torch.int32),
                           Q.fake_quant(x, cfg).view(torch.int32))


@pytest.mark.gpu
def test_cuda_integer_stage_matches_cpu(cuda_device):
    """A streamlined stage on the card (LUT kernel, unsigned codes, then
    the threshold kernel: one launch each) gives the CPU's codes, and the
    float reference's within one code."""
    from repro_torch.core import streamline as S
    from repro_torch.core.thresholds import BNParams
    g = torch.Generator().manual_seed(11)
    K, N, M = 144, 24, 3000
    w = torch.randn((K, N), generator=g) * 0.2
    bn = BNParams(torch.rand(N, generator=g) + 0.5,
                  torch.randn(N, generator=g) * 0.3,
                  torch.randn(N, generator=g) * 0.2,
                  torch.rand(N, generator=g) + 0.5)
    a = torch.randint(0, 16, (M, K), generator=g)
    cpu = S.integer_stage_forward(S.streamline_stage(w, bn, 0.4), a)
    gbn = BNParams(*(v.to(cuda_device) for v in
                     (bn.gamma, bn.beta, bn.mean, bn.var)))
    stage = S.streamline_stage(w.to(cuda_device), gbn, 0.4)
    kernel.reset_launches()
    tkernel.reset_launches()
    got = S.integer_stage_forward(stage, a.to(cuda_device))
    assert kernel.LAUNCHES["lutmul"] == 1
    assert tkernel.LAUNCHES == {"threshold": 1}
    assert torch.equal(got.cpu(), cpu)
    fref = S.float_stage_reference(w.to(cuda_device), gbn, 0.4,
                                   a.to(cuda_device))
    assert int((got - fref).abs().max()) <= 1


@pytest.mark.gpu
def test_cuda_mobilenet_forward_matches_cpu(cuda_device):
    """The smoke MobileNetV2 on the card (cuDNN, TF32 off) against the
    CPU: float logits within 1e-4 of their largest magnitude (float32 sums
    in other orders); QAT finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import mobilenet as MB
    cfg = get_config("mobilenetv2", smoke=True)
    params = MB.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    gparams = {k: {n: v.to(cuda_device) for n, v in p.items()}
               for k, p in params.items()}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = MB.forward(gparams, cfg, x.to(cuda_device), train_qat=False)
        qat = MB.forward(gparams, cfg, x.to(cuda_device), train_qat=True)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    want = MB.forward(params, cfg, x, train_qat=False)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max())
    assert bool(torch.isfinite(qat).all()) and qat.shape == (4, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 42])
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("variant", ["fused", "unfused"])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_expert_matmul_matches_plain(cuda_device, bits, K, N, C,
                                          variant):
    """qwen2-moe-a2.7b's expert banks (60 experts) at decode's capacity
    (C = 1) and an admission's (C = 42), nibble banks through the LUT
    kernel and int8 banks (w8a8) through the int8 kernel, one launch per
    expert: bf16 outputs bitwise equal to the plain version on the card,
    and the quantizer's codes and scales equal to the CPU's."""
    from repro_torch.models import moe
    from repro_torch.serve.quantize import quantize_leaf
    g = torch.Generator().manual_seed(C + K + bits)
    bank = quantize_leaf(torch.randn((60, K, N), generator=g)
                         .to(cuda_device), bits)
    a = (torch.randn((60, C, K), generator=g) * 2).to(cuda_device,
                                                       torch.bfloat16)
    kernel.reset_launches()
    ops.set_variant(variant)
    try:
        got = moe.expert_matmul(a, bank, torch.bfloat16, backend="cuda")
    finally:
        ops.set_variant(None)
    name = ("lutmul" if bits == 4 else "int_matmul") + (
        "_fused" if variant == "fused" else "")
    assert kernel.LAUNCHES[name] == 60
    assert sum(kernel.LAUNCHES.values()) == 60
    want = moe.expert_matmul(a, bank, torch.bfloat16, backend="ref")
    assert got.dtype == torch.bfloat16 and got.shape == (60, C, N)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    qmax = 7 if bits == 4 else 127
    q_gpu, s_gpu = moe.quantize_experts(a, qmax)
    q_cpu, s_cpu = moe.quantize_experts(a.cpu(), qmax)
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))


@pytest.mark.gpu
def test_cuda_expert_wrappers_reject_bad_stacks(cuda_device):
    a = torch.zeros((3, 2, 64), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((3, 32, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="does not match"):
        kernel.lutmul_experts(a, w[:2].contiguous())
    with pytest.raises(ValueError, match="scales"):
        kernel.lutmul_experts(
            a, w, torch.ones((3, 2, 1), device=cuda_device),
            torch.ones((3, 1, 8), device=cuda_device))
    with pytest.raises(TypeError):
        kernel.int_matmul_experts(a, w)


# ---------------------------------------------------------------------------
# training: the deployed-model evaluation's shapes and one QAT step
# ---------------------------------------------------------------------------

# minicpm-2b's projections at the train phase's eval shape, M = 4 x 512
TRAIN_EVAL_M = 2048
TRAIN_EVAL_KN = [(2304, 2304), (2304, 5760), (5760, 2304)]


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", TRAIN_EVAL_KN)
def test_cuda_fused_kernels_at_train_eval_shape(cuda_device, K, N):
    """The fused LUT kernel (``w4a4_lut``) and the fused int8 kernel on the
    unpacked 4-bit codes (``w4a4_mxu``) at M = 2,048, bitwise against their
    plain versions."""
    a, w, _, _, a_s, w_s = (torch.from_numpy(v).to(cuda_device)
                            for v in _inputs(TRAIN_EVAL_M, K, N, seed=9))
    a4 = ref.decode_codes(a).to(torch.int8)
    w4 = ref.decode_codes(ref.unpack_int4(w.T).T, 4).to(torch.int8) \
        .contiguous()
    got = kernel.lutmul_fused(a, w, a_s, w_s, out_dtype=torch.bfloat16)
    want = ref.scaled_lutmul_ref(a, w, a_s, w_s, out_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    got = kernel.int_matmul_fused(a4, w4, a_s, w_s, out_dtype=torch.bfloat16)
    want = ref.scaled_int_matmul_ref(a4, w4, a_s, w_s,
                                     out_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_cuda_qat_train_step_matches_cpu(cuda_device):
    """One minicpm-2b smoke QAT step with the W4 projection (float32
    compute, TF32 off) on the card and on the CPU from the same weights and
    batch.  Loss and gradient norm within rtol 1e-5 (float32 sums in other
    orders: cuBLAS, the card's shape-stable attention); every parameter
    within 1e-4 but where a weight sat within rounding of a W4 boundary
    before the projection: at most one in 10,000 may move by up to two
    steps of its column's scale."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.tree import flatten
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(configs.get_config(
        "minicpm-2b", smoke=True, quant="qat"), compute_dtype="float32")
    tcfg = tstep.TrainConfig(schedule="wsd", qat_project=True, peak_lr=1e-3,
                             warmup=0, total_steps=8)
    batch = pipeline.lm_batch(pipeline.DataConfig(vocab=cfg.vocab,
                                                  seq_len=32,
                                                  global_batch=4), 0)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda_device):
            state = tstep.init_state(_to(params, dev))
            state, m = tstep.make_train_step(cfg, tcfg)(state, batch)
            out[str(dev)] = (state, {k: float(v) for k, v in m.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cs, cm), (gs, gm) = out["cpu"], out[str(cuda_device)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(gm[k], cm[k], rtol=1e-5)
    assert gm["lr"] == cm["lr"]
    n = moved = 0
    for p, c, g in zip(*flatten(cs["params"]), flatten(gs["params"])[1]):
        d = (g.cpu() - c).abs()
        n += d.numel()
        far = d > 1e-4
        moved += int(far.sum())
        step = c.abs().amax(dim=tuple(range(c.dim() - 1)) or None) / 7
        assert bool((d <= 2 * step + 1e-4).all()), p
    assert moved <= n // 10_000, (moved, n)


def _to(tree, dev):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to(dev, copy=True), tree)


# ---------------------------------------------------------------------------
# mixed per-leaf widths: the plane counts qwen2-7b's plans put on the card
# ---------------------------------------------------------------------------

QWEN_MIXED = [(3, 3584, 18944), (1, 3584, 18944), (2, 18944, 3584),
              (4, 18944, 3584), (2, 3584, 18944)]


@pytest.mark.gpu
@pytest.mark.parametrize("P,K,N", QWEN_MIXED)
def test_cuda_tmac_mixed_plan_shapes(cuda_device, P, K, N):
    """wi at P = 3 (3.2 bits), wg at P = 1 (2.0 bits, the binary kind) and
    the other planned shapes at decode's M = 8: int32 exactly, the fused
    bf16 output bitwise."""
    spec = P
    a, planes, a_s, w_s = (torch.from_numpy(v).to(cuda_device) for v in
                           _tmac_inputs(8, K, N, spec, 4, seed=P + K))
    assert torch.equal(kernel.lutmul_tmac(a, planes, spec, g=2),
                       ref.tmac_ref(a, planes, spec))
    got = kernel.lutmul_tmac_fused(a, planes, spec, a_s, w_s, g=2)
    want = ref.scaled_tmac_ref(a, planes, spec, a_s, w_s,
                               out_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_cuda_timed_formulation_picker(cuda_device):
    """With autotuning on, the first call of a key times both kernels on
    the card and caches the winner; the second call is a lookup; a8 and the
    plain backend are never timed."""
    ops._FORMULATION_CACHE.clear()
    ops.set_autotune(True)
    try:
        times = ops.time_formulations(2, 3584, 512, M=ops.PROBE_M)
        assert set(times) == {"tmac", "onehot"}
        assert all(t > 0 for t in times.values())
        got = ops.pick_formulation(2, 4, 3584, 512, "cuda")
        assert got in ("tmac", "onehot")
        assert ops._FORMULATION_CACHE[(2, 4, 3584, 512, "cuda")] == got
        kernel.reset_launches()
        assert ops.pick_formulation(2, 4, 3584, 512, "cuda") == got
        assert ops.pick_formulation(2, 8, 3584, 512, "cuda") == "tmac"
        assert ops.pick_formulation(3, 4, 3584, 512, "ref") == "tmac"
        assert kernel.LAUNCHES["lutmul"] == kernel.LAUNCHES[
            "lutmul_tmac"] == 0
    finally:
        ops.set_autotune(None)
        ops._FORMULATION_CACHE.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("target", [3.2, 2.0])
def test_cuda_mixed_plan_engine_matches_plain(cuda_device, target):
    """qwen2-7b-smoke served under a plan on the card: the fused kernels'
    transcripts equal the plain backend's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.roofline.analysis import plan_mixed_bits
    from repro_torch.serve import Request, Scheduler, ServeConfig
    from repro_torch.serve import make_engine
    from repro_torch.serve.quantize import init_served_params
    cfg = dataclasses.replace(configs.get_config(
        "qwen2-7b", smoke=True, quant="w4a4_tmac"), compute_dtype="float32")
    plan = plan_mixed_bits(T.init_params(cfg, 0, "meta"), target, cfg)
    params = init_served_params(cfg, "w4a4_tmac", seed=0,
                                device=cuda_device, bits_plan=plan)
    out = {}
    for be in ("cuda", "ref"):
        ops.set_backend(be)
        eng = make_engine(params, cfg, ServeConfig(
            quant="w4a4_tmac", bits_plan=plan, max_len=32),
            device=cuda_device)
        reqs = [Request(prompt=[3 + i, 5, 7, 11], max_new_tokens=6)
                for i in range(4)]
        Scheduler(eng, slots=4, chunk=2).run(reqs)
        out[be] = [r.tokens for r in reqs]
    ops.set_backend(None)
    assert out["cuda"] == out["ref"]
