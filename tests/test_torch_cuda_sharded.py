"""The sharded serving path's pieces on the card (marker ``gpu``; skips
without a GPU; imports no JAX):

* ``attention.full_attention`` gives every (row, head) the same bits
  whatever rows and heads the call holds (a data shard's rows, a model
  rank's heads), at decode and prefill shapes of the served models;
* the norms' row reductions (``layers.row_mean`` / ``row_var``, so
  ``rms_norm`` and ``layer_norm``) give every row the same bits whatever
  rows the call holds (ATen's CUDA reduction lays its threads out by the
  output count up to 16);
* the split-head projections on the card (``attention.proj_stable`` /
  ``out_stable``) give
  every (row, head) the same bits whatever rows and heads the call holds,
  at qwen2-7b's full-width decode, verify and prefill shapes;
* ``dist.tp``'s collectives on CUDA tensors over gloo (two ranks sharing
  the card, staged through pinned host memory) give the gathered and
  reduced values on the card;
* ``ops.prequant_matmul`` under a 1x2 ``tp_context``: column-, head- and
  row-parallel (the unfused kernel, the int32 sums all-reduced, one
  epilogue) are bitwise the single-device fused kernel's output.

    python -m pytest -q -m gpu tests/test_torch_cuda_sharded.py
"""
import pytest
import torch

from repro_torch.models import attention as A

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA GPU")]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,T", [
    (8, 1, 28, 4, 128, 256), (8, 1, 28, 4, 128, 512),
    (8, 1, 8, 4, 256, 4352), (8, 1, 16, 16, 128, 256),
    (8, 40, 16, 16, 128, 40), (8, 7, 16, 16, 128, 7),
    (8, 12, 28, 4, 128, 12), (4, 33, 28, 4, 128, 33)])
def test_cuda_attention_bits_ignore_rows_and_heads(B, S, Hq, Hkv, D, T):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    if S == 1:
        qp = torch.full((B, 1), T - 3, dtype=torch.int32, device=dev)
        kp = A.decode_kv_positions(qp[:, 0], T)
    else:
        qp = kp = A.arange_positions(B, S, dev)
    full = A.full_attention(q, k, v, qp, kp)
    r, hq, hk = B // 2, Hq // 2, Hkv // 2
    for rows, (q0, k0) in ((slice(r, None), (hq, hk)),
                           (slice(None, r), (0, 0)),
                           (slice(None), (hq, hk))):
        part = A.full_attention(q[rows, :, q0:q0 + hq],
                                k[rows, :, k0:k0 + hk],
                                v[rows, :, k0:k0 + hk], qp[rows], kp[rows])
        assert torch.equal(full[rows, :, q0:q0 + hq], part)


def test_cuda_norm_bits_ignore_rows():
    from repro_torch.models import layers as L
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((264, 3584), generator=g, device=dev) \
        * torch.rand((264, 1), generator=g, device=dev) * 4
    p = {"scale": torch.rand(3584, generator=g, device=dev) + 0.5}
    full = (L.row_mean(x * x), L.row_var(x),
            L.rms_norm(p, x.to(torch.bfloat16)),
            L.layer_norm(p, x.to(torch.bfloat16)))
    for R in (1, 2, 3, 4, 5, 8, 12, 15, 16, 17, 33, 100):
        rows = x[-R:].clone()
        part = (L.row_mean(rows * rows), L.row_var(rows),
                L.rms_norm(p, rows.to(torch.bfloat16)),
                L.layer_norm(p, rows.to(torch.bfloat16)))
        for name, a, b in zip(("mean", "var", "rms_norm", "layer_norm"),
                              full, part):
            assert torch.equal(a[-R:], b), (name, R)
    # a decode call's [B, 1, d] layout and a prefill's [B, S, d]
    x3 = x[:8 * 33].reshape(8, 33, 3584)
    assert torch.equal(L.row_mean(x3[4:, :1]), L.row_mean(x3[:, :1])[4:])
    assert torch.equal(L.row_var(x3[4:]), L.row_var(x3)[4:])


@pytest.mark.parametrize("B,S,H", [(8, 1, 28), (8, 1, 4), (8, 4, 28),
                                   (4, 4, 4), (8, 33, 28), (8, 12, 4)])
def test_cuda_split_head_projection_bits_ignore_rows_and_heads(B, S, H):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    d, dh = 3584, 128
    x = torch.randn((B, S, d), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((d, H, dh), generator=g, device=dev)
         * d ** -0.5).to(torch.bfloat16)
    full = A.proj_stable(x, w)
    want = torch.einsum("bsd,dhk->bshk", x.float(), w.float())
    assert (full.float() - want).abs().max() < 0.05
    r, h = B // 2, H // 2
    for rows, heads in ((slice(r, None), slice(h, None)),
                        (slice(None, r), slice(None, h)),
                        (slice(None), slice(h, None))):
        part = A.proj_stable(x[rows], w[:, heads].contiguous())
        assert torch.equal(full[rows, :, heads], part)
    o = torch.randn((B, S, 28, dh), generator=g, device=dev).to(
        torch.bfloat16)
    wo = (torch.randn((28, dh, d), generator=g, device=dev)
          * (28 * dh) ** -0.5).to(torch.bfloat16)
    out = A.out_stable(o, wo)
    for rows in (slice(r, None), slice(None, r)):
        assert torch.equal(out[rows], A.out_stable(o[rows], wo))


def _collectives(mesh):
    from repro_torch.dist import tp
    dev = mesh.device
    i = mesh.model_index
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + i
    n = torch.full((2, 3), 10 * (i + 1), dtype=torch.int32, device=dev)
    out = dict(gather=tp.all_gather(x, mesh.model, -1),
               gather0=tp.all_gather(n, mesh.model, 0),
               sum=tp.all_reduce_sum(n, mesh.model),
               max=tp.all_reduce_max(x, mesh.model),
               min=tp.all_reduce_min(n, mesh.model))
    assert all(t.device == dev for t in out.values())
    return {k: t.cpu() for k, t in out.items()}


def test_staged_collectives_on_one_card():
    from repro_torch.serve.sharded import launch
    ranks = launch(_collectives, "1x2", "gloo", timeout_s=240)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    n = torch.full((2, 3), 10, dtype=torch.int32)
    for r in ranks:
        assert torch.equal(r["gather"], torch.cat([x, x + 1], -1))
        assert torch.equal(r["gather0"], torch.cat([n, 2 * n], 0))
        assert torch.equal(r["sum"], 3 * n)
        assert torch.equal(r["max"], x + 1)
        assert torch.equal(r["min"], n)


def _sharded_matmuls(mesh):
    from repro_torch.dist import tp
    from repro_torch.kernels.lutmul import ops
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(3)
    M, K, N = 4, 3584, 1024
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    wf = torch.randn((K, N), generator=g, device=dev)
    Kl = K // 2
    x_local = x[:, mesh.model_index * Kl:(mesh.model_index + 1) * Kl]
    out = {}
    for mode, bits in (("w4a4_lut", 4), ("w8a8", 8)):
        w_q, w_s = ops.quantize_weights(wf, bits, pack=bits == 4)
        full = ops.prequant_matmul(x, w_q, w_s, mode=mode)   # fused kernel
        parts = {}
        for name in ("wq", "wo"):       # column- and row-parallel marking
            marked, _, _ = tp.mark_tp_params(
                {name: {"w_q": w_q, "w_scale": w_s}}, 2)
            parts[name] = tp.shard_params(marked, mesh)[name]
        got = {}
        with tp.tp_context(mesh.model, 2, mesh.data):
            for case, layout, xin, p in (
                    ("col", "col", x, parts["wq"]),
                    ("head", "head", x, parts["wq"]),
                    ("row", "row", x, parts["wo"]),
                    ("row, local input", "row", x_local, parts["wo"])):
                got[case] = ops.prequant_matmul(
                    xin, p["w_q"], p["w_scale"], mode=mode, tp=layout).cpu()
        out[mode] = (full.cpu(), got)
    return mesh.model_index, out


def test_sharded_prequant_matmul_equals_fused_kernel():
    from repro_torch.serve.sharded import launch
    ranks = launch(_sharded_matmuls, "1x2", "gloo", timeout_s=240)
    for idx, res in ranks:
        for mode, (full, got) in res.items():
            N = full.shape[-1]
            for case in ("col", "row", "row, local input"):
                assert torch.equal(got[case], full), (mode, case)
            cols = slice(idx * N // 2, (idx + 1) * N // 2)
            assert torch.equal(got["head"], full[:, cols]), mode
