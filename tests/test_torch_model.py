"""Port vs reference: layers, attention and the dense decoder on the
qwen2-7b smoke config (``repro_torch.models``), plus the free-slot
sentinel contract of decode attention.

Float comparisons use ``atol=rtol=1e-5`` in float32 compute: XLA and ATen
order the float reductions (RMS mean, softmax sums, matmul dot products)
differently, so results agree to a few ulps, not bitwise.  Integer and
boolean results (masks, positions, KV placement) are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import quantize_params_for_serving

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _cfgs(quant="none"):
    j = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    return j, t


_PARAMS = {}


def _params(quant="none"):
    """Reference params (quantized for w4a4_lut) and their conversion."""
    if quant not in _PARAMS:
        jcfg, tcfg = _cfgs(quant)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quant != "none":
            jp = jquantize(jp, mode=quant)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        _PARAMS[quant] = (jp, tp)
    return _PARAMS[quant]


def _cache_to_torch(jcache, n_layers):
    """Reference cache (tuple over pattern of [G, ...] stacks) -> per-layer
    list (one pattern position here)."""
    (c,) = jcache
    return [{k: torch.from_numpy(np.array(v[g])) for k, v in c.items()}
            for g in range(n_layers)]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 4
    s = rng.standard_normal(64).astype(np.float32)
    _close(TL.rms_norm({"scale": torch.from_numpy(s)}, torch.from_numpy(x)),
           JL.rms_norm({"scale": jnp.asarray(s)}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    _close(TL.rope_freqs(16, theta), JL.rope_freqs(16, theta))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_swiglu_mlp_matches(quant):
    jp, tp = _params(quant)
    x = np.random.default_rng(2).standard_normal((2, 4, 64)).astype(
        np.float32)
    layer1 = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"][0]["mlp"])
    want = JL.mlp(layer1, jnp.asarray(x), "swiglu", quant, jnp.float32)
    got = TL.mlp(tp["blocks"][1]["mlp"], torch.from_numpy(x), quant,
                 torch.float32)
    _close(got, want)


def test_linear_bias_and_modes():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    for quant in ("none", "w8a8", "w4a4_lut"):
        want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x), quant, jnp.float32)
        got = TL.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), quant, torch.float32)
        _close(got, want)
    with pytest.raises(ValueError, match="unknown quant mode"):
        TL.linear({"w": torch.from_numpy(w)}, torch.from_numpy(x), "bogus")


def test_quantized_linear_quantizes_once():
    w = torch.randn((32, 16), generator=torch.Generator().manual_seed(0))
    qlin = TL.QuantizedLinear({"w": w}, mode="w4a4_lut")
    assert qlin.params["w_q"].dtype == torch.uint8
    assert qlin.params["w_q"].shape == (16, 16)
    before = ops.WEIGHT_QUANT_COUNT
    x = torch.randn((3, 32), generator=torch.Generator().manual_seed(1))
    y1 = qlin(x, torch.float32)
    y2 = qlin(x, torch.float32)
    assert ops.WEIGHT_QUANT_COUNT == before
    assert torch.equal(y1, y2)
    with pytest.raises(ValueError, match="unsupported quant mode"):
        TL.QuantizedLinear({"w": w}, mode="none")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def test_mask_and_kv_positions_exact():
    pos = np.array([3, 0, -1, 7], np.int32)
    want = JA.decode_kv_positions(jnp.asarray(pos), 6, False)
    got = TA.decode_kv_positions(torch.from_numpy(pos), 6)
    np.testing.assert_array_equal(_np(got), _np(want))
    q = np.array([[0, 1, 2, 3], [2, 2, 5, 0]], np.int32)
    k = np.array([[0, 1, -5, 3], [-1, 2, 4, 9]], np.int32)
    np.testing.assert_array_equal(
        _np(TA._mask(torch.from_numpy(q), torch.from_numpy(k))),
        _np(JA._mask(jnp.asarray(q), jnp.asarray(k), True, None)))


def _attn_case(seed=4, B=3, T=10, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    d = H * D
    jp = JA.init_attention(jax.random.PRNGKey(seed), d, H, Hkv, D,
                           qkv_bias=True)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)   # nonzero biases
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    ck = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return jp, tp, x, ck, cv, dict(n_heads=H, n_kv=Hkv, head_dim=D)


@pytest.mark.parametrize("pos", [[4, 0, 9], [2, 2, 2], 5])
def test_decode_attention_matches(pos):
    jp, tp, x, ck, cv, kw = _attn_case()
    want = JA.decode_attention(jp, jnp.asarray(x), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
                               compute_dtype=jnp.float32, **kw)
    got = TA.decode_attention(tp, torch.from_numpy(x),
                              torch.from_numpy(ck.copy()),
                              torch.from_numpy(cv.copy()),
                              torch.as_tensor(pos, dtype=torch.int32),
                              compute_dtype=torch.float32, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_prefill_attention_matches():
    jp, tp, _, _, _, kw = _attn_case(seed=5)
    x = np.random.default_rng(5).standard_normal((2, 7, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, (wk, wv) = JA.attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                  compute_dtype=jnp.float32, return_kv=True,
                                  **kw)
    got, (gk, gv) = TA.attention(tp, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()),
                                 compute_dtype=torch.float32, return_kv=True,
                                 **kw)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def _sentinel_case(quant):
    """Batch-2 decode with row 1 free (pos=-1) and the batch-1 call of row
    0 alone; returns both plus the untouched caches."""
    _, tp, x, ck, cv, kw = _attn_case(seed=6, B=2, T=6, H=2, Hkv=2, D=8)
    if quant != "none":
        tp = quantize_params_for_serving({"attn": tp}, mode=quant)["attn"]
    ck_t, cv_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    xt = torch.from_numpy(x)
    kw = dict(kw, quant=quant, compute_dtype=torch.float32)
    two = TA.decode_attention(tp, xt, ck_t.clone(), cv_t.clone(),
                              torch.tensor([2, -1], dtype=torch.int32), **kw)
    one = TA.decode_attention(tp, xt[:1], ck_t[:1].clone(),
                              cv_t[:1].clone(), 2, **kw)
    return two, one, ck_t, cv_t


def _check_own_row_writes(nk, nv, ck_t, cv_t):
    # the free row wrote its own slot 0 only; every other slot untouched
    assert torch.equal(nk[1, 1:], ck_t[1, 1:])
    assert torch.equal(nv[1, 1:], cv_t[1, 1:])
    assert not torch.equal(nk[1, 0], ck_t[1, 0])
    # the active row wrote slot 2 only
    changed = (nk[0] != ck_t[0]).any(-1).any(-1)
    assert changed.tolist() == [False, False, True, False, False, False]


@pytest.mark.parametrize("quant", ["w4a4_lut", "w8a8"])
def test_negative_position_is_free_slot_sentinel(quant):
    """On the served integer-code path a pos=-1 row writes only inside its
    own row and stays finite; its neighbour's KV writes equal a batch-1
    call bitwise (per-row activation scales, exact integer products and an
    elementwise epilogue make them batch-invariant) and the neighbour's
    output matches the batch-1 call at the stated tolerance."""
    (y, nk, nv), (y0, nk0, nv0), ck_t, cv_t = _sentinel_case(quant)
    assert torch.equal(nk[:1], nk0) and torch.equal(nv[:1], nv0)
    _close(y[:1], y0)
    assert torch.isfinite(y).all()
    _check_own_row_writes(nk, nv, ck_t, cv_t)


def test_free_slot_sentinel_float_projections():
    """Float projections: the same contract except bitwise KV — a float
    matmul's summation order depends on the batch shape (the CPU BLAS
    takes a matrix-vector kernel for one row, a matrix-matrix kernel for
    two), so the neighbour's K/V agree with the batch-1 call to rounding,
    not bit for bit.  This is why the reference's float-only version of
    the test (tests/test_scheduler.py) fails on the CPU."""
    (y, nk, nv), (y0, nk0, nv0), ck_t, cv_t = _sentinel_case("none")
    _close(nk[:1], nk0)
    _close(nv[:1], nv0)
    _close(y[:1], y0)
    assert torch.isfinite(y).all()
    _check_own_row_writes(nk, nv, ck_t, cv_t)


# ---------------------------------------------------------------------------
# the decoder: forward / prefill / decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_forward_and_prefill_match(quant):
    jcfg, tcfg = _cfgs(quant)
    jp, tp = _params(quant)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 9))
    want, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TT.forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    assert float(aux) == 0.0
    wl, wc = JT.prefill(jp, jcfg, jnp.asarray(toks))
    gl, gc = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    _close(gl, wl)
    for g, c in zip(gc, _cache_to_torch(wc, tcfg.n_layers)):
        _close(g["k"], c["k"])
        _close(g["v"], c["v"])


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_steps_match(quant):
    jcfg, tcfg = _cfgs(quant)
    jp, tp = _params(quant)
    B, T = 3, 12
    rng = np.random.default_rng(8)
    jc = JT.init_cache(jcfg, B, T)
    tc = TT.init_cache(tcfg, B, T, device="cpu")
    pos = np.array([0, 3, -1], np.int32)
    for step in range(4):
        tok = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        wl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        gl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos.copy()))
        assert gl.dtype == torch.float32 and gl.shape == (B, jcfg.vocab)
        _close(gl[:2], wl[:2])                  # row 2 is a free slot
        assert torch.isfinite(gl).all()
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    for g, c in zip(tc, _cache_to_torch(jc, tcfg.n_layers)):
        _close(g["k"][:2], c["k"][:2])
        _close(g["v"][:2], c["v"][:2])


def test_prefill_then_decode_matches_forward():
    """Port-internal consistency: a decode step after prefill gives the
    full forward's logits at the next position."""
    _, tcfg = _cfgs()
    _, tp = _params()
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab, (2, 6)))
    full, _ = TT.forward(tp, tcfg, toks)
    _, cache = TT.prefill(tp, tcfg, toks[:, :5])
    grown = TT.init_cache(tcfg, 2, 8, device="cpu")
    for g, c in zip(grown, cache):
        g["k"][:, :5] = c["k"]
        g["v"][:, :5] = c["v"]
    logits, _ = TT.decode_step(tp, tcfg, toks[:, 5], grown, 5)
    _close(logits, full[:, 5])


# ---------------------------------------------------------------------------
# params, conversion, devices
# ---------------------------------------------------------------------------

def test_init_params_structure_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, _ = _params()
    tp = TT.init_params(tcfg, seed=0, device="cpu")
    assert len(tp["blocks"]) == tcfg.n_layers
    jleaves = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]))[0]
    for path, leaf in jleaves:
        node = tp["blocks"][0]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
    assert tp["embed"]["emb"].shape == (tcfg.vocab, tcfg.d_model)
    assert tp["lm_head"]["w"].shape == (tcfg.d_model, tcfg.vocab)
    again = TT.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["lm_head"]["w"], tp["lm_head"]["w"])


def test_params_from_jax_unstacks_in_layer_order():
    jcfg, tcfg = _cfgs("w4a4_lut")
    jp, tp = _params("w4a4_lut")
    wq = np.asarray(jp["blocks"][0]["attn"]["wq"]["w_q"])     # [G, K/2, N]
    for g in range(tcfg.n_layers):
        got = tp["blocks"][g]["attn"]["wq"]["w_q"]
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), wq[g])
    assert tp["lm_head"]["w_q"].dtype == torch.int8


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(tcfg, 2, 8)


def test_unported_features_raise():
    """Soft-caps, sliding windows, gemma norms, the embedding scale and
    GeGLU are served now (``tests/test_torch_gemma2.py``), and so are the
    layer norm and the Mamba2 / RWKV6 blocks (``tests/test_torch_ssm*.py``),
    M-RoPE (``tests/test_torch_mrope.py``), an int8 KV cache beside local,
    soft-capped, recurrent and MoE blocks
    (``tests/test_torch_int8_families.py``), and a decoder without rotary
    embeddings or with the GELU MLP
    (``tests/test_torch_decoder_variants.py``), and the split-head 3D
    attention leaves (``tests/test_torch_split_heads.py``); these are not
    (enc-dec configs are ``models.encdec``'s)."""
    _, tcfg = _cfgs()
    local = (tconfigs.BlockSpec(attn_type="local"),)
    for over, match in (
            (dict(norm="groupnorm"), "norm"),
            (dict(rope_mode="alibi"), "rope_mode"),
            (dict(enc_dec=True), "enc_dec"),
            (dict(kv_quant="fp8"), "kv_quant"),
            (dict(pattern=(tconfigs.BlockSpec(kind="s4"),)),
             "block kind"),
            (dict(pattern=(tconfigs.BlockSpec(mlp="relu_sq"),)), "mlp")):
        with pytest.raises(NotImplementedError, match=match):
            TT.check_supported(dataclasses.replace(tcfg, **over))
    for over in (dict(rope_mode="none"),
                 dict(pattern=(tconfigs.BlockSpec(kind="mamba2"),),
                      kv_quant="int8"),
                 dict(pattern=(tconfigs.BlockSpec(mlp="gelu"),)),
                 dict(pattern=local, window=8, kv_quant="int8"),
                 dict(attn_softcap=50.0, kv_quant="int8"),
                 dict(split_head_params=True)):
        TT.check_supported(dataclasses.replace(tcfg, **over))
    # a window without local layers changes nothing, as in the reference
    TT.check_supported(dataclasses.replace(tcfg, window=8,
                                           final_softcap=30.0))


def test_quantized_params_serve_same_logits_through_both_walks():
    """Port quantize-at-load on converted float weights == converting the
    reference's quantized tree: same codes, same logits."""
    jcfg, tcfg = _cfgs("w4a4_lut")
    jp_float, tp_float = _params("none")
    _, tp_q = _params("w4a4_lut")
    tq = quantize_params_for_serving(tp_float, mode="w4a4_lut")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab, (1, 5)))
    a, _ = TT.forward(tq, tcfg, toks)
    b, _ = TT.forward(tp_q, tcfg, toks)
    assert torch.equal(a, b)
