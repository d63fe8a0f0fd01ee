"""Port vs reference, Qwen2-VL's M-RoPE and the stub embeddings frontend
(qwen2-vl-72b) on the CPU: float32 compute, plain kernel versions, the
reference compiled with ``jax.jit`` where it is a whole model.

* the configs field for field; ``layers.apply_mrope`` on random 3-D
  positions within 1e-5 of the reference's (XLA's ``sin`` / ``cos``
  differ from ATen's by an ulp; outputs of magnitude <= 4), and bitwise
  equal to ``apply_rope`` when t = h = w;
* the three decode sites with ``rope_mode="mrope"``: ``decode_attention``,
  ``decode_attention_multi`` and ``decode_attention_int8`` (int8 codes
  exactly), each within 1e-5 of the reference's and bitwise equal to the
  port's own ``rope_mode="rope"``; ``verify_step`` on the qwen2-vl smoke
  model within 1e-5 of the reference's and bitwise equal to sequential
  decode steps;
* ``forward`` / ``prefill`` with ``embeddings`` + 3-D ``mrope_positions``
  (a patch grid between text) within 1e-5 of the reference's, float and
  ``w4a4_lut``;
* the Scheduler's transcripts on the qwen2-vl smoke model (chunk lane,
  mixed lengths) equal to the reference Scheduler's and to ``generate``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=0, atol=1e-5)
MAX_LEN = 32
SECTIONS = (2, 3, 3)
J_FORWARD = jax.jit(JT.forward, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=1)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _cfg(mod, quant="none", **over):
    return dataclasses.replace(mod.get_config(ARCH, smoke=True, quant=quant),
                               compute_dtype="float32", **over)


_P = {}


def _params(quant="none"):
    if quant not in _P:
        if quant == "none":
            jp = JT.init_params(jax.random.PRNGKey(0), _cfg(jconfigs))
        else:
            jp = jquantize(_params()[0], quant)
        _P[quant] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _cfg(tconfigs),
            device="cpu"))
    return _P[quant]


def vision_positions(B: int, text: int, grid: int, tail: int) -> np.ndarray:
    """[B, text + grid^2 + tail, 3] M-RoPE ids of ``text`` tokens, a
    ``grid`` x ``grid`` patch grid (t fixed, h the row, w the column, all
    offset by the text before it) and ``tail`` text tokens continuing from
    the grid's max + 1."""
    ids = [[i, i, i] for i in range(text)]
    ids += [[text, text + r, text + c] for r in range(grid)
            for c in range(grid)]
    nxt = text + grid
    ids += [[nxt + i] * 3 for i in range(tail)]
    return np.broadcast_to(np.asarray(ids, np.int32),
                           (B, len(ids), 3)).copy()


# ---------------------------------------------------------------------------
# config and the rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_config_fields_match_reference(smoke, quant):
    want = jconfigs.get_config(ARCH, smoke=smoke, quant=quant)
    got = tconfigs.get_config(ARCH, smoke=smoke, quant=quant)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    TT.check_supported(got)


@pytest.mark.parametrize("D,sections", [(16, (2, 3, 3)), (128, (16, 24, 24)),
                                        (16, (2, 3, 2)), (16, (4, 4, 4))])
def test_apply_mrope_matches_reference(D, sections):
    """Random positions in [0, 4096) per component; ``sections`` summing
    to D/2, short of it (the last id repeats) and past it (cut)."""
    rng = np.random.default_rng(D + sum(sections))
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = TL.apply_mrope(*_t(x, pos), sections, 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_mrope_with_equal_ids_is_rope_bitwise(theta):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 9, 4, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 5000, (3, 9)).astype(np.int32))
    got = TL.apply_mrope(x, pos[..., None].expand(3, 9, 3), SECTIONS, theta)
    assert torch.equal(got, TL.apply_rope(x, pos, theta))
    assert torch.equal(TL.rotate(x, pos, "mrope", theta, SECTIONS), got)
    assert TL.rotate(x, pos, "none", theta) is x


# ---------------------------------------------------------------------------
# the decode sites
# ---------------------------------------------------------------------------

def _attn_case(quant, seed, B=3, T=16, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    d = H * D
    jp = JA.init_attention(jax.random.PRNGKey(seed), d, H, Hkv, D,
                           qkv_bias=True)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)
    if quant != "none":
        jp = jquantize({"attn": jp}, mode=quant)["attn"]
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    ck = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=D, quant=quant,
              rope_theta=1e6)
    return jp, tp, rng, ck, cv, kw


def _modes(fn):
    """fn(rope_mode, sections) under mrope and rope."""
    return fn("mrope", SECTIONS), fn("rope", ())


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_attention_mrope(quant):
    jp, tp, rng, ck, cv, kw = _attn_case(quant, 2)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    pos = np.array([4, -1, 15], np.int32)
    wy, wk, _ = JA.decode_attention(jp, *map(jnp.asarray, (x, ck, cv, pos)),
                                    rope_mode="mrope",
                                    mrope_sections=SECTIONS,
                                    compute_dtype=jnp.float32, **kw)

    def run(mode, sections):
        return TA.decode_attention(tp, *_t(x, ck, cv, pos), rope_mode=mode,
                                   mrope_sections=sections,
                                   compute_dtype=torch.float32, **kw)
    (y, k, _), (ry, rk, _) = _modes(run)
    assert torch.equal(y, ry) and torch.equal(k, rk)
    live = pos >= 0
    np.testing.assert_allclose(_np(y)[live], np.asarray(wy)[live], **TOL)
    np.testing.assert_allclose(_np(k), np.asarray(wk), **TOL)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_attention_multi_mrope(quant):
    jp, tp, rng, ck, cv, kw = _attn_case(quant, 3)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    pos = np.array([2, 9, -1], np.int32)
    wy, wk, _ = JA.decode_attention_multi(
        jp, *map(jnp.asarray, (x, ck, cv, pos)), rope_mode="mrope",
        mrope_sections=SECTIONS, compute_dtype=jnp.float32, **kw)

    def run(mode, sections):
        return TA.decode_attention_multi(
            tp, *_t(x, ck, cv, pos), rope_mode=mode, mrope_sections=sections,
            compute_dtype=torch.float32, **kw)
    (y, k, _), (ry, rk, _) = _modes(run)
    assert torch.equal(y, ry) and torch.equal(k, rk)
    np.testing.assert_allclose(_np(y)[:2], np.asarray(wy)[:2], **TOL)
    np.testing.assert_allclose(_np(k)[:2], np.asarray(wk)[:2], **TOL)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_attention_int8_mrope(quant):
    jp, tp, rng, ck, cv, kw = _attn_case(quant, 4)
    cache = {}
    for name, rows in (("k", ck), ("v", cv)):
        codes, scales = JA.quantize_kv(jnp.asarray(rows))
        cache[name], cache[name + "_scale"] = (np.asarray(codes),
                                               np.asarray(scales))
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    pos = np.array([3, 11, -1], np.int32)
    wy, wc = JA.decode_attention_int8(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos), rope_mode="mrope", mrope_sections=SECTIONS,
        compute_dtype=jnp.float32, **kw)

    def run(mode, sections):
        return TA.decode_attention_int8(
            tp, torch.from_numpy(x),
            {k: torch.from_numpy(np.array(v)) for k, v in cache.items()},
            torch.from_numpy(pos), rope_mode=mode, mrope_sections=sections,
            compute_dtype=torch.float32, **kw)
    (y, c), (ry, rc) = _modes(run)
    assert torch.equal(y, ry)
    assert all(torch.equal(c[k], rc[k]) for k in c)
    np.testing.assert_allclose(_np(y)[:2], np.asarray(wy)[:2], **TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(c[name]), np.asarray(wc[name]))
        np.testing.assert_allclose(_np(c[name + "_scale"]),
                                   np.asarray(wc[name + "_scale"]), **TOL)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_verify_step_mrope_matches_reference_and_sequential_decode(quant):
    """After 5 decode steps of history, one verify over 3 tokens on the
    qwen2-vl smoke model: within 1e-5 of the reference's verify_step, and
    bitwise equal to 3 sequential port decode steps."""
    jp, tp = _params(quant)
    jc, tc = _cfg(jconfigs, quant), _cfg(tconfigs, quant)
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 512, (3, 5)).astype(np.int32)
    toks = rng.integers(0, 512, (3, 3)).astype(np.int32)
    jcache = JT.init_cache(jc, 3, 16)
    tcache = TT.init_cache(tc, 3, 16, device="cpu")
    pos = np.array([0, 3, -1], np.int32)
    for j in range(hist.shape[1]):
        _, jcache = JT.decode_step(jp, jc, jnp.asarray(hist[:, j]), jcache,
                                   jnp.asarray(pos))
        _, tcache = TT.decode_step(tp, tc, torch.from_numpy(hist[:, j]),
                                   tcache, torch.from_numpy(pos.copy()))
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    want, _ = JT.verify_step(jp, jc, jnp.asarray(toks), jcache,
                             jnp.asarray(pos))
    seq = [{k: v.clone() for k, v in c.items()} for c in tcache]
    got, tcache = TT.verify_step(tp, tc, torch.from_numpy(toks), tcache,
                                 torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got)[:2], np.asarray(want)[:2], **TOL)
    p = torch.from_numpy(pos.copy())
    for i in range(3):
        li, seq = TT.decode_step(tp, tc, torch.from_numpy(toks[:, i]), seq,
                                 torch.where(p >= 0, p + i, p))
        assert torch.equal(got[:2, i], li[:2]), i


# ---------------------------------------------------------------------------
# the stub frontend: embeddings + 3-D positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_forward_prefill_with_embeddings_match_reference(quant):
    """2 rows of 3 text tokens, a 4x4 patch grid and 2 text tokens (21
    positions): forward logits and prefill's logits and K/V within 1e-5;
    the same embeddings at t = h = w (text) equal the port's rope path
    bitwise."""
    jp, tp = _params(quant)
    jc, tc = _cfg(jconfigs, quant), _cfg(tconfigs, quant)
    mpos = vision_positions(2, 3, 4, 2)
    S = mpos.shape[1]
    emb = np.random.default_rng(6).standard_normal((2, S, 64)).astype(
        np.float32)
    lw, _ = J_FORWARD(jp, jc, None, embeddings=jnp.asarray(emb),
                      mrope_positions=jnp.asarray(mpos))
    lf, _ = TT.forward(tp, tc, embeddings=torch.from_numpy(emb),
                       mrope_positions=torch.from_numpy(mpos))
    assert lf.shape == (2, S, tc.vocab)
    np.testing.assert_allclose(_np(lf), np.asarray(lw), **TOL)
    lw, jcache = J_PREFILL(jp, jc, None, embeddings=jnp.asarray(emb),
                           mrope_positions=jnp.asarray(mpos))
    lt, tcache = TT.prefill(tp, tc, embeddings=torch.from_numpy(emb),
                            mrope_positions=torch.from_numpy(mpos))
    np.testing.assert_allclose(_np(lt), np.asarray(lw), **TOL)
    for i, c in enumerate(tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key]),
                                       np.asarray(jcache[0][key][i]), **TOL)
    # the grid moves the logits; text ids (t = h = w) are rope's
    text, _ = TT.forward(tp, tc, embeddings=torch.from_numpy(emb))
    assert not torch.equal(text, lf)
    rope, _ = TT.forward(tp, _cfg(tconfigs, quant, rope_mode="rope"),
                         embeddings=torch.from_numpy(emb))
    assert torch.equal(text, rope)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

LENS = [6, 4, 9, 5, 12]
BUDGETS = [5, 6, 4, 3, 6]


def _traffic(mod):
    rng = np.random.default_rng(3)
    return [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]


_RUNS = {}


def _serve(pkg):
    if pkg not in _RUNS:
        mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
        kw = dict(device="cpu") if pkg == "t" else {}
        eng = mod.make_engine(_params()[0 if pkg == "j" else 1],
                              _cfg(cfgs, "w4a4_lut"),
                              mod.ServeConfig(quant="w4a4_lut",
                                              max_len=MAX_LEN), **kw)
        sched = mod.Scheduler(eng, slots=3, chunk=2)
        reqs = _traffic(mod)
        sched.run(reqs)
        _RUNS[pkg] = (sched, eng, [(r.finish_reason, list(r.tokens))
                                   for r in reqs])
    return _RUNS[pkg]


def test_scheduler_transcripts_equal_reference():
    jsched, _, want = _serve("j")
    tsched, teng, got = _serve("t")
    assert got == want
    assert all(reason == "length" for reason, _ in got)
    for k in ("rounds", "admitted_tokens", "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k
    assert teng.lane_steps["chunk"] > 0 and not teng.prefill_steps


def test_scheduler_equals_generate():
    _, teng, got = _serve("t")
    for r, (_, toks) in zip(_traffic(tserve), got):
        out = teng.generate(torch.tensor([r.prompt]), r.max_new_tokens)
        assert _np(out[0, len(r.prompt):]).tolist() == toks
