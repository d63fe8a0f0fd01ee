"""Port vs reference, the encoder-decoder family (whisper-large-v3) at its
smoke config on the CPU: float32 compute, plain kernel versions, the
reference compiled with ``jax.jit`` (backend ``ref``).

* the configs field for field; ``sinusoids`` (XLA's ``exp`` / ``sin`` /
  ``cos`` differ from ATen's by ulps: within 1e-6 at the smoke widths, a
  row's bits independent of the table's length);
* ``encode``, ``forward``, ``prefill`` (logits and every cache leaf) and
  ``precompute_cross_kv`` within 1e-5, float and ``w4a4_lut``;
* ``decode_step`` dense within 1e-5 of the reference's (a free row among
  them), and paged through a page table == dense bitwise (logits and K/V);
* ``params_from_jax`` of both stacks; the quantize walk's codes bitwise
  equal to the reference's for every enc-dec leaf, the tied embedding
  float; ``init_served_params`` == quantizing ``init_params``;
* ``Engine.generate(frames=)`` transcripts equal to the reference's
  ``generate(use_scan=False)`` in ``w4a4_lut`` (and float), ``_grow_cache``;
* the refusals: the Scheduler, ``step``, ``admit_monolithic``, a paged
  engine and speculative decoding, with the reference's types and
  messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import encdec as JE
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import (init_served_params,
                                        quantize_params_for_serving)

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-large-v3"
ATOL = 1e-5                  # float32 sums in other orders, XLA's sin/tanh
SIN_ATOL = 1e-6              # sinusoids at the smoke widths (measured 6e-8)
MAX_LEN = 16
PS = 4
J_ENCODE = jax.jit(JE.encode, static_argnums=1)
J_FORWARD = jax.jit(JE.forward, static_argnums=1)
J_PREFILL = jax.jit(JE.prefill, static_argnums=1)
J_DECODE = jax.jit(JE.decode_step, static_argnums=1)
J_XKV = jax.jit(JE.precompute_cross_kv, static_argnums=1)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfg(mod, quant="none"):
    return dataclasses.replace(mod.get_config(ARCH, smoke=True, quant=quant),
                               compute_dtype="float32")


_P = {}


def _params(quant="none"):
    """The reference's float32 smoke parameters (quantized by the
    reference for ``quant``) and the port's copy, made once."""
    if quant not in _P:
        if quant == "none":
            jp = JE.init_params(jax.random.PRNGKey(0), _cfg(jconfigs))
        else:
            jp = jquantize(_params()[0], quant)
        _P[quant] = (jp, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                jp),
                                         _cfg(tconfigs), device="cpu"))
    return _P[quant]


def _frames(B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, 32, 64)).astype(np.float32)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# config, positions, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_config_fields_match_reference(smoke, quant):
    want = jconfigs.get_config(ARCH, smoke=smoke, quant=quant)
    got = tconfigs.get_config(ARCH, smoke=smoke, quant=quant)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    TE.check_supported(got)
    with pytest.raises(NotImplementedError, match="enc_dec"):
        TT.check_supported(got)


@pytest.mark.parametrize("length,d", [(32, 64), (16, 64), (5, 32)])
def test_sinusoids_match_reference(length, d):
    want = np.asarray(jax.jit(JE.sinusoids, static_argnums=(0, 1))(length,
                                                                    d))
    got = TE.sinusoids(length, d, "cpu")
    assert got.dtype == torch.float32 and got.shape == (length, d)
    _close(got, want, SIN_ATOL)


def test_sinusoid_rows_do_not_depend_on_the_table_length():
    """Decode reads row ``pos`` of ``sinusoids(max_len)``; prefill takes
    the first S rows of ``sinusoids(S)``: the same bits."""
    long = TE.sinusoids(448, 1280, "cpu")
    for S in (1, 4, 67, 448):
        assert torch.equal(TE.sinusoids(S, 1280, "cpu"), long[:S])


def test_params_from_jax_unstacks_both_stacks():
    jp, tp = _params()
    cfg = _cfg(tconfigs)
    assert len(tp["enc_blocks"]) == cfg.n_enc_layers
    assert len(tp["dec_blocks"]) == cfg.n_layers
    for stack in ("enc_blocks", "dec_blocks"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp[stack]):
            for i, bp in enumerate(tp[stack]):
                node = bp
                for k in path:
                    node = node[k.key]
                assert np.array_equal(_np(node), np.asarray(leaf[i]))
    assert np.array_equal(_np(tp["embed"]["emb"]),
                          np.asarray(jp["embed"]["emb"]))
    assert set(tp) == set(jp)


def _code_leaves(tree):
    return {jax.tree_util.keystr(p): _np(v)
            for p, v in jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(_np, tree))}


def test_quantize_walk_codes_equal_reference():
    """Port quantize-at-load of the converted float tree == the reference's
    quantized tree converted: every leaf, codes and scales, bitwise; 6
    projections an encoder layer and 10 a decoder layer become nibbles,
    the tied float embedding stays."""
    got = _code_leaves(quantize_params_for_serving(_params()[1],
                                                   "w4a4_lut"))
    want = _code_leaves(_params("w4a4_lut")[1])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    codes = [k for k in want if k.endswith("['w_q']")]
    assert all(want[k].dtype == np.uint8 for k in codes)
    cfg = _cfg(tconfigs)
    assert len(codes) == 6 * cfg.n_enc_layers + 10 * cfg.n_layers
    assert want["['embed']['emb']"].dtype == np.float32
    assert not any("w_q" in k for k in want if "embed" in k)


def test_init_served_params_equals_quantized_init():
    cfg = tconfigs.get_config(ARCH, smoke=True, quant="w4a4_lut")
    got = _code_leaves(init_served_params(cfg, "w4a4_lut", seed=0,
                                          device="cpu"))
    want = _code_leaves(quantize_params_for_serving(
        TE.init_params(cfg, 0, "cpu"), "w4a4_lut"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_encode_forward_prefill_match_reference(quant):
    """encode, forward and prefill of 3 rows (5 prompt tokens): the
    encoder output, the logits and every cache leaf (self K/V and the
    cross K/V of ``precompute_cross_kv``) within 1e-5."""
    jp, tp = _params(quant)
    jc, tc = _cfg(jconfigs, quant), _cfg(tconfigs, quant)
    frames, toks = _frames(3), _tokens(3, 5)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    enc_w = J_ENCODE(jp, jc, jf)
    enc_t = TE.encode(tp, tc, tf)
    _close(enc_t, enc_w, what="encode")
    _close(TE.forward(tp, tc, tf, tt), J_FORWARD(jp, jc, jf, jt),
           what="forward")
    lw, jcache = J_PREFILL(jp, jc, jf, jt)
    lt, tcache = TE.prefill(tp, tc, tf, tt)
    assert lt.dtype == torch.float32 and lt.shape == (3, tc.vocab)
    _close(lt, lw, what="prefill logits")
    for key in ("k", "v", "xk", "xv"):
        for i, c in enumerate(tcache):
            _close(c[key], jcache[key][i], what=f"layer {i} {key}")
    # precompute_cross_kv alone, on the same encoder output
    xkv = J_XKV(jp, jc, enc_w, JE.init_cache(jc, 3, 8))
    got = TE.precompute_cross_kv(tp, tc, torch.from_numpy(np.array(enc_w)),
                                 [{} for _ in range(tc.n_layers)])
    for i, c in enumerate(got):
        for key in ("xk", "xv"):
            _close(c[key], xkv[key][i], what=f"cross {key} {i}")


def _decode_run(quant, paged: bool, steps=6):
    """Prefill 3 rows, grow to MAX_LEN, then ``steps`` decode steps with
    row 1 free (negative position): the port dense, or through a page
    table of 4-token pages (each live row its own pages, the free row's
    table all zeros), and the reference dense."""
    jp, tp = _params(quant)
    jc, tc = _cfg(jconfigs, quant), _cfg(tconfigs, quant)
    frames, toks = _frames(3), _tokens(3, 5)
    lw, jcache = J_PREFILL(jp, jc, jnp.asarray(frames), jnp.asarray(toks))
    lt, tcache = TE.prefill(tp, tc, torch.from_numpy(frames),
                            torch.from_numpy(toks))
    jeng = jserve.make_engine(jp, jc, jserve.ServeConfig(max_len=MAX_LEN))
    teng = tserve.make_engine(tp, tc, tserve.ServeConfig(max_len=MAX_LEN),
                              device="cpu")
    jcache = jeng._grow_cache(jcache, 5)
    tcache = teng._grow_cache(tcache, 5)
    tables = None
    if paged:
        E = MAX_LEN // PS
        table = torch.zeros((3, E), dtype=torch.int32)
        table[0] = torch.arange(1, E + 1)
        table[2] = torch.arange(E + 1, 2 * E + 1)
        pools = TE.init_paged_cache(tc, 3, MAX_LEN, 2 * E + 1, PS, "cpu")
        for c, pc in zip(tcache, pools):
            for key in ("k", "v"):
                for row in (0, 2):
                    pc[key][table[row].long()] = c[key][row].reshape(
                        E, PS, *c[key].shape[2:])
            pc["xk"].copy_(c["xk"])
            pc["xv"].copy_(c["xv"])
        tcache, tables = pools, (table, None)
    pos = np.array([5, -1, 5], np.int32)
    tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
    outs = []
    for step in range(steps):
        lw, jcache = J_DECODE(jp, jc, jnp.asarray(tok), jcache,
                              jnp.asarray(pos))
        lt, tcache = TE.decode_step(tp, tc, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos), tables)
        outs.append((lt.clone(), np.asarray(lw)))
        tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    return outs, tcache, tables, jcache


_DEC = {}


def _decode(quant, paged):
    if (quant, paged) not in _DEC:
        _DEC[quant, paged] = _decode_run(quant, paged)
    return _DEC[quant, paged]


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_steps_match_reference(quant):
    outs, tcache, _, jcache = _decode(quant, False)
    for step, (lt, lw) in enumerate(outs):
        assert lt.dtype == torch.float32
        _close(lt, lw, what=f"step {step}")
    for i, c in enumerate(tcache):
        for key in ("k", "v"):
            want = np.asarray(jcache[key][i])
            # the free row (1) writes its clamped slot 0 in both packages
            _close(c[key], want, what=f"layer {i} {key}")


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_paged_decode_equals_dense_bitwise(quant):
    dense, dcache, _, _ = _decode(quant, False)
    paged, pcache, (table, _), _ = _decode(quant, True)
    live = [0, 2]         # a free row's all-masked softmax reads its own
    for step, ((a, _), (b, _)) in enumerate(zip(dense, paged)):  # row
        assert torch.equal(a[live], b[live]), step
    for dc, pc in zip(dcache, pcache):
        for key in ("k", "v"):
            got = TE.attn_lib.paged_gather(pc[key], table)
            for row in (0, 2):        # the live rows; the free row writes
                assert torch.equal(got[row], dc[key][row]), key   # page 0


def test_init_cache_shapes():
    tc = _cfg(tconfigs)
    cache = TE.init_cache(tc, 3, MAX_LEN, "cpu")
    assert len(cache) == tc.n_layers
    for c in cache:
        assert c["k"].shape == (3, MAX_LEN, tc.n_kv, tc.head_dim)
        assert c["xv"].shape == (3, tc.enc_seq, tc.n_kv, tc.head_dim)
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in c.values())
    paged = TE.init_paged_cache(tc, 3, MAX_LEN, 9, PS, "cpu")
    assert paged[0]["k"].shape == (9, PS, tc.n_kv, tc.head_dim)
    assert paged[0]["xk"].shape == (3, tc.enc_seq, tc.n_kv, tc.head_dim)
    with pytest.raises(ValueError, match="must divide max_len"):
        TE.init_paged_cache(tc, 3, MAX_LEN, 9, 5, "cpu")


# ---------------------------------------------------------------------------
# serving: generate(frames=)
# ---------------------------------------------------------------------------

def _engines(quant):
    sc = dict(max_len=MAX_LEN, quant=None if quant == "none" else quant)
    jp, tp = _params()
    return (jserve.make_engine(jp, _cfg(jconfigs, quant),
                               jserve.ServeConfig(**sc)),
            tserve.make_engine(tp, _cfg(tconfigs, quant),
                               tserve.ServeConfig(**sc), device="cpu"))


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_generate_with_frames_equals_reference(quant):
    """4 rows of 4-token prompts, 10 new tokens each: the port's
    ``generate(frames=)`` (weights quantized at load) == the reference's
    ``generate(use_scan=False)`` token for token."""
    jeng, teng = _engines(quant)
    frames, toks = _frames(4, seed=3), _tokens(4, 4, seed=4)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 10,
                                    frames=jnp.asarray(frames),
                                    use_scan=False))
    got = teng.generate(torch.from_numpy(toks), 10,
                        frames=torch.from_numpy(frames))
    assert _np(got).tolist() == want.tolist()
    assert teng.decode_steps == 9
    assert teng.requires_monolithic_admission and not \
        teng.has_recurrent_state


def test_kv_cache_bytes_equal_reference():
    """The reference counts the cross K/V with the self K/V; the figure
    is the bytes of ``init_cache``'s leaves."""
    jeng, teng = _engines("none")
    assert teng.kv_cache_bytes(3) == jeng.kv_cache_bytes(3)
    assert teng.kv_cache_bytes(3) == sum(
        t.numel() * t.element_size()
        for c in TE.init_cache(_cfg(tconfigs), 3, MAX_LEN, "cpu")
        for t in c.values())


def test_grow_cache_pads_self_kv_only():
    jeng, teng = _engines("none")
    _, cache = TE.prefill(_params()[1], _cfg(tconfigs),
                          torch.from_numpy(_frames(2)),
                          torch.from_numpy(_tokens(2, 5)))
    ptrs = [c["xk"].data_ptr() for c in cache]
    grown = teng._grow_cache(cache, 5)
    for c, g, p in zip(cache, grown, ptrs):
        for key in ("k", "v"):
            assert g[key].shape[1] == MAX_LEN
            assert torch.equal(g[key][:, :5], c[key])
            assert not g[key][:, 5:].any()
        assert g["xk"].data_ptr() == p and g["xv"].shape[1] == 32


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _both(fn):
    """fn(pkg_serve, engine) raising in both packages: (type, message)
    each."""
    out = []
    for mod, eng in zip((jserve, tserve), _engines("none")):
        with pytest.raises(Exception) as err:
            fn(mod, eng)
        out.append((type(err.value).__name__, str(err.value)))
    return out


def test_scheduler_refuses_encdec():
    j, t = _both(lambda mod, eng: mod.Scheduler(eng, slots=2))
    assert j == t and t[0] == "NotImplementedError"
    assert "decoder-only" in t[1]


def test_step_and_admission_refuse_encdec():
    _, teng = _engines("none")
    z = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(NotImplementedError,
                       match="enc-dec uses Engine.generate"):
        teng.step([], None, z, z, torch.zeros((2,), dtype=torch.bool), z, 1)
    with pytest.raises(NotImplementedError,
                       match="enc-dec uses Engine.generate"):
        teng.admit_monolithic([], np.zeros((2, 4), np.int32), [4, 4],
                              [True, True], [False, False], z, z, z,
                              torch.zeros((2,), dtype=torch.bool))
    # the reference's message, word for word
    jeng, _ = _engines("none")
    with pytest.raises(NotImplementedError) as err:
        jeng.step(None, None, None, None, None, None, None, None, None, 1, 1)
    assert str(err.value) == ("continuous batching serves decoder-only "
                              "LMs; enc-dec uses Engine.generate")


@pytest.mark.parametrize("over,kind", [
    (dict(paged=True, page_size=4), "paged"),
    (dict(spec_decode=True), "spec")])
def test_paged_and_speculative_engines_refuse_encdec(over, kind):
    msgs = []
    for mod, p, pkw in ((jserve, _params()[0], {}),
                        (tserve, _params()[1], dict(device="cpu"))):
        cfgs = jconfigs if mod is jserve else tconfigs
        with pytest.raises(Exception) as err:
            mod.make_engine(p, _cfg(cfgs), mod.ServeConfig(
                max_len=MAX_LEN, **over), **pkw)
        msgs.append((type(err.value).__name__, str(err.value)))
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == ("NotImplementedError" if kind == "paged"
                          else "ValueError")


def test_generate_without_frames_and_decoder_configs_raise():
    _, teng = _engines("none")
    with pytest.raises(ValueError, match="needs the frames"):
        teng.generate(torch.from_numpy(_tokens(2, 4)), 3)
    with pytest.raises(ValueError, match="enc_dec configs"):
        TE.check_supported(tconfigs.get_config("qwen2-7b", smoke=True))
