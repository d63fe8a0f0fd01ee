"""Port vs reference, the int8 KV cache on every family that holds more
than global attention layers: gemma2-2b (local rings beside global layers,
the attention soft-cap), qwen2-moe-a2.7b and mixtral-8x22b (MoE blocks;
every mixtral layer is local), zamba2-2.7b (Mamba2 layers and the shared
attention block) and rwkv6-1.6b (no attention at all), at their smoke
configs, float32 compute, plain kernel versions.

Under ``kv_quant="int8"`` only a global attention layer holds int8 codes
and float32 scales; a local layer's ring, the shared block's K/V and every
recurrent state stay float, as the reference's ``init_cache`` lays them
out.  Checked here:

* ``init_cache`` / ``init_paged_cache`` leaves per layer (names, dtypes,
  shapes) against the reference's ``[G, ...]`` stacks, and the engine's
  KV byte figures against the reference engine's;
* ``int8_kv_attention`` with a soft-cap and a window within 1e-5 of the
  reference's (a probability code at a .5 boundary may round the other
  way: as in ``tests/test_torch_int8_kv.py``, such a code moved by one,
  and its row is left out);
* twelve int8 decode steps of gemma2 (window 8: the rings wrap) and
  qwen2-moe against the reference, paged == dense;
* the Scheduler's transcripts equal the reference's, dense and paged, for
  the five families (3 staggered requests of 5, 12 and 20 tokens on 2
  slots: every admission monolithic, gemma2's and mixtral's rings wrapped);
* at a binding MoE capacity, paged == dense in both packages only while no
  freed slot is in front of a live one (a free slot's row routes too and
  attends over other garbage in each layout), the port equal to the
  reference in each layout either way.
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
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["gemma2-2b", "qwen2-moe-a2.7b", "zamba2-2.7b", "rwkv6-1.6b",
         "mixtral-8x22b"]
TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-5
MAX_LEN = 64
LAYOUTS = {"dense": {}, "paged": dict(paged=True, page_size=4)}
LENS = [5, 12, 20]
BUDGETS = [6, 5, 4]
J_DECODE = jax.jit(JT.decode_step, static_argnums=1)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfg(mod, arch, quant="w4a4_lut", kv_quant="int8"):
    return dataclasses.replace(mod.get_config(arch, smoke=True, quant=quant),
                               compute_dtype="float32", kv_quant=kv_quant)


_P = {}


def _params(arch):
    """The reference's smoke parameters quantized by the reference for
    ``w4a4_lut`` and the port's copy, made once."""
    if arch not in _P:
        jp = jquantize(JT.init_params(jax.random.PRNGKey(0),
                                      _cfg(jconfigs, arch, "none")),
                       "w4a4_lut")
        _P[arch] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _cfg(tconfigs, arch),
            device="cpu"))
    return _P[arch]


# ---------------------------------------------------------------------------
# cache leaves and KV bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_leaves_per_layer_match_reference(arch, paged):
    """Layer ``g * P + j`` of the port holds group g of the reference's
    pattern position j: the same leaves, dtypes and shapes; int8 codes
    only on global attention layers."""
    jcfg, tcfg = _cfg(jconfigs, arch), _cfg(tconfigs, arch)
    if paged:
        jc = JT.init_paged_cache(jcfg, 3, 16, 13, 4)
        tc = TT.init_paged_cache(tcfg, 3, 16, 13, 4, device="cpu")
    else:
        jc = JT.init_cache(jcfg, 3, 16)
        tc = TT.init_cache(tcfg, 3, 16, device="cpu")
    P = len(tcfg.pattern)
    assert len(tc) == tcfg.n_layers
    n_int8 = 0
    for i, c in enumerate(tc):
        spec = TT.layer_spec(tcfg, i)
        ref = jc[i % P]
        assert set(c) == set(ref), i
        for key, leaf in c.items():
            assert tuple(leaf.shape) == ref[key].shape[1:], (i, key)
            assert str(leaf.dtype)[6:] == str(ref[key].dtype), (i, key)
            assert not leaf.any()
        int8 = spec.kind == "attn" and not TT.is_local(tcfg, spec)
        assert ("k_scale" in c) == int8, i
        n_int8 += int8
        for key in ("shared_k", "shared_v") + TT.STATE_KEYS:
            if key in c:
                assert c[key].dtype != torch.int8
    assert n_int8 == {"gemma2-2b": tcfg.n_layers // 2,
                      "qwen2-moe-a2.7b": tcfg.n_layers}.get(arch, 0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_match_reference_per_family(arch, paged):
    """``_kv_leaf_bytes``, ``page_bytes`` and ``kv_cache_bytes`` of an int8
    engine equal the reference engine's, layer by layer mixed leaves
    included; the figures of zamba2, rwkv6 and mixtral equal their float
    engines' (no leaf of theirs changes)."""
    jp, tp = _params(arch)
    kw = dict(max_len=32, **(LAYOUTS["paged"] if paged else {}))
    je = jserve.Engine(_cfg(jconfigs, arch), jp, jserve.ServeConfig(**kw))
    te = tserve.Engine(_cfg(tconfigs, arch), tp, tserve.ServeConfig(**kw),
                       device="cpu")
    tf = tserve.Engine(_cfg(tconfigs, arch, kv_quant="none"), tp,
                       tserve.ServeConfig(**kw), device="cpu")
    for batch in (1, 3):
        assert te._kv_leaf_bytes(batch) == je._kv_leaf_bytes(batch)
        if paged:
            assert te.page_bytes(batch) == je.page_bytes(batch)
        assert te.kv_cache_bytes(batch) == je.kv_cache_bytes(batch)
        same = arch in ("zamba2-2.7b", "rwkv6-1.6b", "mixtral-8x22b")
        assert (te.kv_cache_bytes(batch) == tf.kv_cache_bytes(batch)) == same


# ---------------------------------------------------------------------------
# int8_kv_attention with a soft-cap and a window
# ---------------------------------------------------------------------------

def _case(seed, B=3, Hq=4, Hkv=2, D=16, T=40):
    rng = np.random.default_rng(seed)
    q = (3.0 * rng.standard_normal((B, 1, Hq, D))).astype(np.float32)
    k = (2.0 * rng.standard_normal((B, T, Hkv, D))).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    kq, ks = (np.array(a) for a in JA.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in JA.quantize_kv(jnp.asarray(v)))
    pos = np.array([T - 1, 17, -1][:B], np.int32)
    k_pos = np.asarray(TA.decode_kv_positions(torch.from_numpy(pos), T))
    return q, kq, ks, vq, vs, pos[:, None], k_pos


def _ref_p_int(args, p_scale, kw):
    """The reference's probability codes [B, 1, Hkv, G, T], read back by
    probing its attention with one-hot V codes (o[d] = p_int[d + off] *
    p_scale)."""
    q, kq, ks, vq, vs, q_pos, k_pos = args
    B, _, Hq, D = q.shape
    T, Hkv = kq.shape[1], kq.shape[2]
    out = np.zeros((B, 1, Hkv, Hq // Hkv, T), np.int64)
    for off in range(0, T, D):
        v1 = np.zeros((B, T, Hkv, D), np.int8)
        w = min(D, T - off)
        for d in range(w):
            v1[:, off + d, :, d] = 1
        o = np.asarray(JA.int8_kv_attention(
            *map(jnp.asarray, (q, kq, ks, v1, vs, q_pos, k_pos)), **kw))
        o = o.reshape(out.shape[:-1] + (D,)) / p_scale[..., None]
        out[..., off:off + w] = np.rint(o[..., :w]).astype(np.int64)
    return out


@pytest.mark.parametrize("window,softcap", [(None, 5.0), (8, None),
                                            (8, 5.0), (24, 50.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_kv_attention_softcap_and_window_match_reference(
        seed, window, softcap):
    args = _case(seed)
    kw = dict(window=window, logit_softcap=softcap)
    want = np.asarray(JA.int8_kv_attention(*map(jnp.asarray, args), **kw))
    got = _np(TA.int8_kv_attention(*[torch.from_numpy(a) for a in args],
                                   **kw))
    q, kq, ks, vq, vs, q_pos, k_pos = (torch.from_numpy(a) for a in args)
    p_eff, p_scale = TA.int8_kv_probs(q, kq, ks, vs, q_pos, k_pos, **kw)
    ratio = _np(p_eff / p_scale[..., None]).astype(np.float64)
    mine = np.rint(ratio).astype(np.int64)
    theirs = _ref_p_int(args, _np(p_scale), kw)
    moved = mine != theirs
    assert (np.abs(mine - theirs)[moved] == 1).all()
    assert (np.abs(ratio - np.floor(ratio) - 0.5)[moved] < MARGIN).all()
    B, S, Hkv, G, _ = moved.shape
    rows = ~moved.any(-1).reshape(B, S, Hkv * G)
    np.testing.assert_allclose(got[rows], want[rows], **TOL)
    assert rows.mean() > 0.9
    # the window drops keys: row 0 (pos 39) keeps only the last `window`
    if window is not None:
        assert not _np(p_eff)[0, ..., :40 - window].any()


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b"])
def test_decode_step_int8_twelve_steps_match_reference(arch):
    """12 decode steps over an int8 cache (row 1 joins late, row 2 free):
    logits within the tolerance of the reference's, int8 codes equal and
    scales within it, gemma2's float rings (window 8 of a 16-slot cache:
    they wrap) within it; the paged cache gives the dense path's bits."""
    jp, tp = _params(arch)
    jcfg, tcfg = _cfg(jconfigs, arch), _cfg(tconfigs, arch)
    B, T, ps = 3, 16, 4
    rng = np.random.default_rng(12)
    toks = rng.integers(0, tcfg.vocab, (12, B)).astype(np.int32)
    E = T // ps
    table = rng.permutation(np.arange(1, B * E + 1)).reshape(B, E)
    table = table.astype(np.int32)
    table[2] = 0
    W = tcfg.window
    ring = None
    if any(TT.is_local(tcfg, s) for s in tcfg.pattern):
        Er = W // ps
        ring = rng.permutation(np.arange(B * E + 1, B * (E + Er) + 1))
        ring = ring.reshape(B, Er).astype(np.int32)
        ring[2] = 0
    jc = JT.init_cache(jcfg, B, T)
    td = TT.init_cache(tcfg, B, T, device="cpu")
    tpg = TT.init_paged_cache(tcfg, B, T, B * (2 * E) + 1, ps, device="cpu")
    tables = (torch.from_numpy(table),
              None if ring is None else torch.from_numpy(ring))
    for i in range(12):
        pos = np.array([i, i - 4 if i >= 4 else -1, -1], np.int32)
        want, jc = J_DECODE(jp, jcfg, jnp.asarray(toks[i]), jc,
                            jnp.asarray(pos))
        got, td = TT.decode_step(tp, tcfg, torch.from_numpy(toks[i]), td,
                                 torch.from_numpy(pos))
        gp, tpg = TT.decode_step(tp, tcfg, torch.from_numpy(toks[i]), tpg,
                                 torch.from_numpy(pos), tables=tables)
        rows = pos >= 0
        assert torch.equal(gp[rows], got[rows]), i
        np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows],
                                   **TOL)
    live = np.array([True, True, False])
    P = len(tcfg.pattern)
    for i, c in enumerate(td):
        ref = {k: np.asarray(v[i // P]) for k, v in jc[i % P].items()}
        for name, leaf in c.items():
            if leaf.dtype == torch.int8:
                np.testing.assert_array_equal(_np(leaf)[live],
                                              ref[name][live])
            else:
                np.testing.assert_allclose(_np(leaf)[live], ref[name][live],
                                           **TOL)


# ---------------------------------------------------------------------------
# the Scheduler, dense and paged
# ---------------------------------------------------------------------------

def _transcripts(pkg, arch, layout):
    mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
    params = _params(arch)[0 if pkg == "j" else 1]
    kw = dict(device="cpu") if pkg == "t" else {}
    eng = mod.make_engine(params, _cfg(cfgs, arch), mod.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN, **LAYOUTS[layout]), **kw)
    sched = mod.Scheduler(eng, slots=2, chunk=2)
    rng = np.random.default_rng(1)
    reqs = [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return sched, eng, [(r.finish_reason, list(r.tokens)) for r in reqs]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_scheduler_transcripts_equal_reference(arch, layout):
    jsched, _, want = _transcripts("j", arch, layout)
    tsched, teng, got = _transcripts("t", arch, layout)
    assert got == want
    assert [len(t) for _, t in got] == BUDGETS
    assert teng.requires_monolithic_admission
    assert tsched.stats["admission_rounds"] == jsched.stats[
        "admission_rounds"] > 0
    for k in ("rounds", "admitted_tokens", "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k


# ---------------------------------------------------------------------------
# MoE: paged == dense only while no freed slot is in front of a live one
# ---------------------------------------------------------------------------

def _binding_moe(mod):
    """qwen2-moe's smoke config with 60 experts: at 4 slots a decode step's
    capacity is max(1, int(4 * 4 / 60 * 1.25) + 1) = 1, so the rows
    compete for every expert."""
    cfg = _cfg(mod, "qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=60, capacity_factor=1.25))


@pytest.mark.parametrize("budgets,equal", [([2, 3, 20, 20], False),
                                           ([20, 20, 20, 3], True)])
def test_moe_paged_equals_dense_while_no_freed_slot_precedes_a_live_one(
        budgets, equal):
    """A decode step routes every slot's row, a free one's too, with
    capacity in slot order.  A freed slot's row attends over its own stale
    cache row when dense and over the null page when paged, so once it is
    in front of a live row it may take that row's routes in one layout and
    not the other: the reference's dense and paged transcripts then
    differ, and the port reproduces each of them.  When slots free from
    the last one down (budgets that do not grow with the slot), paged ==
    dense in both packages."""
    jcfg, tcfg = _binding_moe(jconfigs), _binding_moe(tconfigs)
    jp = jquantize(JT.init_params(jax.random.PRNGKey(0), dataclasses.replace(
        jcfg, quant="none")), "w4a4_lut")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 8).tolist() for _ in budgets]
    got = {}
    for pkg, mod, cfg, params in (("j", jserve, jcfg, jp),
                                  ("t", tserve, tcfg, tp)):
        for layout in LAYOUTS:
            kw = dict(device="cpu") if pkg == "t" else {}
            eng = mod.make_engine(params, cfg, mod.ServeConfig(
                quant="w4a4_lut", max_len=MAX_LEN, **LAYOUTS[layout]), **kw)
            reqs = [mod.Request(prompt=p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            mod.Scheduler(eng, slots=4, chunk=8).run(reqs)
            got[pkg, layout] = [list(r.tokens) for r in reqs]
    for layout in LAYOUTS:
        assert got["t", layout] == got["j", layout]
    assert (got["j", "dense"] == got["j", "paged"]) == equal
