"""Port vs reference, serving the recurrent families on the CPU: rwkv6-1.6b
(RWKV6 time and channel mix, layer norms, no attention) and zamba2-2.7b
(Mamba2 layers, the shared attention + SwiGLU block before every second
layer) at their smoke configs, float32 compute, plain kernel versions.

* ``params_from_jax`` carries the shared block (one copy) and the 1-D
  per-layer leaves; ``init_served_params`` equals quantizing
  ``init_params``;
* ``forward``, ``prefill`` and ``decode_step`` (a free slot among the
  rows, the state updated in place) within 1e-5 of the reference's logits,
  float and ``w4a4_lut``;
* the Scheduler's transcripts and counters equal the reference's in
  ``w4a4_lut`` (greedy) on mixed prompt lengths: every
  admission monolithic, one dispatch per equal-length run at the exact
  length; each transcript equals the port's own ``generate`` of its
  prompt alone (the reference's ``tests/test_scheduler.py`` case);
* zamba2 paged (shared K/V in pages, mamba state dense per slot) == dense,
  greedy and sampled, also on a pool that preempts (a preempted request is
  admitted again by a prefill of its whole sequence);
* ``_stitch`` bitwise against the reference's ``_stitch_impl`` (state
  rows, shared K/V dense and through the page table), in place;
  ``_grow_cache`` pads only sequence leaves; KV bytes equal the
  reference's, recurrent state counted apart;
* the warm-up save set of ``graphs._capture``; the refusals (speculative
  decoding and the verify forward on recurrent and shared-attention
  patterns, an int8 KV cache with them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.configs import BlockSpec
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import transformer as TT
from repro_torch.serve import graphs
from repro_torch.serve.quantize import (init_served_params,
                                        quantize_params_for_serving)

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]
ATOL = 1e-5                   # float32 sums in other orders
MAX_LEN = 32
PS = 4
LENS = [6, 4, 9, 5, 7, 6, 12]     # prompts of 4 tokens or more
BUDGETS = [5, 6, 4, 3, 6, 7, 5]
SAMPLED = [(0.9, 0, 1.0), (1.0, 5, 1.0), (0.0, 0, 1.0), (0.8, 0, 0.9),
           (1.0, 8, 0.95), (None, None, None), (1.2, 0, 1.0)]
# the reference's model functions compiled once (the config is static)
J_FORWARD = jax.jit(JT.forward, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=1)
J_DECODE = jax.jit(JT.decode_step, static_argnums=1)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfg(mod, arch, quant="none", **over):
    return dataclasses.replace(mod.get_config(arch, smoke=True, quant=quant),
                               compute_dtype="float32", **over)


_P = {}


def _params(arch, quant="none"):
    """The reference's float32 smoke parameters (quantized by the
    reference for ``quant``) and the port's copy, made once."""
    if (arch, quant) not in _P:
        if quant == "none":
            jp = JT.init_params(jax.random.PRNGKey(0), _cfg(jconfigs, arch))
        else:
            jp = jquantize(_params(arch)[0], quant)
        _P[arch, quant] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _cfg(tconfigs, arch),
            device="cpu"))
    return _P[arch, quant]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_shared_block_and_vector_leaves(arch):
    jp, tp = _params(arch)
    cfg = _cfg(tconfigs, arch)
    assert len(tp["blocks"]) == cfg.n_layers
    P = len(cfg.pattern)
    for i, bp in enumerate(tp["blocks"]):
        g, j = divmod(i, P)
        flat = jax.tree_util.tree_leaves_with_path(jp["blocks"][j])
        for path, leaf in flat:
            node = bp
            for k in path:
                node = node[k.key]
            assert np.array_equal(_np(node), np.asarray(leaf[g]))
    if arch.startswith("zamba2"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                jp["shared_attn"]):
            node = tp["shared_attn"]
            for k in path:
                node = node[k.key]
            assert np.array_equal(_np(node), np.asarray(leaf))
        assert tp["blocks"][1]["mamba"]["A_log"].shape == (cfg.ssm_heads,)
    else:
        assert "shared_attn" not in tp
        assert tp["blocks"][1]["tmix"]["u"].shape == (cfg.rwkv_heads, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_served_params_equals_quantized_init(arch):
    cfg = tconfigs.get_config(arch, smoke=True, quant="w4a4_lut")
    got = init_served_params(cfg, "w4a4_lut", seed=0, device="cpu")
    want = quantize_params_for_serving(TT.init_params(cfg, 0, "cpu"),
                                       "w4a4_lut")
    gl, wl = (jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(_np, t)) for t in (got, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # every projection a code leaf: 8 a rwkv6 layer, 2 a mamba layer and 7
    # in the shared block
    n = sum(1 for p, _ in gl if str(p[-1]) == "['w_q']")
    assert n == (8 * 2 + 1 if arch.startswith("rwkv6") else 2 * 4 + 7 + 1)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, quant):
    """forward and prefill of 3 rows of 12 tokens; then 4 decode steps
    from the prefill's cache with row 1 free (negative position): its
    state changes as the reference's does, every cache leaf in place."""
    jp, tp = _params(arch, quant)
    jc, tc = _cfg(jconfigs, arch, quant), _cfg(tconfigs, arch, quant)
    toks = _tokens(3, 12)
    lw, _ = J_FORWARD(jp, jc, jnp.asarray(toks))
    lt, _ = TT.forward(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), np.asarray(lw), rtol=0, atol=ATOL)
    lw, jcache = J_PREFILL(jp, jc, jnp.asarray(toks))
    lt, tcache = TT.prefill(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), np.asarray(lw), rtol=0, atol=ATOL)
    jeng = jserve.make_engine(jp, jc, jserve.ServeConfig(max_len=MAX_LEN))
    teng = tserve.make_engine(tp, tc, tserve.ServeConfig(max_len=MAX_LEN),
                              device="cpu")
    jcache = jeng._grow_cache(jcache, 12)
    tcache = teng._grow_cache(tcache, 12)
    ptrs = [t.data_ptr() for c in tcache for t in c.values()]
    pos = np.array([12, -1, 12], np.int32)
    tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
    for step in range(4):
        lw, jcache = J_DECODE(jp, jc, jnp.asarray(tok), jcache,
                                  jnp.asarray(pos))
        lt, tcache = TT.decode_step(tp, tc, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lw), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    assert [t.data_ptr() for c in tcache for t in c.values()] == ptrs
    P = len(tc.pattern)
    for i, c in enumerate(tcache):
        g, j = divmod(i, P)
        for key in c.keys() & set(TT.STATE_KEYS):
            want = np.asarray(jcache[j][key][g])
            np.testing.assert_allclose(_np(c[key]), want, rtol=0,
                                       atol=ATOL * max(1, np.abs(want).max()))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _traffic(mod, sampled=False):
    rng = np.random.default_rng(3)
    knobs = SAMPLED if sampled else [(None, None, None)] * len(LENS)
    return [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b, temperature=t, top_k=k, top_p=p)
            for L, b, (t, k, p) in zip(LENS, BUDGETS, knobs)]


def _serve(pkg, arch, sampled=False, **scfg):
    """Seeded mixed-length traffic through a 3-slot Scheduler, staggered:
    two requests, one round, then the rest."""
    mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
    kw = dict(device="cpu") if pkg == "t" else {}
    sc = dict(quant="w4a4_lut", max_len=MAX_LEN, page_size=PS, **scfg)
    if sampled:
        sc.update(temperature=0.9, seed=7)
    eng = mod.make_engine(_params(arch)[0 if pkg == "j" else 1],
                          _cfg(cfgs, arch, "w4a4_lut"),
                          mod.ServeConfig(**sc), **kw)
    assert eng.has_recurrent_state and eng.requires_monolithic_admission
    sched = mod.Scheduler(eng, slots=3, chunk=2)
    reqs = _traffic(mod, sampled)
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return sched, [(r.finish_reason, list(r.tokens)) for r in reqs]


_RUNS = {}


def _run(pkg, arch, sampled=False, **scfg):
    key = (pkg, arch, sampled, tuple(sorted(scfg.items())))
    if key not in _RUNS:
        _RUNS[key] = _serve(pkg, arch, sampled, **scfg)
    return _RUNS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_transcripts_equal_reference(arch):
    jsched, want = _run("j", arch)
    tsched, got = _run("t", arch)
    assert got == want
    assert all(reason == "length" for reason, _ in got)
    for k in ("rounds", "admission_rounds", "prefill_tokens",
              "admitted_tokens", "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k
    # one admission dispatch per distinct run of equal lengths
    assert tsched.stats["admission_rounds"] == len(LENS)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_equals_generate_on_mixed_lengths(arch):
    """Each request's transcript equals the port's static ``generate`` of
    its prompt alone: the scheduler admits the mixed lengths unpadded."""
    _, got = _run("t", arch)
    eng = tserve.make_engine(_params(arch)[1], _cfg(tconfigs, arch,
                                                    "w4a4_lut"),
                             tserve.ServeConfig(quant="w4a4_lut",
                                                max_len=MAX_LEN),
                             device="cpu")
    for r, (_, toks) in zip(_traffic(tserve), got):
        out = eng.generate(torch.tensor([r.prompt]), r.max_new_tokens)
        assert _np(out[0, len(r.prompt):]).tolist() == toks


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_zamba2_paged_equals_dense(sampled):
    """Shared-attention K/V in pages of 4, mamba state dense per slot;
    greedy, and the sampled mix (whose draws depend on the round's
    draw counter: the same traffic in both runs)."""
    _, dense = _run("t", "zamba2-2.7b", sampled)
    tsched, paged = _run("t", "zamba2-2.7b", sampled, paged=True)
    assert paged == dense
    if sampled:
        assert paged != _run("t", "zamba2-2.7b")[1]
    pool = tsched.engine.pool
    assert pool.allocated_pages == 0 and not pool.leaked_pages()
    # the pools hold the shared K/V only; the state stays [slots, ...]
    for i, c in enumerate(tsched.cache):
        assert c["h"].shape[0] == 3
        if i % 2 == 0:
            assert c["shared_k"].shape[:2] == (pool.pages_per_shard, PS)
        else:
            assert "shared_k" not in c


def test_zamba2_preempted_request_resumes_by_full_prefill():
    """A pool of 9 pages for 3 slots: decode growth preempts, the victim
    goes back to the queue with its tokens and is admitted again by a
    prefill of its whole sequence; transcripts equal the dense run."""
    _, dense = _run("t", "zamba2-2.7b")
    prefills = []
    eng = tserve.make_engine(
        _params("zamba2-2.7b")[1], _cfg(tconfigs, "zamba2-2.7b", "w4a4_lut"),
        tserve.ServeConfig(quant="w4a4_lut", max_len=MAX_LEN, paged=True,
                           page_size=PS, num_pages=9), device="cpu")
    admit = eng.admit_monolithic

    def counted(cache, prompts, lengths, mask, *a, **k):
        prefills.extend(int(n) for n, m in zip(lengths, mask) if m)
        return admit(cache, prompts, lengths, mask, *a, **k)
    eng.admit_monolithic = counted
    sched = tserve.Scheduler(eng, slots=3, chunk=2)
    reqs = _traffic(tserve)
    sched.run(reqs)
    assert [(r.finish_reason, list(r.tokens)) for r in reqs] == dense
    assert sched.stats["preemptions"] > 0
    # a resumed request prefills past its prompt: prompt + tokens so far
    assert len(prefills) > len(LENS)
    assert max(prefills) > max(LENS)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_and_state_bytes(arch, paged):
    """KV bytes (the shared block's K/V) as the reference counts them;
    the recurrent state apart, exactly the bytes of its leaves."""
    sc = dict(max_len=MAX_LEN, paged=paged, page_size=PS)
    jeng = jserve.make_engine(_params(arch)[0], _cfg(jconfigs, arch),
                              jserve.ServeConfig(**sc))
    teng = tserve.make_engine(_params(arch)[1], _cfg(tconfigs, arch),
                              tserve.ServeConfig(**sc), device="cpu")
    cache = teng.init_cache(3)
    jeng.init_cache(3)
    assert teng.kv_cache_bytes(3) == jeng.kv_cache_bytes(3)
    state = sum(t.numel() * t.element_size() for c in cache
                for k, t in c.items() if k in TT.STATE_KEYS)
    assert TT.state_bytes(teng.cfg, 3) == state > 0
    if paged:
        assert teng.page_bytes(3) == jeng.page_bytes(3)


@pytest.mark.parametrize("arch", ARCHS)
def test_grow_cache_pads_only_sequence_leaves(arch):
    """A prefill's cache grown for decode has init_cache's leaves: shared
    K/V padded to max_len, recurrent state as it is."""
    _, tp = _params(arch)
    cfg = _cfg(tconfigs, arch)
    eng = tserve.make_engine(tp, cfg, tserve.ServeConfig(max_len=MAX_LEN),
                             device="cpu")
    _, pc = TT.prefill(tp, cfg, torch.from_numpy(_tokens(2, 6)))
    grown = eng._grow_cache(pc, 6)
    want = eng.init_cache(2)
    for g, w, p in zip(grown, want, pc):
        assert {k: (tuple(v.shape), v.dtype) for k, v in g.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in w.items()}
        for k in g.keys() & set(TT.STATE_KEYS):
            assert g[k] is p[k]


@pytest.mark.parametrize("paged", [False, True])
def test_stitch_matches_reference_in_place(paged):
    """zamba2: live caches of random contents, the prefill entries of 3
    rows of width 7 (rows 0 and 2 admitted, lengths 7 and 5) and, paged, a
    table of shuffled pages with row 0's first 4 tokens in a prefix-shared
    page: every leaf equals the reference's ``_stitch_impl``, written in
    place."""
    arch = "zamba2-2.7b"
    jp, tp = _params(arch)
    jcfg, tcfg = _cfg(jconfigs, arch), _cfg(tconfigs, arch)
    kw = dict(max_len=16, paged=paged, page_size=PS)
    je = jserve.Engine(jcfg, jp, jserve.ServeConfig(**kw))
    te = tserve.Engine(tcfg, tp, tserve.ServeConfig(**kw), device="cpu")
    rng = np.random.default_rng(0)
    B, P = 3, 7
    G, npat = tcfg.n_groups, len(tcfg.pattern)
    jcache = list(je.init_cache(B))
    tcache = te.init_cache(B)
    for j, jc in enumerate(jcache):
        jc = dict(jc)
        for key, leaf in jc.items():
            val = rng.standard_normal(leaf.shape).astype(np.float32)
            jc[key] = jnp.asarray(val)
            for g in range(G):
                tcache[g * npat + j][key].copy_(torch.from_numpy(val[g]))
        jcache[j] = jc
    jpart, tpart = [], [dict() for _ in range(tcfg.n_layers)]
    for j, jc in enumerate(jcache):
        part = {}
        for key, leaf in jc.items():
            shape = ((G, B, P) + leaf.shape[3:] if key.startswith("shared")
                     else leaf.shape)
            part[key] = rng.standard_normal(shape).astype(np.float32)
            for g in range(G):
                tpart[g * npat + j][key] = torch.from_numpy(part[key][g])
        jpart.append({k: jnp.asarray(v) for k, v in part.items()})
    lengths = np.array([7, 1, 5], np.int32)
    mask = np.array([True, False, True])
    jextra, textra = (), None
    if paged:
        E = 16 // PS
        table = rng.permutation(np.arange(1, B * E + 1)).reshape(B, E)
        table = table.astype(np.int32)
        start = np.array([4, 0, 0], np.int32)
        jextra = (jnp.asarray(table), jnp.zeros((B, 1), jnp.int32),
                  jnp.asarray(start))
        textra = (torch.from_numpy(table), None, torch.from_numpy(start))
    ptrs = [t.data_ptr() for c in tcache for t in c.values()]
    want = je._stitch_impl(tuple(jcache), tuple(jpart), jnp.asarray(lengths),
                           jnp.asarray(mask), jextra)
    got = te._stitch(tcache, tpart, torch.from_numpy(lengths),
                     torch.from_numpy(mask), textra)
    assert got is tcache
    assert [t.data_ptr() for c in got for t in c.values()] == ptrs
    for i, c in enumerate(got):
        g, j = divmod(i, npat)
        for key, leaf in c.items():
            lo = 1 if paged and key.startswith("shared") else 0  # null page
            np.testing.assert_array_equal(_np(leaf)[lo:],
                                          np.asarray(want[j][key][g])[lo:])


# ---------------------------------------------------------------------------
# graphs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,keys", [
    ("rwkv6-1.6b", {"S", "xt", "xc"}), ("zamba2-2.7b", {"h", "conv"}),
    ("gemma2-2b", None)])
def test_warmup_saves_every_recurrent_leaf(arch, keys):
    """The leaves ``graphs._capture`` copies before a key's warm-up round
    and puts back after it: every recurrent state leaf (overwritten whole
    each step), every leaf of a local layer (its ring), nothing of a
    full-length attention cache (the replay rewrites what the warm-up
    wrote)."""
    cfg = _cfg(tconfigs, arch)
    eng = tserve.Engine(cfg, TT.init_params(cfg, 0, "cpu"),
                        tserve.ServeConfig(max_len=MAX_LEN), device="cpu")
    cache = eng.init_cache(2)
    saved = {id(t) for t in graphs._warmup_leaves(eng, cache)}
    for i, c in enumerate(cache):
        local = TT.is_local(cfg, TT.layer_spec(cfg, i))
        for k, t in c.items():
            want = local if keys is None else k in keys
            assert (id(t) in saved) == want, (i, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_decode_and_verify_refuse_as_the_reference_does(arch):
    jerr = terr = None
    for mod, cfgs, kw in ((jserve, jconfigs, {}),
                          (tserve, tconfigs, dict(device="cpu"))):
        params = _params(arch)[0 if mod is jserve else 1]
        with pytest.raises(ValueError, match="recurrent layers") as err:
            mod.make_engine(params, _cfg(cfgs, arch, "w4a4_tmac"),
                            mod.ServeConfig(quant="w4a4_tmac",
                                            max_len=MAX_LEN,
                                            spec_decode=True), **kw)
        jerr, terr = (err, terr) if mod is jserve else (jerr, err)
    assert str(terr.value) == str(jerr.value)
    tc = _cfg(tconfigs, arch)
    cache = TT.init_cache(tc, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="speculative decoding supports"):
        TT.verify_step(_params(arch)[1], tc,
                       torch.zeros((2, 3), dtype=torch.int32), cache,
                       torch.zeros((2,), dtype=torch.int32))


def test_shared_attention_refusals():
    """An attention pattern with the shared block: no speculation (as the
    reference); an int8 KV cache beside recurrent or shared blocks is
    served, their leaves float."""
    base = tconfigs.get_config("qwen2-7b", smoke=True)
    cfg = dataclasses.replace(base, pattern=(BlockSpec(shared_attn=True),
                                             BlockSpec()))
    TT.check_supported(cfg)
    params = quantize_params_for_serving(TT.init_params(cfg, 0, "cpu"),
                                         "w4a4_tmac")
    with pytest.raises(ValueError, match="shared-attention"):
        tserve.make_engine(params, dataclasses.replace(cfg,
                                                       quant="w4a4_tmac"),
                           tserve.ServeConfig(max_len=MAX_LEN,
                                              spec_decode=True),
                           device="cpu")
    # an int8 KV cache beside them is served (their K/V and state stay
    # float, as the reference's): only the pattern's plain attention layer
    # holds int8 codes
    for arch in ARCHS + ["shared"]:
        c = cfg if arch == "shared" else tconfigs.get_config(arch,
                                                             smoke=True)
        c8 = dataclasses.replace(c, kv_quant="int8")
        TT.check_supported(c8)
        int8 = [("k_scale" in leaves, "shared_k" in leaves)
                for leaves in TT.init_cache(c8, 2, MAX_LEN, device="cpu")]
        if arch == "shared":
            assert int8 == [(True, True), (True, False)] * (
                c.n_layers // 2)
        else:
            assert not any(i for i, _ in int8)
