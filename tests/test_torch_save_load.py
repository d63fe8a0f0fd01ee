"""The port's crash recovery across processes: ``Scheduler.save`` /
``load`` through ``repro_torch.ckpt.checkpoint`` on qwen2-7b-smoke in
``w4a4_lut``, the plain kernel versions and float32 compute.

A Scheduler saved mid-stream and loaded into another one (on another
engine, or in a fresh process that never imports JAX) continues every
request token-identically to the uninterrupted run: dense, paged (also
against the reference's transcripts) and int8 KV, mid-way through chunked
prefill, and sampled (the draw counter survives).  The pool's allocator
round-trips exactly, a geometry or cache-layout mismatch raises, the shed
tie-break and the submit counter survive, and ``load`` writes in place:
every cache leaf, slot vector, sampling vector and the engine's device
page table keep their addresses (the captured round graphs on the card are
keyed on them).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops

from _torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MAX_LEN = 32
CONFIGS = {
    "dense": ("none", {}),
    "paged": ("none", dict(paged=True, page_size=4)),
    "int8": ("int8", {}),
    "paged-chunk4": ("none", dict(paged=True, page_size=4, prefill_chunk=4)),
    "sampled": ("none", dict(seed=7, temperature=0.7)),
}
KNOBS = [(0.9, 0, 1.0), (1.0, 40, 0.95), (0.0, 0, 1.0), (0.8, 5, 0.9)]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _cfgs(kv_quant):
    return [dataclasses.replace(
        mod.get_config("qwen2-7b", smoke=True, quant="w4a4_lut"),
        compute_dtype="float32", kv_quant=kv_quant)
        for mod in (jconfigs, tconfigs)]


_PARAMS = {}
_ENGINES = {}


def _params():
    if not _PARAMS:
        jcfg, tcfg = _cfgs("none")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS["j"] = jp
        _PARAMS["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       tcfg, device="cpu")
    return _PARAMS["j"], _PARAMS["t"]


def _engine(config: str, which: str = "a"):
    """Two port engines per configuration (``a`` saves, ``b`` loads: a
    different engine object with its own pool and table), built once."""
    key = (config, which)
    if key not in _ENGINES:
        kv_quant, extra = CONFIGS[config]
        _, tcfg = _cfgs(kv_quant)
        _ENGINES[key] = tserve.make_engine(
            _params()[1], tcfg, tserve.ServeConfig(
                quant="w4a4_lut", max_len=MAX_LEN, **extra), device="cpu")
    return _ENGINES[key]


def _reqs(n=4, S=5, budget=8, seed=1, sampled=False, mod=tserve):
    prompts = np.random.default_rng(seed).integers(0, 512, (n, S)).tolist()
    knobs = KNOBS if sampled else [(None, None, None)] * n
    return [mod.Request(prompt=p, max_new_tokens=budget, temperature=t,
                        top_k=k, top_p=q)
            for p, (t, k, q) in zip(prompts, knobs)]


def _drain(sched, max_rounds=64):
    rounds = 0
    while sched.has_work:
        sched.step()
        rounds += 1
        assert rounds <= max_rounds
    return sorted((r.finish_reason, list(r.tokens)) for r in sched.finished)


def _addresses(sched) -> list:
    """Every device tensor a round graph or the Scheduler holds by
    address."""
    vecs = (sched.tok, sched.pos, sched.done, sched.eos, sched.temperature,
            sched.top_k, sched.top_p)
    out = [t.data_ptr() for c in sched.cache for t in c.values()] + \
        [t.data_ptr() for t in vecs]
    if sched.engine.paged:
        out.append(sched.engine.table.data_ptr())
    return out


def _mid_prefill(sched):
    return any(r is not None and sched._progress[s] < sched._target[s]
               for s, r in enumerate(sched.slots))


def _uninterrupted(config, **kw):
    sched = tserve.Scheduler(_engine(config), slots=2, chunk=2)
    for r in _reqs(**kw):
        sched.submit(r)
    return _drain(sched)


def _save_and_load(tmp_path, config, steps=2, warm=True, **kw):
    """A serves ``steps`` rounds and saves; B, on the other engine, drains
    a warm run first (when ``warm``), then loads; returns B."""
    a = tserve.Scheduler(_engine(config), slots=2, chunk=2)
    for r in _reqs(**kw):
        a.submit(r)
    for _ in range(steps):
        a.step()
    assert a.has_work                   # genuinely mid-stream
    a.save(str(tmp_path))
    b = tserve.Scheduler(_engine(config, "b"), slots=2, chunk=2)
    if warm:
        b.run(_reqs(n=1, seed=9, **{k: v for k, v in kw.items()
                                    if k == "sampled"}))
    ptrs = _addresses(b)
    b.load(str(tmp_path))
    assert _addresses(b) == ptrs        # load writes in place
    return a, b


@pytest.mark.parametrize("config", ["dense", "paged", "int8"])
def test_save_load_continues_token_identically(tmp_path, config):
    want = _uninterrupted(config)
    _, b = _save_and_load(tmp_path, config)
    ptrs = _addresses(b)
    assert _drain(b) == want
    assert _addresses(b) == ptrs
    if config == "paged":
        # and the reference's paged Scheduler gives the same transcripts
        jcfg, _ = _cfgs("none")
        jeng = jserve.Engine(jcfg, _params()[0], jserve.ServeConfig(
            quant="w4a4_lut", max_len=MAX_LEN, **CONFIGS["paged"][1]))
        ref = jserve.Scheduler(jeng, slots=2, chunk=2)
        for r in _reqs(mod=jserve):
            ref.submit(r)
        assert _drain(ref) == want


def test_save_load_roundtrips_pool_allocator(tmp_path):
    """The allocator (tables, free lists, refcounts, prefix registry,
    stats) survives the disk round-trip exactly, into the engine's device
    table at the next round."""
    eng = _engine("paged")
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    for r in _reqs():
        sched.submit(r)
    sched.step()
    sched.step()
    state_a = eng.pool.state_dict()
    sched.save(str(tmp_path))
    eng2 = _engine("paged", "b")
    b = tserve.Scheduler(eng2, slots=2, chunk=2)
    b.load(str(tmp_path))
    assert eng2.pool.state_dict() == state_a
    assert eng2.pool.validate() == []
    b.step()
    np.testing.assert_array_equal(eng2.table.numpy(), eng2.pool.table)


def test_load_rejects_geometry_and_layout_mismatch(tmp_path):
    sched = tserve.Scheduler(_engine("dense"), slots=2, chunk=2)
    sched.submit(_reqs(n=1)[0])
    sched.step()
    sched.save(str(tmp_path / "bf16"))
    for kw in (dict(slots=4, chunk=2), dict(slots=2, chunk=4)):
        other = tserve.Scheduler(_engine("dense", "b"), **kw)
        with pytest.raises(ValueError, match="geometry"):
            other.load(str(tmp_path / "bf16"))
    with pytest.raises(ValueError, match="geometry"):
        tserve.Scheduler(_engine("paged", "b"), slots=2, chunk=2).load(
            str(tmp_path / "bf16"))
    # an int8 checkpoint into a bf16 engine: the checkpoint's own error
    s8 = tserve.Scheduler(_engine("int8"), slots=2, chunk=2)
    s8.submit(_reqs(n=1)[0])
    s8.step()
    s8.save(str(tmp_path / "int8"))
    bf16 = tserve.Scheduler(_engine("dense", "b"), slots=2, chunk=2)
    with pytest.raises(ValueError, match="structure mismatch"):
        bf16.load(str(tmp_path / "int8"))


def test_save_load_mid_prefill_chunk(tmp_path):
    """A save while a prompt is mid-way through chunked prefill carries
    the progress / target cursors, and the load continues exactly."""
    kw = dict(n=2, S=20, budget=6)
    want = _uninterrupted("paged-chunk4", **kw)
    a, b = _save_and_load(tmp_path, "paged-chunk4", steps=1, **kw)
    assert _mid_prefill(a) and _mid_prefill(b)
    assert (b._progress, b._target) == (a._progress, a._target)
    assert _drain(b) == want


def test_sampled_save_load_reproduces_the_draw_counter(tmp_path):
    want_sched = tserve.Scheduler(_engine("sampled"), slots=2, chunk=2)
    for r in _reqs(sampled=True):
        want_sched.submit(r)
    want = _drain(want_sched)
    a, b = _save_and_load(tmp_path, "sampled", steps=3, sampled=True)
    assert b._step == a._step > 0
    assert (b._temp_h, b._topk_h, b._topp_h) == \
        (a._temp_h, a._topk_h, a._topp_h)
    assert _drain(b) == want
    assert b._step == want_sched._step


def test_loaded_requests_are_new_objects_with_their_state(tmp_path):
    a = tserve.Scheduler(_engine("dense"), slots=2, chunk=2)
    reqs = _reqs(n=3)
    reqs[2].deadline, reqs[2].priority = 50.0, 3
    for r in reqs:
        a.submit(r, now=1.5)
    a.step(now=2.0)
    a.save(str(tmp_path), step=42)
    b = tserve.Scheduler(_engine("dense", "b"), slots=2, chunk=2)
    b.load(str(tmp_path), step=42)
    for old, new in zip([r for r in a.slots if r] + list(a.queue),
                        [r for r in b.slots if r] + list(b.queue)):
        assert new is not old and new.on_token is None
        for f in ("prompt", "tokens", "status", "slot", "deadline",
                  "priority", "arrival_time", "finish_time", "retries",
                  "_seq"):
            assert getattr(new, f) == getattr(old, f), f
    assert b.stats == a.stats and b._ticks == a._ticks == 1


def test_shed_tiebreak_survives_save_load(tmp_path):
    """The shed order's last tie-break is the submission sequence (latest
    first): a loaded Scheduler sheds the same set, and a new submission
    continues the restored counter."""
    def build(engine):
        sched = tserve.Scheduler(engine, slots=1, chunk=2,
                                 shed_watermark=1.0, overload_queue=2)
        keep = tserve.Request(prompt=[1, 2, 3], max_new_tokens=8)
        sched.submit(keep, now=0.0)
        sched.step(now=0.0)              # slot saturated
        # equal priority, no deadlines: only -_seq breaks the tie
        waiting = [tserve.Request(prompt=[10 + i, 2, 3], max_new_tokens=2)
                   for i in range(4)]
        for r in waiting:
            sched.submit(r, now=1.0)
        return sched, waiting

    ref, ref_wait = build(_engine("dense"))
    ref.step(now=1.0)
    assert [r.status.value for r in ref_wait] == ["queued", "queued",
                                                  "shed", "shed"]
    want_shed = {tuple(r.prompt) for r in ref_wait
                 if r.status.value == "shed"}

    a, _ = build(_engine("dense"))
    a.save(str(tmp_path))
    b = tserve.Scheduler(_engine("dense", "b"), slots=1, chunk=2,
                         shed_watermark=1.0, overload_queue=2)
    b.load(str(tmp_path))
    b.step(now=1.0)
    assert {tuple(r.prompt) for r in b.finished
            if r.finish_reason == "shed"} == want_shed
    late = tserve.Request(prompt=[99, 2, 3], max_new_tokens=2)
    b.submit(late, now=1.0)
    assert late._seq == b._submit_count == 6
    assert late._seq > max(r._seq for r in b.queue if r is not late)


def test_save_load_fresh_process_without_jax(tmp_path):
    """Save in one process, load in another: both import only the port
    (never JAX), and the loaded run continues token-identically (paged)."""
    common = textwrap.dedent("""
        import dataclasses, sys
        import numpy as np
        from repro_torch import configs, serve
        from repro_torch.kernels.lutmul import ops
        from repro_torch.models import transformer
        ops.set_backend("ref")
        cfg = dataclasses.replace(configs.get_config(
            "qwen2-7b", smoke=True, quant="w4a4_lut"),
            compute_dtype="float32")
        params = transformer.init_params(cfg, seed=0, device="cpu")
        scfg = serve.ServeConfig(quant="w4a4_lut", max_len=32, paged=True,
                                 page_size=4)
        eng = serve.make_engine(params, cfg, scfg, device="cpu")
        prompts = np.random.default_rng(1).integers(0, 512, (4, 5)).tolist()
        def reqs():
            return [serve.Request(prompt=p, max_new_tokens=8)
                    for p in prompts]
        def drain(s):
            while s.has_work:
                s.step()
            return sorted((r.finish_reason, tuple(r.tokens))
                          for r in s.finished)
    """)
    tail = 'print("JAX", "jax" in sys.modules or "repro" in sys.modules)\n'
    save_script = common + textwrap.dedent(f"""
        ref = serve.Scheduler(eng, slots=2, chunk=2)
        for r in reqs():
            ref.submit(r)
        print("WANT", drain(ref))
        s = serve.Scheduler(eng, slots=2, chunk=2)
        for r in reqs():
            s.submit(r)
        s.step(); s.step()
        assert s.has_work
        s.save({str(tmp_path)!r})
        print("SAVED_OK")
    """) + tail
    load_script = common + textwrap.dedent(f"""
        s = serve.Scheduler(eng, slots=2, chunk=2)
        s.load({str(tmp_path)!r})
        print("GOT", drain(s))
        print("LOADED_OK")
    """) + tail
    env = dict(os.environ, PYTHONPATH=SRC)
    out = []
    for script, ok in ((save_script, "SAVED_OK"), (load_script, "LOADED_OK")):
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0 and ok in p.stdout, p.stderr[-4000:]
        lines = p.stdout.splitlines()
        assert "JAX False" in lines, p.stdout[-2000:]
        out.append(lines)
    want = next(ln for ln in out[0] if ln.startswith("WANT"))
    got = next(ln for ln in out[1] if ln.startswith("GOT"))
    assert want.split(" ", 1)[1] == got.split(" ", 1)[1]
