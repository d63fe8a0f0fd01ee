"""Port vs reference, the dense families of this slice: the port's
gemma2-2b, phi3-medium-14b and minicpm-2b configs (full and smoke) equal
the reference's field for field, and the Scheduler's transcripts on the
phi3 and minicpm smoke configs equal the reference's in ``w4a4_lut`` and
``w4a4_tmac`` (plain kernel versions, float32 compute, each package
quantizing the same float tree itself), exactly, with the same round
counts; minicpm's tied head and odd vocabulary (122,753 full) included.
"""
import dataclasses

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

ARCHS = ["gemma2-2b", "phi3-medium-14b", "minicpm-2b"]
LENS = [6, 3, 9, 1, 7]
BUDGETS = [5, 6, 4, 3, 6]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch, smoke):
    for quant in ("none", "w4a4_lut"):
        j = jconfigs.get_config(arch, smoke=smoke, quant=quant)
        t = tconfigs.get_config(arch, smoke=smoke, quant=quant)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert td == jd
        assert t.n_groups == j.n_groups


def test_aliases_and_module_constants():
    for arch in ARCHS:
        assert tconfigs.ALIASES[arch] == jconfigs.ALIASES[arch]
    from repro.configs import minicpm_2b as jm
    from repro_torch.configs import minicpm_2b as tm
    assert tm.TRAIN_SCHEDULE == jm.TRAIN_SCHEDULE == "wsd"


_P = {}


def _params(arch):
    if arch not in _P:
        cfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                                  compute_dtype="float32")
        jp = JT.init_params(jax.random.PRNGKey(0), cfg)
        tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                                   compute_dtype="float32")
        _P[arch] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu"))
    return _P[arch]


def _run(pkg, arch, quant):
    mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
    cfg = dataclasses.replace(cfgs.get_config(arch, smoke=True, quant=quant),
                              compute_dtype="float32")
    params = _params(arch)[0 if pkg == "j" else 1]
    kw = dict(device="cpu") if pkg == "t" else {}
    eng = mod.make_engine(params, cfg, mod.ServeConfig(
        quant=quant, max_len=32), **kw)
    sched = mod.Scheduler(eng, slots=3, chunk=2)
    rng = np.random.default_rng(3)
    reqs = [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return sched, [(r.finish_reason, list(r.tokens)) for r in reqs]


@pytest.mark.parametrize("quant", ["w4a4_lut", "w4a4_tmac"])
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm-2b"])
def test_scheduler_transcripts_equal_reference(arch, quant):
    jsched, want = _run("j", arch, quant)
    tsched, got = _run("t", arch, quant)
    assert got == want
    for k in ("rounds", "admission_rounds", "admitted_tokens",
              "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k
