"""The paper's analyses in the port against the reference: the LUT6_2 INIT
words (Fig. 5), the LUT multiply read back from them, the Eq. 3 cost model,
the analytic U280 model (``core.fpga_model``: Eq. 1-2, Table 2's folding),
``mobilenet.fpga_layer_table``, and ``roofline.analysis``'s counts and
mixed-width planner.

Everything here is plain Python on integers and floats, so the port must
give the reference's values bit for bit.  The planner is held against the
reference's plan of the same model's tree (``jax.eval_shape`` of its
``init_params``: every dict in sorted key order, as a tree out of any JAX
transformation) expanded over each stack's layers: the reference plans one
``[G, ...]`` stack a pattern position, the port one dict a layer.
"""
import dataclasses
import functools
import math

import jax
import pytest

from repro import configs as jconfigs
from repro.core import fpga_model as jfpga
from repro.core import lut as jlut
from repro.models import encdec as JE
from repro.models import mobilenet as JM
from repro.models import transformer as JT
from repro.roofline import analysis as janalysis
from repro_torch import configs as tconfigs
from repro_torch.core import fpga_model as tfpga
from repro_torch.core import lut as tlut
from repro_torch.models import encdec as TE
from repro_torch.models import mobilenet as TM
from repro_torch.models import transformer as TT
from repro_torch.roofline import analysis as tanalysis

from _torch_threads import one_torch_thread  # noqa: F401

INT4 = range(-8, 8)
PAPER_LUT_BUDGET = 529_242       # the paper's LUTs for MobileNetV2
PAPER_OVERHEAD = 3.24
PAPER_PREFIX = 15


# ---------------------------------------------------------------------------
# the LUT6_2 words and the Eq. 3 cost model
# ---------------------------------------------------------------------------

def test_lut6_init_words_every_int4_pair():
    for w0 in INT4:
        for w1 in INT4:
            got = tlut.lut6_2_init_words(w0, w1)
            assert got == jlut.lut6_2_init_words(w0, w1), (w0, w1)
            assert all(isinstance(w, int) and 0 <= w < 2 ** 64 for w in got)
    with pytest.raises(ValueError, match="4-bit activations"):
        tlut.lut6_2_init_words(1, 2, act_bits=3)


def test_multiply_via_lut6_every_input():
    """Every (w0, w1, ws, a) read back from the bank equals the
    reference's reading and the product itself."""
    for w0 in INT4:
        for w1 in INT4:
            for ws, w in ((0, w0), (1, w1)):
                for a in range(16):
                    got = tlut.multiply_via_lut6(w0, w1, ws, a)
                    assert got == w * a, (w0, w1, ws, a)
                    assert got == jlut.multiply_via_lut6(w0, w1, ws, a)


def test_paper_fig5_constants():
    assert tlut.PAPER_FIG5_INIT_WORDS == jlut.PAPER_FIG5_INIT_WORDS
    assert tuple(tlut.lut6_2_init_words(1, -3)) == tlut.PAPER_FIG5_INIT_WORDS
    for init in tlut.PAPER_FIG5_INIT_WORDS:
        for i4 in (0, 1):
            for a in range(16):
                assert tlut.lut6_read(init, 1, i4, a) == \
                    jlut.lut6_read(init, 1, i4, a)
                assert tlut.lut6_read(init, 0, i4, a) == \
                    jlut.lut6_read(init, 0, i4, a)
    for w, a in ((5, 9), (-8, 15), (7, 0)):
        assert tlut._int_product(w, a) == jlut._int_product(w, a)
        assert tlut._int_product(w, a, 16) == jlut._int_product(w, a, 16)


@pytest.mark.parametrize("n", range(1, 9))
def test_luts_per_multiply(n):
    assert tlut.luts_per_multiply(n) == jlut.luts_per_multiply(n)
    assert tlut.luts_per_multiply_general(n) == \
        jlut.luts_per_multiply_general(n)
    if n == 4:            # the paper: 2 LUT6 a 4-bit multiply, 13-28 general
        assert tlut.luts_per_multiply(4) == 2.0
        assert tlut.luts_per_multiply_general(4) == (13, 28)


def test_flat_product_table():
    for kw in ({}, {"a_signed": True}, {"w_signed": False}):
        assert (tlut.flat_product_table(**kw)
                == jlut.flat_product_table(**kw)).all()


# ---------------------------------------------------------------------------
# the analytic FPGA model
# ---------------------------------------------------------------------------

def test_fpga_specs_and_peaks():
    assert dataclasses.asdict(tfpga.U280) == dataclasses.asdict(jfpga.U280)
    assert tfpga.V100_PEAK_FP16_TENSOR == jfpga.V100_PEAK_FP16_TENSOR
    assert tfpga.V100_HBM_BW == jfpga.V100_HBM_BW
    spec_t, spec_j = tfpga.U280, jfpga.U280
    for bits in range(1, 17):
        assert tfpga.dsp_packing_factor(bits) == \
            jfpga.dsp_packing_factor(bits)
        for frac in (1.0, 0.5, 0.37):
            assert tfpga.dsp_peak_ops(spec_t, bits, frac) == \
                jfpga.dsp_peak_ops(spec_j, bits, frac)
            for ovh in (1.0, 2.0, PAPER_OVERHEAD):
                assert tfpga.lutmul_peak_ops(spec_t, bits, frac, ovh) == \
                    jfpga.lutmul_peak_ops(spec_j, bits, frac, ovh)
    for bw, ctc in ((460e9, 3.5), (38e9, 100.0)):
        assert tfpga.memory_bound_ops(bw, ctc) == \
            jfpga.memory_bound_ops(bw, ctc)
    # the survey's claim: LUTs raise the roofline above the DSPs'
    assert tfpga.lutmul_peak_ops(spec_t, 4, lut_overhead=2.0) > \
        tfpga.dsp_peak_ops(spec_t, 4)


@pytest.mark.parametrize("bits,frac,ovh", [(4, 1.0, 2.0), (8, 0.5, 1.0),
                                           (4, 0.8, PAPER_OVERHEAD)])
def test_roofline(bits, frac, ovh):
    got = tfpga.roofline(tfpga.U280, bits, frac, ovh)
    want = jfpga.roofline(jfpga.U280, bits, frac, ovh)
    assert set(got) == set(want)
    for k, v in want.items():
        if callable(v):
            for i in (0.01, 1.0, 7.5, 100.0, 1e4):
                assert got[k](i) == v(i), (k, i)
        else:
            assert got[k] == v, k


def _layers(width):
    cfg_t = TM.MobileNetConfig(width=width)
    cfg_j = JM.MobileNetConfig(width=width)
    return TM.fpga_layer_table(cfg_t), JM.fpga_layer_table(cfg_j)


@pytest.mark.parametrize("width,resolution", [(1.0, 224), (0.25, 32)])
def test_fpga_layer_table(width, resolution):
    got = TM.fpga_layer_table(TM.MobileNetConfig(width=width,
                                                 resolution=resolution))
    want = JM.fpga_layer_table(JM.MobileNetConfig(width=width,
                                                  resolution=resolution))
    assert len(got) == len(want) == 52
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.mults, g.macs, g.ops) == (w.mults, w.macs, w.ops)
        for fold in (1, 3, 64):
            assert tfpga.layer_cycles(g, fold) == jfpga.layer_cycles(w, fold)
            for ovh in (2.0, PAPER_OVERHEAD):
                assert tfpga.layer_luts(g, fold, ovh) == \
                    jfpga.layer_luts(w, fold, ovh)
    assert [x.bits for x in got] == [8] + [4] * 50 + [8]


def test_balance_folding_at_the_papers_budget():
    """The Table 2 operating point, bitwise: folds, LUTs and fps."""
    got_l, want_l = _layers(1.0)
    args = (PAPER_LUT_BUDGET, tfpga.U280.freq_hz, PAPER_OVERHEAD)
    got = tfpga.balance_folding(got_l, *args,
                                full_parallel_prefix=PAPER_PREFIX)
    want = jfpga.balance_folding(want_l, *args,
                                 full_parallel_prefix=PAPER_PREFIX)
    assert got == want
    assert got["total_luts"] <= PAPER_LUT_BUDGET
    assert tfpga.pipeline_fps(got_l, got["folds"], tfpga.U280.freq_hz) == \
        got["fps"]
    # and the model's default overhead, no unfolded prefix
    got = tfpga.balance_folding(got_l, 1_000_000, 300e6)
    assert got == jfpga.balance_folding(want_l, 1_000_000, 300e6)
    with pytest.raises(ValueError, match="too small"):
        tfpga.balance_folding(got_l, 10.0, 300e6)


# ---------------------------------------------------------------------------
# counts and the mixed-width planner
# ---------------------------------------------------------------------------

PLAN_ARCHS = ["qwen2-7b", "bitnet-3b", "gemma2-2b", "qwen2-moe-a2.7b",
              "rwkv6-1.6b", "zamba2-2.7b", "whisper-large-v3"]
TARGETS = [4.0, 3.2, 3.0, 2.5, 2.0, 1.8, 1.0]


@functools.lru_cache(maxsize=None)
def _trees(arch: str, smoke: bool = True):
    """(port cfg, port shape tree on the meta device, reference cfg,
    reference shape tree)."""
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    jmod, tmod = (JE, TE) if jcfg.enc_dec else (JT, TT)
    jtree = jax.eval_shape(lambda: jmod.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return tcfg, tmod.init_params(tcfg, 0, device="meta"), jcfg, jtree


def _expand(plan: dict, tcfg, tree: dict) -> dict:
    """The reference's plan with each stack's path given to every layer of
    the stack: ``['blocks'][j]`` to layers j, j + P, ...; ``['enc_blocks']``
    and ``['dec_blocks']`` to each of their layers."""
    out = {}
    P = len(tcfg.pattern)
    for path, mode in plan.items():
        if path.startswith("['blocks']["):
            j, rest = path[len("['blocks']["):].split("]", 1)
            for i in range(int(j), len(tree["blocks"]), P):
                out[f"['blocks'][{i}]{rest}"] = mode
        elif path.startswith(("['enc_blocks']", "['dec_blocks']")):
            stack, rest = path[2:].split("']", 1)
            for i in range(len(tree[stack])):
                out[f"['{stack}'][{i}]{rest}"] = mode
        else:
            out[path] = mode
    return out


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_count_params_and_model_flops(arch):
    tcfg, ttree, jcfg, jtree = _trees(arch)
    kw = {}
    if jcfg.moe is not None:
        kw = dict(moe_top_k=jcfg.moe.top_k, n_experts=jcfg.moe.n_experts)
    got = tanalysis.count_params(ttree, **kw)
    want = janalysis.count_params(jtree, **kw)
    assert got == want
    if kw:
        assert got["active"] < got["total"]
    for kind in ("train", "prefill", "decode"):
        assert tanalysis.model_flops(kind, got["active"], 8, 512) == \
            janalysis.model_flops(kind, want["active"], 8, 512)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_mixed_bits_matches_reference(arch, target):
    tcfg, ttree, _, jtree = _trees(arch)
    want = _expand(janalysis.plan_mixed_bits(jtree, target), tcfg, ttree)
    got = tanalysis.plan_mixed_bits(ttree, target, tcfg)
    assert want, arch
    assert got == want
    if target == 4.0:
        assert set(got.values()) == {"w4a4_tmac"}


FULL_PLANS = {   # qwen2-7b at full width: wq/wk/wv/wo stay w4 at each target
    3.2: {"wg": "w2a4_tmac", "wi": "w3a4_tmac", "wo": "w4a4_tmac"},
    2.0: {"wg": "w1a4_tmac", "wi": "w2a4_tmac", "wo": "w2a4_tmac"},
}


@pytest.mark.parametrize("target", sorted(FULL_PLANS))
def test_plan_full_width_qwen2_7b(target):
    tcfg, ttree, _, jtree = _trees("qwen2-7b", smoke=False)
    assert tanalysis.count_params(ttree)["total"] == 7_615_616_512
    got = tanalysis.plan_mixed_bits(ttree, target, tcfg)
    assert got == _expand(janalysis.plan_mixed_bits(jtree, target), tcfg,
                          ttree)
    assert len(got) == 7 * tcfg.n_layers
    for i in range(tcfg.n_layers):
        for leaf in ("wq", "wk", "wv", "wo"):
            assert got[f"['blocks'][{i}]['attn']['{leaf}']['w']"] == \
                "w4a4_tmac"
        for leaf, mode in FULL_PLANS[target].items():
            assert got[f"['blocks'][{i}]['mlp']['{leaf}']['w']"] == mode


def test_insertion_order_walk_breaks_ties_the_other_way():
    """wi and wg have equal shapes: the greedy demotes the first of equal
    savings, so the reference's own walk over the port's stacks in their
    insertion order (wi before wg) puts w1 on wi, where over its sorted
    tree (wg before wi) it puts it on wg, as the port's planner does."""
    tcfg, ttree, _, jtree = _trees("qwen2-7b", smoke=False)
    assert list(ttree["blocks"][0]["mlp"]) == ["wi", "wg", "wo"]
    ref = janalysis.plan_mixed_bits(jtree, 2.0)
    assert ref["['blocks'][0]['mlp']['wg']['w']"] == "w1a4_tmac"
    assert ref["['blocks'][0]['mlp']['wi']['w']"] == "w2a4_tmac"
    unsorted = janalysis.plan_mixed_bits(
        tanalysis._reference_view(ttree, tcfg), 2.0)
    assert unsorted["['blocks'][0]['mlp']['wi']['w']"] == "w1a4_tmac"
    assert unsorted["['blocks'][0]['mlp']['wg']['w']"] == "w2a4_tmac"
    port = tanalysis.plan_mixed_bits(ttree, 2.0, tcfg)
    assert port["['blocks'][0]['mlp']['wg']['w']"] == "w1a4_tmac"
    assert _expand(unsorted, tcfg, ttree) != port


def test_plan_reads_shapes_only_and_averages_to_target():
    """A meta tree (no values) plans; the parameter-weighted mean width of
    a plan is at or under its target, the attention floor held."""
    tcfg, ttree, _, _ = _trees("bitnet-3b")
    plan = tanalysis.plan_mixed_bits(ttree, 2.0, tcfg)
    sizes = {}
    for i, blk in enumerate(ttree["blocks"]):
        for grp, leaves in blk.items():
            for name, leaf in leaves.items():
                path = f"['blocks'][{i}]['{grp}']['{name}']['w']"
                if path in plan:
                    sizes[path] = math.prod(leaf["w"].shape)
    assert set(sizes) == set(plan)

    def bits(mode):
        return 1.58 if mode.startswith("ternary") else float(mode[1])
    mean = sum(sizes[p] * bits(m) for p, m in plan.items()) / sum(
        sizes.values())
    assert mean <= 2.0 + 1e-9
    assert all(bits(m) >= 2.0 for p, m in plan.items() if "['attn']" in p)
    assert tanalysis.plan_mixed_bits({"embed": ttree["embed"]}, 2.0,
                                     tcfg) == {}
