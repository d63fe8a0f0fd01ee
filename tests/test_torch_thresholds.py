"""Port vs reference: the multi-threshold unit (``core/thresholds``), its
kernel's dispatch (``kernels/thresholds``) and the streamlined integer
stage (``core/streamline``).

Thresholds, signs and codes are integers or integer-valued floats and are
held exactly.  The reference's threshold kernel runs in Pallas interpret
mode; the port's wrappers take their plain versions on CPU tensors (the
CUDA kernel itself is held to the same plain version on the card, in
``tests/test_torch_cuda_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streamline as jst
from repro.core import thresholds as jth
from repro.core.lut import pack_int4 as jpack_int4
from repro.core.quantization import A4 as JA4
from repro.kernels.thresholds import ops as jops
from repro.kernels.thresholds import ref as jref
from repro_torch.core import streamline as tst
from repro_torch.core import thresholds as tth
from repro_torch.core.lut import pack_int4
from repro_torch.core.quantization import A4
from repro_torch.kernels.lutmul import ops as lops
from repro_torch.kernels.thresholds import kernel, ops, ref

from _torch_threads import one_torch_thread  # noqa: F401


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _bn(rng, C, slope):
    lo, hi = {"pos": (0.2, 2.0), "neg": (-2.0, -0.2),
              "mixed": (-2.0, 2.0)}[slope]
    return dict(gamma=rng.uniform(lo, hi, C).astype(np.float32),
                beta=(rng.standard_normal(C) * 0.3).astype(np.float32),
                mean=(rng.standard_normal(C) * 0.2).astype(np.float32),
                var=rng.uniform(0.5, 1.5, C).astype(np.float32))


def _both_bn(p):
    return (jth.BNParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            tth.BNParams(**{k: torch.from_numpy(v) for k, v in p.items()}))


@pytest.mark.parametrize("slope", ["pos", "neg", "mixed", "none"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_and_apply_thresholds_match_reference(slope, seed):
    rng = np.random.default_rng(seed)
    C = 24
    acc_scale = rng.uniform(0.005, 0.05, C).astype(np.float32)
    out_scale = rng.uniform(0.05, 0.3, C).astype(np.float32)
    if slope == "none":
        jbn = tbn = None
    else:
        jbn, tbn = _both_bn(_bn(rng, C, slope))
    jt, js = jth.make_thresholds(jnp.asarray(acc_scale), jbn, JA4,
                                 jnp.asarray(out_scale))
    tt, ts = tth.make_thresholds(torch.from_numpy(acc_scale), tbn, A4,
                                 torch.from_numpy(out_scale))
    _eq(tt, jt)
    _eq(ts, js)
    assert tt.dtype == torch.float32 and tt.shape == (C, 15)
    acc = rng.integers(-2000, 2000, (40, C)).astype(np.int32)
    _eq(tth.apply_thresholds(torch.from_numpy(acc), tt, ts, A4),
        jth.apply_thresholds(jnp.asarray(acc), jt, js, JA4))
    want = jth.float_reference(jnp.asarray(acc), jnp.asarray(acc_scale), jbn,
                               JA4, jnp.asarray(out_scale))
    got = tth.float_reference(torch.from_numpy(acc),
                              torch.from_numpy(acc_scale), tbn, A4,
                              torch.from_numpy(out_scale))
    _eq(got, want)
    # the streamlining property itself, in the port
    _eq(tth.apply_thresholds(torch.from_numpy(acc), tt, ts, A4), want)


def test_sign_of_zero_and_nan_slopes_matches_jnp_sign():
    """A zero BN slope gives sign 0 and NaN thresholds (inf * 0); a NaN
    slope keeps NaN (``torch.sign`` alone would give 0)."""
    acc_scale = np.full(4, 0.02, np.float32)
    out_scale = np.full(4, 0.4, np.float32)
    p = dict(gamma=np.array([0.0, -0.0, np.nan, 1.0], np.float32),
             beta=np.array([0.1, 0.0, 0.0, 0.0], np.float32),
             mean=np.zeros(4, np.float32), var=np.ones(4, np.float32))
    jbn, tbn = _both_bn(p)
    jt, js = jth.make_thresholds(jnp.asarray(acc_scale), jbn, JA4,
                                 jnp.asarray(out_scale))
    tt, ts = tth.make_thresholds(torch.from_numpy(acc_scale), tbn, A4,
                                 torch.from_numpy(out_scale))
    _eq(tt, jt)
    _eq(ts, js)
    assert np.isnan(ts.numpy()[2]) and np.isnan(tt.numpy()[0]).all()


def _threshold_inputs(M, N, seed, sort=False):
    rng = np.random.default_rng(M + N + seed)
    acc = rng.integers(-500, 500, (M, N)).astype(np.int32)
    thr = rng.normal(0, 100, (N, 15)).astype(np.float32)
    if sort:
        thr = np.sort(thr, axis=1)
    sign = rng.choice([-1.0, 1.0], N).astype(np.float32)
    return acc, thr, sign


@pytest.mark.parametrize("M,N", [(8, 8), (100, 24), (256, 128), (33, 7)])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_threshold_matches_reference_interpret(M, N, backend):
    """Unsorted rows, signs +-1: the port (plain, and the kernel wrapper
    on CPU tensors) equals the reference's Pallas kernel in interpret
    mode."""
    acc, thr, sign = _threshold_inputs(M, N, seed=0)
    want = jops.threshold(jnp.asarray(acc), jnp.asarray(thr),
                          jnp.asarray(sign), backend="interpret")
    got = ops.threshold(torch.from_numpy(acc), torch.from_numpy(thr),
                        torch.from_numpy(sign), backend=backend)
    assert got.dtype == torch.int32
    _eq(got, want)
    _eq(ref.threshold_ref(torch.from_numpy(acc), torch.from_numpy(thr),
                          torch.from_numpy(sign)),
        jref.threshold_ref(jnp.asarray(acc), jnp.asarray(thr),
                           jnp.asarray(sign)))


def test_threshold_special_values_match_reference():
    """+inf (the reference's padding) never counts, -inf always, NaN
    never; |acc| above 2^24 rounds to nearest even in float32 first."""
    acc, thr, sign = _threshold_inputs(16, 9, seed=3)
    thr[0, :4] = np.inf
    thr[1, 2:5] = -np.inf
    thr[2, 7] = np.nan
    acc[:, 3] = np.array([2 ** 24 + 1, -(2 ** 24) - 3, 2 ** 31 - 1,
                          -(2 ** 31)] * 4, np.int32)
    thr[3] = np.float32(2 ** 24) + np.arange(-7, 8, dtype=np.float32) * 2
    want = jref.threshold_ref(jnp.asarray(acc), jnp.asarray(thr),
                              jnp.asarray(sign))
    got = kernel.threshold(torch.from_numpy(acc), torch.from_numpy(thr),
                           torch.from_numpy(sign))
    _eq(got, want)


# The CUDA kernel counts every level of a row in registers for L <= 16
# and in shared memory above; the plain version it is held to on the card
# must agree with the reference on every kind of row either way.
KINDS = ["sorted", "sorted_inf", "unsorted", "nan_thr", "nan_sign", "mixed"]
LEVELS = [0, 1, 3, 7, 15, 16, 17, 255]


def _level_inputs(M, N, L, kind, seed):
    """Rows ascending (as ``make_thresholds`` gives them), with -inf/+inf
    ends, unsorted, with NaN thresholds, or sorted and unsorted columns in
    one call; signs +-1, 0 and -0 (and NaN for ``nan_sign``); |acc| past
    2^24 against thresholds 2 apart there, where the conversion rounds."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-3000, 3000, (M, N)).astype(np.int32)
    acc[::3, ::2] = rng.integers(-(2 ** 31), 2 ** 31 - 1,
                                 acc[::3, ::2].shape)
    thr = rng.normal(0, 1500, (N, L)).astype(np.float32)
    if kind != "unsorted" and kind != "nan_thr":
        thr = np.sort(thr, axis=1)
    if kind == "sorted_inf" and L > 2:
        thr[::3, 0] = -np.inf
        thr[1::3, -1] = np.inf
    if kind == "nan_thr" and L:
        thr[2::5, L // 2] = np.nan
    if kind == "mixed" and L > 1:
        thr[N // 2::3] = thr[N // 2::3, ::-1]
    if L:
        thr[3::7] = np.float32(2 ** 24) + 2 * np.arange(L, dtype=np.float32)
        acc[:, 3::7] = 2 ** 24 + 1 + 2 * rng.integers(
            0, L, (M, len(range(3, N, 7))))
    sign = rng.choice([-1.0, 1.0], N).astype(np.float32)
    sign[5::9] = 0.0
    sign[7::9] = -0.0
    if kind == "nan_sign":
        sign[1::4] = np.nan
    return acc, thr, sign


@pytest.mark.parametrize("L", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_threshold_levels_match_reference(L, kind):
    """Every kind of row at L across the kernel's register/shared-memory
    boundary: the port equals the reference's plain version exactly."""
    acc, thr, sign = _level_inputs(37, 30, L, kind, seed=L * 11 + len(kind))
    want = jref.threshold_ref(jnp.asarray(acc), jnp.asarray(thr),
                              jnp.asarray(sign))
    got = kernel.threshold(torch.from_numpy(acc), torch.from_numpy(thr),
                           torch.from_numpy(sign))
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("L,kind", [(1, "sorted"), (3, "sorted_inf"),
                                    (7, "unsorted"), (15, "sorted"),
                                    (15, "nan_sign"), (15, "mixed"),
                                    (16, "nan_thr"), (16, "sorted_inf"),
                                    (17, "mixed"), (255, "unsorted")])
def test_threshold_levels_match_reference_interpret(L, kind):
    """The same inputs through the reference's Pallas kernel in interpret
    mode."""
    acc, thr, sign = _level_inputs(19, 12, L, kind, seed=L + 3)
    want = jops.threshold(jnp.asarray(acc), jnp.asarray(thr),
                          jnp.asarray(sign), backend="interpret")
    _eq(ops.threshold(torch.from_numpy(acc), torch.from_numpy(thr),
                      torch.from_numpy(sign)), want)


def test_lutmul_threshold_stage_matches_reference_interpret():
    rng = np.random.default_rng(2)
    M, K, N = 16, 32, 8
    a = rng.integers(0, 16, (M, K)).astype(np.uint8)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    thr = rng.normal(0, 200, (N, 15)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], N).astype(np.float32)
    wj = jpack_int4(jnp.asarray(w).T).T
    want = jops.lutmul_threshold_stage(jnp.asarray(a), wj, jnp.asarray(thr),
                                       jnp.asarray(sign), backend="interpret")
    wt = pack_int4(torch.from_numpy(w).T).T.contiguous()
    for backend in ("ref", "cuda"):
        got = ops.lutmul_threshold_stage(
            torch.from_numpy(a), wt, torch.from_numpy(thr),
            torch.from_numpy(sign), backend=backend)
        _eq(got, want)
    acc = a.astype(np.int32) @ w.astype(np.int32)
    np.testing.assert_array_equal(
        got.numpy(), np.sum(acc[:, :, None] * sign[None, :, None]
                            >= thr[None], axis=-1))


def _stage_inputs(seed, K=16, N=8, M=12):
    """The reference test's distribution (tests/test_streamline.py), made
    with numpy so both packages see the same numbers."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.5).astype(np.float32)
    bn = dict(gamma=rng.uniform(0.2, 2.0, N).astype(np.float32),
              beta=(rng.standard_normal(N) * 0.3).astype(np.float32),
              mean=(rng.standard_normal(N) * 0.2).astype(np.float32),
              var=rng.uniform(0.5, 1.5, N).astype(np.float32))
    a = rng.integers(0, 16, (M, K)).astype(np.int32)
    return w, bn, a


@pytest.mark.parametrize("seed", range(6))
def test_streamline_stage_matches_reference(seed):
    w, bn, a = _stage_inputs(seed, K=32, N=16, M=20)
    jbn, tbn = _both_bn(bn)
    js = jst.streamline_stage(jnp.asarray(w), jbn, jnp.float32(0.1))
    ts = tst.streamline_stage(torch.from_numpy(w), tbn, torch.tensor(0.1))
    for field in ("w_codes", "thresholds", "sign", "act_scale_out",
                  "relu6_cap_code"):
        _eq(getattr(ts, field), getattr(js, field))
        assert getattr(ts, field).numpy().dtype == \
            np.asarray(getattr(js, field)).dtype, field
    want = jst.integer_stage_forward(js, jnp.asarray(a), backend="ref")
    for backend in ("ref", "cuda"):
        _eq(tst.integer_stage_forward(ts, torch.from_numpy(a),
                                      backend=backend), want)
    _eq(tst.float_stage_reference(torch.from_numpy(w), tbn,
                                  torch.tensor(0.1), torch.from_numpy(a)),
        jst.float_stage_reference(jnp.asarray(w), jbn, jnp.float32(0.1),
                                  jnp.asarray(a)))


def test_integer_stage_matches_float_reference_over_seeds():
    """The reference's exact property (tests/test_streamline.py), in the
    port: integer codes == float codes, code for code, over many seeds."""
    for seed in range(40):
        w, bn, a = _stage_inputs(seed)
        tbn = tth.BNParams(**{k: torch.from_numpy(v) for k, v in bn.items()})
        stage = tst.streamline_stage(torch.from_numpy(w), tbn, 0.1)
        got = tst.integer_stage_forward(stage, torch.from_numpy(a))
        want = tst.float_stage_reference(torch.from_numpy(w), tbn, 0.1,
                                         torch.from_numpy(a))
        assert torch.equal(got, want), seed
        assert int(got.min()) >= 0 and int(got.max()) <= 15


def test_integer_stage_through_reference_interpret():
    """The reference's own interpret-mode stage (its Pallas LUT kernel)
    equals the port's on the same weights and codes."""
    key = jax.random.PRNGKey(7)
    ks = jax.random.split(key, 2)
    K, N, M = 32, 16, 8
    w = np.array(jax.random.normal(ks[0], (K, N)) * 0.3)
    a = np.array(jax.random.randint(ks[1], (M, K), 0, 16))
    ones, zeros = np.ones(N, np.float32), np.zeros(N, np.float32)
    jbn, tbn = _both_bn(dict(gamma=ones, beta=zeros, mean=zeros, var=ones))
    js = jst.streamline_stage(jnp.asarray(w), jbn, jnp.float32(0.05))
    want = jst.integer_stage_forward(js, jnp.asarray(a), backend="interpret")
    ts = tst.streamline_stage(torch.from_numpy(w), tbn, 0.05)
    lops.set_backend("cuda")
    try:
        got = tst.integer_stage_forward(ts, torch.from_numpy(a))
    finally:
        lops.set_backend(None)
    _eq(got, want)
