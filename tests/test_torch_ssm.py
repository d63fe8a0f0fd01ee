"""Port vs reference, the recurrent blocks of ``models/ssm.py`` and the
layer norm on the CPU: ``softplus``, ``layer_norm``, ``_pick_chunk``,
``_causal_conv`` (with and without a carried state), the SSD chunk form
``_ssd_chunked`` at zamba2's decay scale, ``mamba2`` full and a few
``mamba2_decode`` steps from its state, ``rwkv6_timemix`` full (one chunk,
several, a prompt shorter than a chunk) and decode, ``rwkv6_chanmix``, and
the initializers' leaves.

The same numpy-seeded inputs (and the reference's own initial parameters)
go through both packages, in float32, the reference's blocks compiled
(``jax.jit``, as its serving runs them: XLA fuses their float ops, which
moves a bit or two against op-by-op).  Tolerances, as measured (outputs
of magnitude up to ~3 within 3.9e-6, states within 1.5e-7 of their
largest magnitude):
``softplus`` within 2 ulp where the result is a normal float32 (XLA flushes
a subnormal result to zero, ATen keeps it); ``layer_norm`` and the
convolution within ``ELEM_ATOL``; a block's output within ``OUT_ATOL`` and
its recurrent state within ``STATE_REL`` of the state's largest magnitude
(float32 sums in other orders; the states integrate them); the SSD chunk
form within ``SSD_REL`` of its largest magnitude: ``cum_t - cum_s``
subtracts float32 cumsums that reach the thousands at 80 heads (``a``
down to -80), and XLA and ATen order a cumsum differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

from _torch_threads import one_torch_thread  # noqa: F401

ELEM_ATOL = 1e-6
OUT_ATOL = 5e-6
STATE_REL = 1e-6
SSD_REL = 1e-5
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)
# the reference's blocks compiled once per shape (the keywords are static)
J_MAMBA2 = jax.jit(JS.mamba2, static_argnames=(
    "d_inner", "d_state", "n_heads", "chunk", "quant", "compute_dtype",
    "return_state"))
J_MAMBA2_DECODE = jax.jit(JS.mamba2_decode, static_argnames=(
    "d_inner", "d_state", "n_heads", "quant", "compute_dtype"))
J_TIMEMIX = jax.jit(JS.rwkv6_timemix, static_argnames=(
    "n_heads", "chunk", "quant", "compute_dtype", "return_state"))
J_TIMEMIX_DECODE = jax.jit(JS.rwkv6_timemix_decode, static_argnames=(
    "n_heads", "quant", "compute_dtype"))


def _t(tree):
    """A reference parameter tree (or array) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _within(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _rel(got, want, rel):
    want = np.asarray(want)
    _within(got, want, rel * max(1.0, float(np.abs(want).max())))


def test_softplus_is_logaddexp_within_two_ulp():
    x = np.concatenate([
        np.random.default_rng(0).normal(0, 5, 20000),
        [0.0, -0.0, 1e-30, -1e-30, 20, 21, -20, 40, -40, 80, -80, 88, -88,
         100, -100, np.inf, -np.inf, np.nan]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    normal = np.isfinite(want) & (np.abs(want) >= np.finfo(np.float32).tiny)
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert ulp[normal].max() <= 2
    # XLA flushes subnormal results to zero; ATen keeps them
    sub = ~normal & np.isfinite(want)
    assert np.all(want[sub] == 0)
    assert np.all(np.abs(got[sub]) < np.finfo(np.float32).tiny)
    assert got[-3] == np.inf and got[-2] == 0.0


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm_matches_reference(bias):
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 3, (4, 7, 64)) + 2).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 64).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    want = JL.layer_norm(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x))
    _within(TL.layer_norm(_t(p), torch.from_numpy(x)), want, ELEM_ATOL)
    # the compute dtype round trip: bf16 in, bf16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert TL.layer_norm(_t(p), xb).dtype == torch.bfloat16


@pytest.mark.parametrize("T,target", [(12, 128), (12, 5), (7, 32), (64, 32),
                                      (13, 4), (1, 8)])
def test_pick_chunk_matches_reference(T, target):
    assert TS._pick_chunk(T, target) == JS._pick_chunk(T, target)


@pytest.mark.parametrize("T", [1, 2, 3, 9])
@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_reference(T, carried):
    """Full sequence (zero history) and a step from a carried state; a
    prompt shorter than the taps keeps the reference's shorter history."""
    rng = np.random.default_rng(T)
    x = rng.normal(0, 1, (3, T, 40)).astype(np.float32)
    w = rng.normal(0, 0.1, (4, 40)).astype(np.float32)
    b = rng.normal(0, 0.1, 40).astype(np.float32)
    st = rng.normal(0, 1, (3, 3, 40)).astype(np.float32) if carried else None
    ya, sa = JS._causal_conv(*(None if v is None else jnp.asarray(v)
                               for v in (x, w, b, st)))
    yb, sb = TS._causal_conv(*(None if v is None else torch.from_numpy(v)
                               for v in (x, w, b, st)))
    _within(yb, ya, ELEM_ATOL)
    assert np.array_equal(sb.numpy(), np.asarray(sa))


@pytest.mark.parametrize("chunk", [64, 16, 8])
def test_ssd_chunked_at_zamba2_decay_scale(chunk):
    """80 heads (``a = -1 .. -80``), 64 steps: the chunk form's output and
    final state within ``SSD_REL``."""
    rng = np.random.default_rng(2)
    B, T, H, P, N = 2, 64, 80, 8, 16
    xs = rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, T, H)))).astype(np.float32)
    a = -np.arange(1, H + 1, dtype=np.float32)
    Bc = rng.normal(0, 1, (B, T, N)).astype(np.float32)
    Cc = rng.normal(0, 1, (B, T, N)).astype(np.float32)
    ya, ha = JS._ssd_chunked(*map(jnp.asarray, (xs, dt, a, Bc, Cc)),
                             chunk=chunk)
    yb, hb = TS._ssd_chunked(*map(torch.from_numpy, (xs, dt, a, Bc, Cc)),
                             chunk=chunk)
    _rel(yb, ya, SSD_REL)
    _rel(hb, ha, SSD_REL)


def _mamba_params():
    """The reference's initial Mamba2 parameters at the smoke widths, with
    nonzero dt_bias, D and conv bias so every term is exercised."""
    rng = np.random.default_rng(3)
    d, di, N, H = 64, 128, 16, 8
    jp = dict(JS.init_mamba2(jax.random.PRNGKey(0), d, di, N, H))
    jp["dt_bias"] = jnp.asarray(rng.normal(0, 1, H).astype(np.float32))
    jp["D"] = jnp.asarray(rng.normal(1, 0.2, H).astype(np.float32))
    jp["conv_b"] = jnp.asarray(rng.normal(0, 0.1, di + 2 * N)
                               .astype(np.float32))
    return jp, _t(jp), dict(d_inner=di, d_state=N, n_heads=H)


@pytest.mark.parametrize("chunk", [128, 4])
def test_mamba2_full_then_decode_matches_reference(chunk):
    """A 12-token prefill in one chunk or three, its state, then three
    decode steps from it."""
    jp, tp, kw = _mamba_params()
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 12, 64)).astype(np.float32)
    ya, sa = J_MAMBA2(jp, jnp.asarray(x), chunk=chunk, return_state=True,
                      **kw, **F32)
    yb, sb = TS.mamba2(tp, torch.from_numpy(x), chunk=chunk,
                       return_state=True, **kw, **T32)
    _within(yb, ya, OUT_ATOL)
    _rel(sb.h, sa.h, STATE_REL)
    assert np.array_equal(sb.conv.numpy(), np.asarray(sa.conv))
    for _ in range(3):
        xd = rng.normal(0, 1, (3, 1, 64)).astype(np.float32)
        ya, sa = J_MAMBA2_DECODE(jp, jnp.asarray(xd), sa, **kw, **F32)
        yb, sb = TS.mamba2_decode(tp, torch.from_numpy(xd), sb, **kw, **T32)
        _within(yb, ya, OUT_ATOL)
        _rel(sb.h, sa.h, STATE_REL)
        _within(sb.conv, sa.conv, ELEM_ATOL)


@pytest.mark.parametrize("T,chunk", [(12, 32), (12, 4), (64, 32), (7, 32)])
def test_rwkv6_timemix_full_then_decode_matches_reference(T, chunk):
    """One chunk, several, two of 32, a prompt shorter than a chunk; then
    three decode steps from the final state."""
    jp = JS.init_rwkv6(jax.random.PRNGKey(1), 64, 4)
    tp = _t(jp)
    rng = np.random.default_rng(T + chunk)
    x = rng.normal(0, 1, (3, T, 64)).astype(np.float32)
    ya, (Sa, xa) = J_TIMEMIX(jp, jnp.asarray(x), n_heads=4, chunk=chunk,
                             return_state=True, **F32)
    yb, (Sb, xb) = TS.rwkv6_timemix(tp, torch.from_numpy(x), n_heads=4,
                                    chunk=chunk, return_state=True, **T32)
    _within(yb, ya, OUT_ATOL)
    _rel(Sb, Sa, STATE_REL)
    assert np.array_equal(xb.numpy(), np.asarray(xa))
    sj = JS.RWKVState(S=Sa, x_prev_t=xa, x_prev_c=xa)
    st = TS.RWKVState(Sb, xb, xb)
    for _ in range(3):
        xd = rng.normal(0, 1, (3, 1, 64)).astype(np.float32)
        ya, sj = J_TIMEMIX_DECODE(jp, jnp.asarray(xd), sj, n_heads=4, **F32)
        yb, st = TS.rwkv6_timemix_decode(tp, torch.from_numpy(xd), st,
                                         n_heads=4, **T32)
        _within(yb, ya, OUT_ATOL)
        _rel(st.S, sj.S, STATE_REL)
        assert np.array_equal(st.x_prev_t.numpy(), np.asarray(sj.x_prev_t))


def test_rwkv6_chanmix_matches_reference():
    jp = JS.init_rwkv6_chanmix(jax.random.PRNGKey(2), 64, 128)
    rng = np.random.default_rng(5)
    x, xp = (rng.normal(0, 1, (3, 5, 64)).astype(np.float32)
             for _ in range(2))
    want = JS.rwkv6_chanmix(jp, jnp.asarray(x), jnp.asarray(xp), **F32)
    got = TS.rwkv6_chanmix(_t(jp), torch.from_numpy(x), torch.from_numpy(xp),
                           **T32)
    _within(got, want, OUT_ATOL)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("which", ["mamba2", "rwkv6", "chanmix"])
def test_initializers_make_the_reference_leaves(which):
    """Same leaf names, shapes and dtypes (the values come from each
    package's own generator); A_log is log(1..H) in both, within an ulp
    (XLA's and ATen's float32 ``log``)."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if which == "mamba2":
        want = JS.init_mamba2(key, 64, 128, 16, 8)
        got = TS.init_mamba2(gen, 64, 128, 16, 8)
        np.testing.assert_allclose(got["A_log"].numpy(),
                                   np.asarray(want["A_log"]), rtol=1.2e-7)
    elif which == "rwkv6":
        want = JS.init_rwkv6(key, 64, 4)
        got = TS.init_rwkv6(gen, 64, 4)
    else:
        want = JS.init_rwkv6_chanmix(key, 64, 128)
        got = TS.init_rwkv6_chanmix(gen, 64, 128)
    assert _shapes(got) == _shapes(jax.tree_util.tree_map(_t, want))
