"""The port's checkpoint module (``repro_torch.ckpt.checkpoint``) against
``msgpack`` and the reference's ``repro.ckpt.checkpoint``.

The msgpack framing must be byte-identical to ``msgpack.packb`` of a list
of bytes (every array and bin header width), every dtype must round-trip
bitwise (bf16 through its raw bytes), a step counts only once committed,
``async_save`` returns its writer thread, a machine without ``zstandard``
and ``msgpack`` writes and reads zlib checkpoints, a structure, shape or
dtype mismatch raises ``ValueError``, and a generic tree written by either
package reads in the other.
"""
import os
import sys

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as tckpt

from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sizes", [
    [0], [1], [15], [16], [70_000], [0, 1, 15, 16, 255, 256, 65_535,
                                     65_536, 70_000]])
def test_bin_framing_equals_msgpack(sizes):
    rng = np.random.default_rng(len(sizes))
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    packed = tckpt.pack_bins(bufs)
    assert packed == msgpack.packb(bufs)
    assert [bytes(b) for b in tckpt.unpack_bins(packed)] == \
        msgpack.unpackb(packed)


@pytest.mark.parametrize("n", [0, 15, 16, 65_536])
def test_array_framing_equals_msgpack(n):
    bufs = [bytes([i % 251]) * (i % 3) for i in range(n)]
    packed = tckpt.pack_bins(bufs)
    assert packed == msgpack.packb(bufs)
    assert [bytes(b) for b in tckpt.unpack_bins(packed)] == bufs


def test_framing_rejects_garbage():
    with pytest.raises(ValueError, match="array header"):
        tckpt.unpack_bins(b"\xc4\x00")
    with pytest.raises(ValueError, match="trailing"):
        tckpt.unpack_bins(msgpack.packb([b"ab"]) + b"\x00")


def _tree():
    """A leaf of each serving dtype (bf16, float32, int8, int32, bool), an
    empty leaf, a scalar and a ``None``."""
    g = torch.Generator().manual_seed(0)
    return {
        "cache": [{"k": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
                   "k_scale": torch.rand(2, 3, generator=g)},
                  {"k": torch.randint(-128, 128, (2, 3, 4), generator=g,
                                      dtype=torch.int8)}],
        "pos": torch.tensor([3, -1, 70_000], dtype=torch.int32),
        "done": torch.tensor([True, False, True]),
        "empty": torch.zeros((0, 4), dtype=torch.float32),
        "pair": (torch.tensor(2.5), None),
    }


def _flat(tree):
    return tckpt._flatten(tree)


def _assert_bitwise(a, b):
    pa, la = _flat(a)
    pb, lb = _flat(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), p


def test_dtypes_round_trip_bitwise(tmp_path):
    tree = _tree()
    assert tckpt.save(str(tmp_path), 7, tree, extra={"note": [1, 2]}) is None
    got, extra = tckpt.restore(str(tmp_path), tree)
    assert extra == {"note": [1, 2]}
    _assert_bitwise(got, tree)
    assert all(t.device.type == "cpu" for t in _flat(got)[1])
    host = tckpt.tree_to_host(tree)
    _assert_bitwise(host, tree)
    assert host["pair"][1] is None and isinstance(host["pair"], tuple)
    man = tckpt.manifest(str(tmp_path))
    assert man["dtypes"] == ["bfloat16", "float32", "int8", "bool",
                             "float32", "float32", "int32"]
    assert man["paths"] == ["['cache'][0]['k']", "['cache'][0]['k_scale']",
                            "['cache'][1]['k']", "['done']", "['empty']",
                            "['pair'][0]", "['pos']"]


def test_paths_follow_jax_keystr():
    import jax
    tree = {"b": [jnp.zeros(2), (jnp.ones(1), None)],
            "a": {"k": jnp.zeros(1), "c": None}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [jax.tree_util.keystr(p) for p, _ in flat]
    ttree = {"b": [torch.zeros(2), (torch.ones(1), None)],
             "a": {"k": torch.zeros(1), "c": None}}
    assert _flat(ttree)[0] == want


def test_commit_marker_and_tmp_dirs_are_ignored(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    assert tckpt.latest_step(os.path.join(d, "missing")) is None
    tckpt.save(d, 3, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))        # never committed
    assert tckpt.latest_step(d) == 3
    tckpt.save(d, 5, _tree())
    assert tckpt.latest_step(d) == 5
    # saving a step again replaces it
    tree = _tree()
    tree["pos"] += 1
    tckpt.save(d, 5, tree)
    _assert_bitwise(tckpt.restore(d, tree)[0], tree)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000005",
                                     "step_00000008", "step_00000009.tmp"]
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


def test_async_save_returns_its_writer(tmp_path):
    tree = _tree()
    t = tckpt.save(str(tmp_path), 11, tree, async_save=True)
    assert t is not None and t.daemon
    t.join(timeout=60)
    assert not t.is_alive()
    assert tckpt.latest_step(str(tmp_path)) == 11
    _assert_bitwise(tckpt.restore(str(tmp_path), tree, step=11)[0], tree)


def test_zlib_without_zstandard_or_msgpack(tmp_path, monkeypatch):
    """Hidden ``zstandard`` and ``msgpack``: the module (imported anew)
    writes zlib, records it, and reads it back; a zstd checkpoint then
    raises the reference's error."""
    zstd_dir = tmp_path / "zstd"
    tckpt.save(str(zstd_dir), 1, _tree())
    zstd_codec = tckpt.manifest(str(zstd_dir))["codec"]
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    # both undone at teardown: the package attribute and the module entry
    monkeypatch.setattr(sys.modules["repro_torch.ckpt"], "checkpoint", tckpt)
    monkeypatch.delitem(sys.modules, "repro_torch.ckpt.checkpoint")
    import importlib
    bare = importlib.import_module("repro_torch.ckpt.checkpoint")
    assert bare is not tckpt and bare.zstandard is None
    tree = _tree()
    bare.save(str(tmp_path / "zlib"), 2, tree)
    assert bare.manifest(str(tmp_path / "zlib"))["codec"] == "zlib"
    _assert_bitwise(bare.restore(str(tmp_path / "zlib"), tree)[0], tree)
    if zstd_codec == "zstd":
        with pytest.raises(RuntimeError, match="zstandard"):
            bare.restore(str(zstd_dir), tree)
    # and the module with zstandard reads the zlib checkpoint too
    _assert_bitwise(tckpt.restore(str(tmp_path / "zlib"), _tree())[0],
                    _tree())


def test_structure_shape_and_dtype_mismatch_raise(tmp_path):
    tree = _tree()
    tckpt.save(str(tmp_path), 1, tree)
    other = _tree()
    other["cache"][1]["k_scale"] = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(str(tmp_path), other)
    other = _tree()
    other["pos"] = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="leaf mismatch at \\['pos'\\]"):
        tckpt.restore(str(tmp_path), other)
    other = _tree()
    other["cache"][0]["k"] = other["cache"][0]["k"].float()
    with pytest.raises(ValueError, match="leaf mismatch"):
        tckpt.restore(str(tmp_path), other)
    with pytest.raises(TypeError, match="no checkpoint dtype"):
        tckpt.save(str(tmp_path), 2, {"c": torch.zeros(1, dtype=torch.cfloat)})


def _generic():
    """The same values as a torch tree and a jnp tree."""
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 2)).astype(np.float32)
    i8 = rng.integers(-128, 128, (6,), dtype=np.int8)
    i32 = rng.integers(-2**31, 2**31 - 1, (2, 2), dtype=np.int32)
    b = rng.integers(0, 2, (5,)).astype(bool)
    t = {"w": torch.from_numpy(f32), "h": torch.from_numpy(bf).bfloat16(),
         "layers": [{"q": torch.from_numpy(i8)}, {"q": torch.from_numpy(i8)}],
         "step": (torch.from_numpy(i32), torch.from_numpy(b))}
    j = {"w": jnp.asarray(f32), "h": jnp.asarray(bf).astype(jnp.bfloat16),
         "layers": [{"q": jnp.asarray(i8)}, {"q": jnp.asarray(i8)}],
         "step": (jnp.asarray(i32), jnp.asarray(b))}
    return t, j


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    t, j = _generic()
    tckpt.save(str(tmp_path), 4, t, extra={"by": "port"})
    got, extra = jckpt.restore(str(tmp_path), j)
    assert extra == {"by": "port"}
    pt, lt = _flat(t)
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == pt
    for (_, x), y in zip(flat, lt):
        assert np.asarray(x).dtype.name == tckpt._NAMES[y.dtype]
        np.testing.assert_array_equal(_jnp(x), _np(y))


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    t, j = _generic()
    jckpt.save(str(tmp_path), 6, j, extra={"by": "reference"})
    got, extra = tckpt.restore(str(tmp_path), t)
    assert extra == {"by": "reference"}
    _assert_bitwise(got, t)
