"""Atomic, optionally asynchronous checkpoints of a tree of tensors (port of
``repro.ckpt.checkpoint``, with its layout on disk):

    ckpt_dir/step_00000123/
        manifest.json        (step, paths, shapes, dtypes, codec, extra)
        data.msgpack.zst     (one msgpack array of raw little-endian buffers)
        _COMMITTED           (written last; restore ignores dirs without it)

A tree is nested dicts, lists and tuples of tensors (``None`` holds no
leaf).  Leaves are flattened as ``jax.tree_util`` flattens them (dict keys
sorted) and named by its ``keystr`` spelling (``['cache'][0]['k']``), and
dtypes by numpy's names (``bfloat16`` for a bf16 tensor, whose raw bytes
go through a 16-bit integer view), so a generic tree written by either
package reads in the other.  The msgpack array of ``bin`` objects is
framed here, byte for byte what ``msgpack.packb(list_of_bytes)`` writes,
and the payload is compressed with ``zstandard`` when it imports, else
with ``zlib`` at level 3; the manifest's ``codec`` says which.  Saves
write into a ``.tmp`` directory and rename it, so a save that dies midway
never corrupts the latest committed step.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zlib
from typing import Any, Optional

import torch

from repro_torch.core.tree import flatten as _flatten
from repro_torch.core.tree import unflatten as _unflatten

try:
    import zstandard
except ImportError:               # a machine without the zstd bindings
    zstandard = None

# torch dtype <-> numpy's name for it
_NAMES = {torch.bool: "bool", torch.int8: "int8", torch.uint8: "uint8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.float32: "float32", torch.float64: "float64"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _compress(payload: bytes) -> tuple[bytes, str]:
    """(bytes, codec); the codec goes into the manifest."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(payload), "zstd"
    return zlib.compress(payload, 3), "zlib"


def _decompress(data: bytes, codec: str) -> bytes:
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the zstandard module "
                "is not installed in this environment")
        return zstandard.ZstdDecompressor().decompress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def pack_bins(bufs) -> bytes:
    """A msgpack array of ``bin`` objects: ``msgpack.packb(list(bufs))``."""
    n = len(bufs)
    if n < 16:
        parts = [bytes([0x90 | n])]
    elif n < 1 << 16:
        parts = [b"\xdc" + struct.pack(">H", n)]
    else:
        parts = [b"\xdd" + struct.pack(">I", n)]
    for b in bufs:
        m = len(b)
        if m < 1 << 8:
            parts.append(b"\xc4" + struct.pack(">B", m))
        elif m < 1 << 16:
            parts.append(b"\xc5" + struct.pack(">H", m))
        else:
            parts.append(b"\xc6" + struct.pack(">I", m))
        parts.append(b)
    return b"".join(parts)


def unpack_bins(data) -> list:
    """The buffers of :func:`pack_bins`' framing, as memoryviews of
    ``data``."""
    view = memoryview(data)
    head, at = view[0], 1
    if head & 0xF0 == 0x90:
        n = head & 0x0F
    elif head == 0xDC:
        (n,), at = struct.unpack_from(">H", view, 1), 3
    elif head == 0xDD:
        (n,), at = struct.unpack_from(">I", view, 1), 5
    else:
        raise ValueError(f"not a msgpack array header: {head:#x}")
    out = []
    for _ in range(n):
        kind = view[at]
        size = {0xC4: 1, 0xC5: 2, 0xC6: 4}.get(kind)
        if size is None:
            raise ValueError(f"not a msgpack bin header: {kind:#x}")
        m = int.from_bytes(view[at + 1:at + 1 + size], "big")
        at += 1 + size
        out.append(view[at:at + m])
        at += m
    if at != len(view):
        raise ValueError(f"{len(view) - at} trailing bytes after the array")
    return out


def _host(leaf) -> torch.Tensor:
    return torch.as_tensor(leaf).detach().to("cpu").contiguous()


def tree_to_host(tree: Any) -> Any:
    """Every leaf as a contiguous tensor on the host (on the card the copy
    synchronizes)."""
    _, leaves = _flatten(tree)
    return _unflatten(tree, [_host(t) for t in leaves])


def _raw(t: torch.Tensor) -> bytes:
    """The tensor's little-endian bytes (bf16 through an int16 view)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         async_save: bool = False) -> Optional[threading.Thread]:
    """Write ``tree`` (copied to the host first) atomically under
    ``ckpt_dir`` as step ``step``; ``extra`` is JSON-able metadata.  With
    ``async_save`` the files are written on a daemon thread, returned."""
    paths, leaves = _flatten(tree)
    # a copy even of a CPU leaf: the caller may update it in place while
    # an async save is still writing it
    host = [torch.as_tensor(t).detach().to("cpu", copy=True).contiguous()
            for t in leaves]
    for p, t in zip(paths, host):
        if t.dtype not in _NAMES:
            raise TypeError(f"{p}: no checkpoint dtype for {t.dtype}")

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        blob, codec = _compress(pack_bins([_raw(t) for t in host]))
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(t.shape) for t in host],
            "dtypes": [_NAMES[t.dtype] for t in host],
            "codec": codec,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "data.msgpack.zst"), "wb") as f:
            f.write(blob)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step under ``ckpt_dir`` (None when there is
    none): ``.tmp`` directories and directories without ``_COMMITTED`` are
    ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "_COMMITTED")):
            steps.append(int(d[5:]))
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of ``step`` (default: the latest committed one)."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, target_tree: Any,
            step: Optional[int] = None) -> tuple[Any, dict]:
    """Read ``step`` (default: the latest committed one) into the structure
    of ``target_tree``: (a tree of host tensors, the manifest's extra).
    Raises ``ValueError`` when the paths, a shape or a dtype differ from
    the target's."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    paths, leaves = _flatten(target_tree)
    if paths != man["paths"]:
        missing = set(man["paths"]) ^ set(paths)
        raise ValueError(
            f"checkpoint/model structure mismatch: {sorted(missing)[:5]}")
    for p, t, shape, dtype in zip(paths, leaves, man["shapes"],
                                  man["dtypes"]):
        t = torch.as_tensor(t)
        if list(t.shape) != shape or _NAMES.get(t.dtype) != dtype:
            raise ValueError(
                f"checkpoint/model leaf mismatch at {p}: checkpoint "
                f"{dtype}{shape}, model {_NAMES.get(t.dtype)}"
                f"{list(t.shape)}")
    with open(os.path.join(d, "data.msgpack.zst"), "rb") as f:
        payload = bytearray(_decompress(f.read(), man.get("codec", "zstd")))
    bufs = unpack_bins(payload)
    if len(bufs) != len(paths):
        raise ValueError(f"checkpoint holds {len(bufs)} buffers for "
                         f"{len(paths)} leaves")
    out = []
    for buf, shape, dtype in zip(bufs, man["shapes"], man["dtypes"]):
        dt = _DTYPES[dtype]
        raw = torch.int16 if dt == torch.bfloat16 else dt
        t = torch.frombuffer(buf, dtype=raw) if len(buf) else \
            torch.empty((0,), dtype=raw)
        out.append(t.view(dt).reshape(shape))
    return _unflatten(target_tree, out), man["extra"]
