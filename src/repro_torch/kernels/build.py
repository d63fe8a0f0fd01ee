"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

into the build directory (``build/repro_torch`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``), then loaded with ``ctypes``.  The file name
carries a hash of the source and the flags, so an edited source never loads
a stale library.  All sources compile in parallel, one ``nvcc`` each.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("lutmul", "int_matmul", "lutmul_tmac", "thresholds",
           "lutmul_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set NVCC")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together; returns {name: compiler output of this process's builds}.
    Raises on any failure."""
    with _LOCK:
        todo = [n for n in SOURCES if not _target(n).exists()]
        if not todo:
            return {n: _LOGS.get(n, "") for n in SOURCES}
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            _LOGS[n] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{n}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, _target(n))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: _LOGS.get(n, "") for n in SOURCES}


def sass_counts(name: str, opcode: str) -> dict[str, int]:
    """{kernel function: SASS instructions of ``opcode``} in the built
    library of ``csrc/<name>.cu`` (built first if need be), from the
    toolkit's ``cuobjdump -sass``."""
    load(name)
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    func = None
    pattern = re.compile(rf"[\s}}]{re.escape(opcode)}[.\s]")
    for line in text.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = 0
        elif func is not None and pattern.search(line):
            counts[func] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
