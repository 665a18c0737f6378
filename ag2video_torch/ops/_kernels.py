"""Build and bind the hand-written CUDA kernels under ``ag2video_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``, at first use and never at
import. The library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused. Build outputs go to
``ag2video_torch/_build/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """One compiled source: the ctypes handle, its build time and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.signatures_set = False


_loaded: Dict[str, KernelLibrary] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def load(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}_{digest}.so"
        log = ""
        t0 = time.perf_counter()
        if not so.exists():
            # Build to a private file and rename: concurrent processes never
            # load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {src}:\n{log}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        built = KernelLibrary(ctypes.CDLL(str(so)), so,
                              time.perf_counter() - t0, log)
        _loaded[name] = built
        return built


def rasterize_library() -> KernelLibrary:
    """The box rasterizer (csrc/rasterize.cu) with its C signatures set."""
    built = load("rasterize")
    if not built.signatures_set:
        lib = built.lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ag_rasterize_forward.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.ag_rasterize_forward.restype = ctypes.c_int
        lib.ag_rasterize_smem_bytes.argtypes = [i, i]
        lib.ag_rasterize_smem_bytes.restype = ctypes.c_longlong
        built.signatures_set = True
    return built
