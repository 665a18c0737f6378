"""Build and bind the hand-written native code under ``ag2video_torch/csrc``.

Each CUDA source (``<name>.cu``) is compiled by ``nvcc`` for ``sm_90a``, and
the host library (``host.cpp``) by ``g++`` with the JAX package's
``native/Makefile`` flags, into a shared library with a plain C interface,
loaded with ``ctypes``, at first use and never at import. The library's file
name carries a hash of its source and its compile command (for the host
library also of the CPU that ``-march=native`` resolves to), so an edited
source is rebuilt and an unchanged one is reused. Build outputs go to
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
# One lock per library: two libraries build at once, one library once.
_build_locks: Dict[str, threading.Lock] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


# native/Makefile's CXXFLAGS and LDFLAGS.
HOST_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
HOST_LDFLAGS = ("-shared", "-lpthread")


def _build(name: str, src: Path, command, salt: str = "") -> KernelLibrary:
    """Compile `src` with `command(out_path)` (an argv) unless a library of
    the same source, command and `salt` is built, and load it."""
    with _lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(command("")).encode()
            + salt.encode()).hexdigest()[:16]
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
                argv = command(tmp)
                proc = subprocess.run(argv, capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"{argv[0]} failed for {src}:\n{log}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        built = KernelLibrary(ctypes.CDLL(str(so)), so,
                              time.perf_counter() - t0, log)
        _loaded[name] = built
        return built


def load(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    src = CSRC / f"{name}.cu"
    return _build(name, src,
                  lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out, str(src)])


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host library "
                           "(csrc/host.cpp) needs a C++17 compiler")
    return found


def host_library() -> KernelLibrary:
    """``csrc/host.cpp``, compiled by g++ if needed, and loaded. The
    library is keyed on the target that ``-march=native`` resolves to, so a
    build directory shared between machines never hands one CPU another's
    instructions."""
    if "host" in _loaded:
        return _loaded["host"]
    cxx = _cxx()
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    src = CSRC / "host.cpp"
    return _build("host", src, lambda out: [
        cxx, *HOST_CXXFLAGS, str(src), "-o", out, *HOST_LDFLAGS], target)


def rasterize_library() -> KernelLibrary:
    """The box rasterizer (csrc/rasterize.cu) with its C signatures set."""
    built = load("rasterize")
    if not built.signatures_set:
        lib = built.lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ag_rasterize_forward.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.ag_rasterize_forward.restype = ctypes.c_int
        lib.ag_rasterize_smem_bytes.argtypes = [i, i, i, i]
        lib.ag_rasterize_smem_bytes.restype = ctypes.c_longlong
        built.signatures_set = True
    return built


def denorm_library() -> KernelLibrary:
    """The fused SPADE denormalization (csrc/denorm.cu) with its C
    signature set."""
    built = load("denorm")
    if not built.signatures_set:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        built.lib.ag_denorm_forward.argtypes = [p, p, p, p, p, ll, i, i, i,
                                                i, i, p]
        built.lib.ag_denorm_forward.restype = ctypes.c_int
        built.signatures_set = True
    return built


def objconv_library() -> KernelLibrary:
    """The fused factorized frontend conv (csrc/objconv.cu) with its C
    signatures set."""
    built = load("objconv")
    if not built.signatures_set:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        built.lib.ag_objconv_forward.argtypes = [
            p, ll, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        built.lib.ag_objconv_forward.restype = ctypes.c_int
        built.signatures_set = True
    return built
