"""Build and bind the hand-written native code under ``ag2video_torch/csrc``.

Each CUDA source (``<name>.cu``) is compiled by ``nvcc`` for ``sm_90a``, and
the host library (``host.cpp``) by ``g++`` with the JAX package's
``native/Makefile`` flags, into a shared library with a plain C interface,
loaded with ``ctypes``, at first use and never at import. The library's file
name carries a hash of its source and its compile command (for the host
library also of the CPU that ``-march=native`` resolves to), so an edited
source is rebuilt and an unchanged one is reused. Build outputs go to
``ag2video_torch/_build/`` (git-ignored). `SIGNATURES` holds each library's
C interface, typed when the library is loaded.

It also holds the one rule of dispatch. Each op with a CUDA kernel asks
`use_kernel` whether the kernel computes a call: a CUDA tensor, a call the
kernel takes (the op's own conditions, checked at the
op), and no `plain()` around the call. Inside `plain()` every such op takes
its plain version on the card too: the kernels' oracle.
"""

from __future__ import annotations

import contextlib
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


_plain_depth = 0


@contextlib.contextmanager
def plain():
    """Inside, every op with a CUDA kernel takes its plain version, on the
    card too. Process-wide; it nests."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_kernel(device_type: str, takes: bool = True) -> bool:
    """Whether a CUDA kernel computes a call: a CUDA tensor, a call the
    kernel `takes` (its op's own conditions) and no `plain()` around it.
    Where it does, the op launches the kernel or raises: it never falls
    back to its plain version."""
    return takes and device_type == "cuda" and not _plain_depth


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C interface of each csrc/<name>.cu and of csrc/host.cpp ("host"):
# {function: (argtypes, restype)}.
SIGNATURES = {
    "rasterize": {
        "ag_rasterize_forward": ([_p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                                  _p], _i),
        "ag_rasterize_smem_bytes": ([_i, _i, _i, _i], _ll),
    },
    "denorm": {
        "ag_denorm_forward": ([_p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _i,
                               _p], _i),
    },
    "objconv": {
        "ag_objconv_forward": ([_p, _ll, _p, _p, _p, _p, _p, _p, _p, _i, _i,
                                _i, _i, _i, _i, _i, _i, _i, _p], _i),
    },
    "host": {
        "agtpu_clip_resize_normalize": ([_p, _i, _i, _i, _p, _i, _i, _p, _p,
                                         _i], None),
        "agtpu_pad_boxes": ([_p, _i, _i, _p, _i, ctypes.c_float], None),
        "agtpu_png_unfilter": ([_p, _i, _i, _i, _p], _i),
        "agtpu_version": ([], _i),
    },
}

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
    the same source, command and `salt` is built, load it and type its C
    functions from SIGNATURES[name]."""
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
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        built = KernelLibrary(lib, so, time.perf_counter() - t0, log)
        _loaded[name] = built
        return built


def load(name: str) -> KernelLibrary:
    """``csrc/<name>.cu``, compiled if needed, loaded, and its C interface
    typed from SIGNATURES."""
    built = _loaded.get(name)
    if built is not None:
        return built
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
    """``csrc/host.cpp``, compiled by g++ if needed, loaded and typed. The
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
