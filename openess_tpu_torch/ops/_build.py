"""Build the CUDA C++ kernels under ``csrc/`` with ``nvcc`` and load them.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Every C entry takes its arguments, then the CUDA stream, and
returns a ``cudaError_t``; :func:`entry` binds one, :func:`launch` calls it
on the current stream and raises on an error. Libraries go to
``openess_tpu_torch/_build/``, named by a hash of the source, the headers
under ``csrc/`` it includes (``#include "..."``, followed through headers)
and the flags, so an edited source or header is never served from a stale
build. Each source is its own library. The build runs at first use, in the process that launches the
kernel; nothing is built when a module is imported.

The host route (:func:`build_host`, :func:`load_host`) builds the port's
host C++ (``csrc/event_ops.cpp``, the event packer and host voxelizers
that ``native.py`` binds) the same way, with the host compiler (``CXX``,
else ``c++`` or ``g++`` on ``PATH``) called directly and
``HOST_CXX_FLAGS``. Its library is named by a hash of the source, the flags,
the compiler's version and the macros ``-march=native`` defines on this
host, so a library built from an older source, or for another CPU, is
never loaded. A failed build raises with the compiler's error; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_CXX_FLAGS = (
    "-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17",
    "-pthread",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of openess_tpu_torch are built from source at first use"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[str]:
    """``csrc/<source>`` and the headers under ``csrc/`` that it includes,
    directly or through another header, each once, in include order."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        path = os.path.join(CSRC_DIR, name)
        if name in seen or not os.path.isfile(path):
            continue
        seen.append(name)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def library_path(source: str) -> str:
    """Where the library for ``csrc/<source>`` lives once built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources(source):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return its
    path. The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    out = library_path(source)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.splitext(out)[0] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _LIBS[source] = lib
        return lib


@functools.cache
def entry(source: str, name: str, *argtypes):
    """The C entry ``name`` of ``csrc/<source>``'s library, taking
    ``argtypes`` and then the stream, returning an int error code. Each
    call makes a function object of its own (``lib[name]``, not the
    library's shared attribute) and binds it before handing it out: two
    threads' first calls may both run here, and rebinding ``argtypes`` on an
    object another thread is calling frees the converters ctypes is using."""
    fn = load(source)[name]
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device: torch.device, *args):
    """Call the C entry ``fn`` with ``args`` on the current stream of
    ``device``; raise on a nonzero ``cudaError_t``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def host_compiler() -> list[str]:
    """The host C++ compiler's command: ``CXX`` (split like a shell word
    list), else ``c++`` or ``g++`` on ``PATH``. Raises when none is
    found."""
    cxx = shlex.split(os.environ.get("CXX", ""))
    if cxx:
        found = shutil.which(cxx[0])
        if found is None:
            raise RuntimeError(
                f"CXX={os.environ['CXX']!r} names no compiler on PATH: the "
                "host C++ of openess_tpu_torch (csrc/event_ops.cpp) is built "
                "from source at first use")
        return [found, *cxx[1:]]
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found is not None:
            return [found]
    raise RuntimeError(
        "no host C++ compiler (set CXX or put c++ or g++ on PATH): the host "
        "C++ of openess_tpu_torch (csrc/event_ops.cpp) is built from source "
        "at first use")


@functools.cache
def _host_identity(cxx: tuple) -> bytes:
    """The compiler's version and the macros ``-march=native`` defines with
    it here (the instruction sets the library will use)."""
    out = []
    for args in (["--version"], ["-march=native", "-dM", "-E", "-x", "c++",
                                 os.devnull]):
        proc = subprocess.run([*cxx, *args], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cxx)} {' '.join(args)} failed (exit "
                f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        out.append(proc.stdout)
    return "\0".join(out).encode()


def host_library_path(source: str) -> str:
    """Where the host library for ``csrc/<source>`` lives once built with
    this host's compiler."""
    cxx = tuple(host_compiler())
    digest = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    digest.update(_host_identity(cxx))
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest.update(source.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_host_{digest.hexdigest()[:16]}.so")


def build_host(source: str) -> str:
    """Compile the host C++ ``csrc/<source>`` unless its library exists;
    return its path. The compiler's output is kept beside it as ``.log``;
    a failed build raises with the compiler's command and stderr."""
    out = host_library_path(source)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*host_compiler(), *HOST_CXX_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.splitext(out)[0] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed on {source} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_host(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the host library of ``csrc/<source>``
    once per process."""
    key = "host:" + source
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_host(source))
            _LIBS[key] = lib
        return lib
