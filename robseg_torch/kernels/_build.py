"""Build and load the port's CUDA kernels.

Every ``robseg_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, ``robseg_torch/_build/librobseg_<hash>.so`` (the
hash covers the sources and the flags, so an edited source rebuilds), which
is loaded with ``ctypes``. The build happens at the first launch of any
kernel, never at import: the CPU tests import every module on machines
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    for src in sorted(_sources() + headers):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"librobseg_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if this source state has no build yet; returns
    its path. The compiler's report (registers, shared memory, spills per
    kernel) is kept beside it as ``<lib>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory, then rename: concurrent processes
    # never see a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                for _, _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            log.append(f"$ {' '.join(cmd)}\n{out}")
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{p.stdout}\n{p.stderr}")
        with open(path + ".log", "w") as f:
            f.write("\n".join(log))
        os.replace(lib, path)
    return path


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types (every pointer and the stream as
# c_void_p: a bare Python int would be truncated to 32 bits)
_SIGNATURES = {
    "robseg_apgd_linf_step": [_P] * 6 + [_I64, _I64, _F, _F, _F, _P],
    "robseg_confusion": [_P, _P, _P, _I64, _I64, _I, _I64, _I, _P],
    "robseg_convnext_block_supported": [_I],
    "robseg_convnext_block_scratch": [_I] * 5,
    "robseg_convnext_block_fwd": [_P] * 12 + [_I] * 7 + [_P],
    "robseg_convnext_block_dx": [_P] * 12 + [_I] * 7 + [_P],
    "robseg_fpn_fwd": [_P] * 4 + [_I] + [_P] * 5 + [_I] * 8 + [_P],
    "robseg_fpn_dx": [_P] * 9 + [_I] * 9 + [_P],
    "robseg_convnext_mlp_supported": [_I],
    "robseg_convnext_mlp_scratch": [_I64] + [_I] * 4,
    "robseg_convnext_mlp_fwd": [_P] * 11 + [_I64, _I, _I, _P],
    "robseg_convnext_mlp_dx": [_P] * 11 + [_I64, _I, _I, _P],
}


_RESTYPES = {"robseg_convnext_block_scratch": _I64,
             "robseg_convnext_mlp_scratch": _I64}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` after the launches)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
