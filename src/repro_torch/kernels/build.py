"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with :mod:`ctypes`.  Libraries go into ``_build/`` beside this file (a
directory the repository's ``.gitignore`` lists), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing here runs when the module is imported: the package must import on
machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library", "build_log"]

_HERE = Path(__file__).parent
SOURCES: Dict[str, Path] = {
    "hbp_spmv": _HERE / "csrc" / "hbp_spmv.cu",
    "hbp_partials": _HERE / "csrc" / "hbp_partials.cu",
}
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr, _int = ctypes.c_void_p, ctypes.c_int
# C signatures of the exported launchers: pointers and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int)
_SIGNATURES = {
    "hbp_spmv": {
        "hbp_spmv_fused_launch": [_ptr] * 11 + [_int] * 6 + [_ptr],
        "hbp_spmm_fused_launch": [_ptr] * 11 + [_int] * 7 + [_ptr],
        "hbp_spmm_fused_max_launch": [_ptr] * 11 + [_int] * 13 + [_ptr],
    },
    "hbp_partials": {
        "hbp_spmv_partials_launch": [_ptr] * 5 + [_int] * 11 + [_ptr],
        "hbp_spmm_partials_launch": [_ptr] * 5 + [_int] * 12 + [_ptr],
        "hbp_spmm_partials_max_launch": [_ptr] * 5 + [_int] * 12 + [_ptr],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the CUDA kernels are built from source at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + repr(NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when the library is already built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: concurrent builds
    # each install a complete library, last writer wins
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd


def _finish(name: str, started) -> None:
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every source not yet built, one ``nvcc`` per source, all
    started together; returns ``{name: compiler log}`` for every source
    (the ``-Xptxas -v`` register, shared-memory and spill lines)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, s in started.items():
            if s is not None:
                _finish(name, s)
    return {name: build_log(name) for name in SOURCES}


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` ("" if none)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]
