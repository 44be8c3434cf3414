"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
``ctypes``.  Libraries go to ``stargcn_tpu_torch/_build/`` (git-ignored),
named by a hash of the source, the headers beside it (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is.  Several sources build in
parallel, one ``nvcc`` each.  Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (C function, ctypes argtypes) for every kernel library.
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    "bit_expand": ("bit_expand_matmul_launch",
                   [_P, _P, _I, _P, _I, _I, _I, _I, _P]),
    "bit_reduce": ("bit_reduce_matmul_launch",
                   [_P, _P, _I, _P, _I, _I, _I, _I, _L, _L, _P]),
}

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernel libraries (default: all) that are not
    built yet, one ``nvcc`` per source, all started together.  Returns
    ``{name: path}``; raises with the compiler's output if one fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not _target(n).exists() for n in names) else None
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str):
    """The C function of kernel library ``name``, building it first if
    needed; ``argtypes`` and ``restype`` are set."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = (lib, fn)
        return _libs[name][1]
