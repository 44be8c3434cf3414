"""Build and load the port's host graph kernels (``csrc/graph_kernels.cpp``).

The C++/OpenMP extension is compiled at first use with the ``g++`` on
``PATH`` (``CXX`` is not read: a machine may point it at a compiler without
OpenMP) into ``stargcn_tpu_torch/_build/`` (git-ignored), named by a hash of
the source, the flags and the host (machine, node name, Python and numpy
versions), so an edited source or another host builds anew and an unchanged
one is loaded as it is.  The compiler writes a temporary file that is then
renamed into place, under a file lock, so concurrent processes (test
workers) build once and never load half a file.  Nothing is built when the
package is imported.

A failed build or load raises ``RuntimeError`` with the compiler's output:
no caller falls back to numpy.  The flags leave out ``-march=native``, so
one build runs on any x86-64 host.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import platform
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
MODULE_NAME = "_torch_graph_kernels"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]

_lock = threading.Lock()
_module = None


def _includes() -> list:
    import numpy as np

    return [sysconfig.get_paths()["include"], np.get_include()]


def target() -> Path:
    """The library's path for this source, these flags and this host."""
    import numpy as np

    key = b"\0".join([
        SOURCE.read_bytes(), " ".join([CXX, *CXX_FLAGS]).encode(),
        platform.machine().encode(), platform.node().encode(),
        sys.version.encode(), np.__version__.encode()])
    digest = hashlib.sha1(key).hexdigest()[:12]
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    return BUILD_DIR / f"{MODULE_NAME}-{digest}{suffix}"


def build() -> Path:
    """Compile the extension unless this host's build is there; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{MODULE_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():                   # another process built it
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, *[f"-I{d}" for d in _includes()],
               str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"building {SOURCE.name} failed: cannot run {cmd[0]!r} "
                f"({e})") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {SOURCE.name} failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load():
    """The extension module, built first where needed; cached per process."""
    global _module
    with _lock:
        if _module is None:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
            try:
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
            except ImportError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            _module = module
        return _module


def loaded() -> bool:
    """Whether this process has loaded the extension."""
    return _module is not None
