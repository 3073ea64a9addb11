"""Build and load the port's CUDA kernels: nvcc into one shared library
with a plain C interface, loaded with ctypes.

At first CUDA use every ``csrc/*.cu`` is compiled for ``sm_90a`` (one nvcc
process per source, all started together), the objects are linked into
``build/torch_kernels/lib<hash>.so`` at the repository root, and the
library is loaded with ``ctypes``.  The hash covers the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.  The
library is written through a temporary directory and an atomic rename, so
concurrent processes never load a half-written file.  ``-Xptxas -v``
reports each kernel's registers, shared memory and spills; the report is
kept beside the library (``build_log()``).

This route needs no ninja and includes no PyTorch header, so a build takes
seconds.  A missing nvcc or a failed build raises; nothing here falls back
to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
REPO_ROOT = _PKG_DIR.parents[1]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "of paddle_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it already exists; returns its
    path.  Raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_so,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log_tmp = os.path.join(tmp, "build.log")
        with open(log_tmp, "w") as f:
            f.write("\n".join(logs))
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp_so, out)
    return out


def build_log() -> str:
    """nvcc's report (``-Xptxas -v``) of the last build of this source
    set, or "" when the library was not built here."""
    p = library_path().with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
    return _lib


def bind(name: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument and result types
    declared.  A launching entry returns the cudaError_t of its launches as
    an int; a sizing entry (``*_workspace``) returns bytes as a long long."""
    fn = getattr(load(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
