"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library at first use, then loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go
to ``super4pcs_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing here runs at import time: the CPU
path of every wrapper never reaches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# IEEE division and no FMA contraction: the kernels' float results must
# match their plain PyTorch versions bit for bit (see the .cu notes).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")

_lock = threading.Lock()
#: one lock per kernel, so that two kernels build at once (in threads)
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per kernel
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """``nvcc`` from PyTorch's CUDA_HOME, else from PATH; raises if
    neither has one."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin or PATH): the CUDA kernels of "
        "super4pcs_tpu_torch are built from csrc/ at first use")


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, compiling it
    first when no build of this exact source exists. Different kernels
    may be loaded from several threads at once; each runs its own
    ``nvcc``."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"{name}-{digest[:16]}.so"
        log_file = out.with_suffix(".log")
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):"
                    f"\n{proc.stdout}\n{proc.stderr}")
            log_file.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        build_logs[name] = (log_file.read_text()
                            if log_file.exists() else "")
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
