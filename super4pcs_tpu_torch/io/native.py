"""ctypes loader of the native C++ IO parsers (``csrc/io_native.cpp``).

The port's copy of ``super4pcs_tpu.io.native``, with the same functions
and C interface (``parse_obj``, ``parse_ply``, ``s4p_free``). The
reference's IO tier is C++ (ref:src/super4pcs/io/), and so is this one:
the port's own copy of the parser source is compiled with
``g++ -O2 -fPIC -shared -std=c++17`` at first use into
``super4pcs_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags as the CUDA kernels are
(kernels/_build.py), so an edited source is rebuilt and an unchanged one
reused. Nothing is read from or written to anywhere else.

``get_lib()`` is None while ``SUPER4PCS_TPU_NO_NATIVE`` is set, or
when no library can be built (no g++); the readers (io/obj.py,
io/ply.py) then use their numpy parsers, which give the same clouds,
only slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "io_native.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of this exact source and these flags lives."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"io_native-{digest[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.POINTER
    f32p, i32p = P(ctypes.c_float), P(ctypes.c_int32)
    i64p, charpp = P(ctypes.c_int64), P(ctypes.c_char_p)
    lib.s4p_free.argtypes = [ctypes.c_void_p]
    lib.s4p_free.restype = None
    lib.parse_obj.argtypes = [
        ctypes.c_char_p,
        P(f32p), i64p, P(f32p), i64p, P(f32p), i64p,
        P(i32p), i64p, charpp, i64p]
    lib.parse_obj.restype = ctypes.c_int
    lib.parse_ply.argtypes = [
        ctypes.c_char_p, P(f32p), P(f32p), P(f32p), i64p]
    lib.parse_ply.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None when
    unavailable (callers fall back to the numpy parsers)."""
    global _LIB, _TRIED
    if os.environ.get("SUPER4PCS_TPU_NO_NATIVE"):
        # read at every call: setting it forces the numpy parsers even
        # after the library was loaded
        return None
    with _lock:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        built = _build()
        if built is not None:
            try:
                _LIB = _bind(ctypes.CDLL(str(built)))
            except OSError:
                _LIB = None
        return _LIB


def _take_f32(lib, ptr, n, cols) -> Optional[np.ndarray]:
    if not ptr or n == 0:
        return None
    arr = np.ctypeslib.as_array(ptr, shape=(n, cols)).copy()
    lib.s4p_free(ptr)
    return arr


def native_parse_obj(path: str):
    """(pos, normals, texcoords, faces (F, 3, 3), mtls) or None (no
    library, or the parser bailed on the file)."""
    lib = get_lib()
    if lib is None:
        return None
    P = ctypes.POINTER
    v = P(ctypes.c_float)()
    vn = P(ctypes.c_float)()
    vt = P(ctypes.c_float)()
    f = P(ctypes.c_int32)()
    mtl = ctypes.c_char_p()
    nv = ctypes.c_int64()
    nvn = ctypes.c_int64()
    nvt = ctypes.c_int64()
    nf = ctypes.c_int64()
    nm = ctypes.c_int64()
    rc = lib.parse_obj(os.fsencode(path), ctypes.byref(v), ctypes.byref(nv),
                       ctypes.byref(vn), ctypes.byref(nvn),
                       ctypes.byref(vt), ctypes.byref(nvt),
                       ctypes.byref(f), ctypes.byref(nf),
                       ctypes.byref(mtl), ctypes.byref(nm))
    if rc != 0:
        return None
    pos = _take_f32(lib, v, nv.value, 3)
    normals = _take_f32(lib, vn, nvn.value, 3)
    tex = _take_f32(lib, vt, nvt.value, 2)
    faces = None
    if f and nf.value:
        faces = np.ctypeslib.as_array(f, shape=(nf.value, 3, 3)).copy()
        lib.s4p_free(f)
    mtls = []
    if mtl.value:
        mtls = mtl.value.decode(errors="replace").split("\n")
        lib.s4p_free(mtl)
    return pos, normals, tex, faces, mtls


def native_parse_ply(path: str):
    """(pos, normals, rgb) or None (no library, or the parser bailed on
    the file: e.g. an element declared before ``vertex``)."""
    lib = get_lib()
    if lib is None:
        return None
    P = ctypes.POINTER
    pos_p = P(ctypes.c_float)()
    nrm_p = P(ctypes.c_float)()
    rgb_p = P(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.parse_ply(os.fsencode(path), ctypes.byref(pos_p),
                       ctypes.byref(nrm_p), ctypes.byref(rgb_p),
                       ctypes.byref(n))
    if rc != 0:
        return None
    pos = _take_f32(lib, pos_p, n.value, 3)
    nrm = _take_f32(lib, nrm_p, n.value, 3)
    rgb = _take_f32(lib, rgb_p, n.value, 3)
    if pos is None:
        return None
    return pos, nrm, rgb
