"""Host-side IO of the PyTorch port: PLY / OBJ / PTX readers, PLY / OBJ
/ matrix writers.

The port's copy of ``super4pcs_tpu.io`` (the reference ``IOManager``,
ref:src/super4pcs/io/io.h:34-109): the native C++ PLY and OBJ parsers
(io/native.py, built with g++ at first use) with numpy parsers beside
them, following the same property-list rules (ref:doc/File-formats.md);
no device involvement.
Extension dispatch mirrors ref:io/io.cc:19-41.
"""

from __future__ import annotations

import os

from .ply import read_ply, write_ply
from .obj import read_obj, write_obj, Mesh
from .ptx import read_ptx
from .matrix import write_matrix, format_polyworks_matrix
from ..cloud import PointCloud

__all__ = [
    "read_object", "write_object", "write_matrix",
    "read_ply", "write_ply", "read_obj", "write_obj", "read_ptx",
    "format_polyworks_matrix", "Mesh",
]


def read_object(path: str):
    """Read a cloud/mesh by extension (ref:io/io.cc:19-41).

    Returns (PointCloud, Mesh-or-None). Unsupported extensions raise
    ValueError (the reference prints and returns false).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path), None
    if ext == ".obj":
        return read_obj(path)
    if ext == ".ptx":
        return read_ptx(path), None
    raise ValueError(f"Unsupported file format: {path}")


def write_object(path: str, cloud: PointCloud, mesh=None):
    """Write by content: meshes go to OBJ, clouds to PLY, fixing the
    extension accordingly (ref:io/io.cc:273-302)."""
    root, ext = os.path.splitext(path)
    if mesh is not None and len(mesh.tris):
        out = root + ".obj" if ext else path + ".obj"
        write_obj(out, cloud, mesh)
    else:
        out = root + ".ply" if ext else path + ".ply"
        write_ply(out, cloud)
    return out
