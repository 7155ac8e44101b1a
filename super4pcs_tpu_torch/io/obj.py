"""Wavefront OBJ reader/writer.

The port's copy of ``super4pcs_tpu.io.obj``: the native C++ parser
(io/native.py) reads a file when its library is loaded, the python row
parser otherwise, with the same results. Mirrors the reference parser
semantics (ref:src/super4pcs/io/io.cc:140-267):
``v``/``vn``/``vt``/``f``/``mtllib`` records; face normals are bound
back onto vertices through the ``a//n`` (or ``a/t/n``) indices and the
per-vertex normal array is rebuilt 1:1 with the vertices
(ref:io.cc:200-218). Texture-to-vertex-color transfer (the reference's
optional OpenCV path, ref:io.cc:226-259) is gated on Pillow being
importable and otherwise skipped with a warning, matching the
``USE_OPENCV``-off behavior.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

from ..cloud import PointCloud


@dataclasses.dataclass
class Mesh:
    """Connectivity + attributes the registration itself ignores but the
    writers need to round-trip (the reference threads tex_coords/tris/
    mtls through every IO call, ref:io/io.h:47-66)."""
    tris: np.ndarray                      # (F, 3) int32 vertex ids (0-based)
    tri_tex: Optional[np.ndarray] = None  # (F, 3) int32 texcoord ids
    tri_norm: Optional[np.ndarray] = None  # (F, 3) int32 normal ids
    tex_coords: Optional[np.ndarray] = None  # (T, 2) float32
    mtls: List[str] = dataclasses.field(default_factory=list)


def _split_face_token(tok: str):
    """'a', 'a/t', 'a//n', 'a/t/n' -> (a, t, n) with 0 for absent."""
    parts = tok.split("/")
    a = int(parts[0])
    t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return a, t, n


def _read_obj_python(path: str):
    """Row parser: (pos, vn, vt, faces (F, 3, 3) of 1-based (v, t, n)
    ids with 0 for absent, mtls)."""
    v_rows, vn_rows, vt_rows = [], [], []
    f_rows = []
    mtls: List[str] = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line:
                continue
            c = line[0]
            if c == "v":
                if line.startswith("v "):
                    v_rows.append(line[2:].split())
                elif line.startswith("vn "):
                    vn_rows.append(line[3:].split())
                elif line.startswith("vt "):
                    vt_rows.append(line[3:].split())
            elif c == "f" and line.startswith("f "):
                # record running counts: negative indices are relative
                # to the counts at the face line (the OBJ spec)
                f_rows.append((line[2:].split(), len(v_rows),
                               len(vt_rows), len(vn_rows)))
            elif line.startswith("mtllib"):
                mtls.append(line[6:].strip())

    if not v_rows:
        raise ValueError(f"(OBJ) no vertices in {path}")

    pos = np.asarray([r[:3] for r in v_rows], dtype=np.float32)
    vn = (np.asarray([r[:3] for r in vn_rows], dtype=np.float32)
          if vn_rows else None)
    vt = (np.asarray([r[:2] for r in vt_rows], dtype=np.float32)
          if vt_rows else None)

    faces = np.zeros((len(f_rows), 3, 3), np.int32)
    for i, (row, nv, nt, nn) in enumerate(f_rows):
        for j in range(3):
            a, t, n = _split_face_token(row[j])
            if a < 0:
                a = nv + a + 1
            if t < 0:
                t = nt + t + 1
            if n < 0:
                n = nn + n + 1
            faces[i, j] = (a, t, n)
    return pos, vn, vt, faces, mtls


def read_obj(path: str):
    """Read an OBJ file; returns (PointCloud, Mesh).

    Uses the native C++ parser (io/native.py) when its library is
    loaded; the python row parser, with the same semantics, otherwise."""
    from .native import native_parse_obj
    parsed = native_parse_obj(path)
    if parsed is not None:
        pos, vn, vt, faces, mtls = parsed
        if pos is None:
            raise ValueError(f"(OBJ) no vertices in {path}")
        if faces is None:
            faces = np.zeros((0, 3, 3), np.int32)
    else:
        pos, vn, vt, faces, mtls = _read_obj_python(path)

    tris = faces[:, :, 0]
    tri_tex = faces[:, :, 1]
    tri_norm = faces[:, :, 2]

    normal = None
    if vn is not None:
        if len(faces) == 0:
            # no faces: 1:1 normals when counts line up (ref:io.cc:201-205)
            if len(vn) == len(pos):
                normal = vn
        elif tri_norm.any():
            # bind face normals onto vertices (ref:io.cc:189-193), last
            # face wins, then rebuild 1:1 (ref:io.cc:207-218). Faces
            # without a normal index (0 slot in a mixed file) must not
            # bind vn[0] to their vertices — scatter only where present.
            normal = np.zeros_like(pos)
            flat_v = tris.reshape(-1) - 1
            flat_n = tri_norm.reshape(-1)
            has_n = flat_n > 0
            normal[flat_v[has_n]] = \
                vn[np.clip(flat_n[has_n] - 1, 0, len(vn) - 1)]

    mesh = Mesh(
        tris=tris - 1,
        tri_tex=(tri_tex - 1) if tri_tex.any() else None,
        tri_norm=(tri_norm - 1) if tri_norm.any() else None,
        tex_coords=vt,
        mtls=mtls,
    )

    rgb = None
    if mtls and vt is not None:
        rgb = _texture_colors(path, mtls, mesh, len(pos))

    return PointCloud(pos=pos, normal=normal, rgb=rgb), mesh


def _texture_colors(obj_path, mtls, mesh, n_vertices):
    """Optional map_Kd texture -> vertex colors (ref:io.cc:226-259)."""
    base = os.path.dirname(obj_path)
    img_name = None
    try:
        with open(os.path.join(base, mtls[0])) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) == 2 and parts[0] == "map_Kd":
                    img_name = parts[1]
    except OSError:
        return None
    if img_name is None:
        return None
    try:
        from PIL import Image
        tex = np.asarray(Image.open(os.path.join(base, img_name)))
    except Exception:
        print("Pillow/OpenCV required to load material textures. "
              f"Skipping {img_name}", file=sys.stderr)
        return None
    h, w = tex.shape[:2]
    rgb = np.full((n_vertices, 3), -1.0, np.float32)
    if mesh.tri_tex is None or mesh.tex_coords is None:
        return None
    uv = mesh.tex_coords[np.clip(mesh.tri_tex, 0, len(mesh.tex_coords) - 1)]
    px = np.clip((uv[..., 0] * w).astype(int), 0, w - 1)
    py = np.clip((uv[..., 1] * h).astype(int), 0, h - 1)
    rgb[mesh.tris.reshape(-1)] = tex[py.reshape(-1), px.reshape(-1), :3]
    return rgb


def write_obj(path: str, cloud: PointCloud, mesh: Optional[Mesh] = None):
    """Write an OBJ file (ref:io.cc:407-456): vertices with optional
    trailing color, ``vn`` normals, ``vt`` texcoords, faces keeping the
    richest index form available."""
    mesh = mesh or Mesh(tris=np.zeros((0, 3), np.int32))
    with open(path, "w") as f:
        for m in mesh.mtls:
            f.write(f"mtllib {m}\n")
        rgb = cloud.rgb
        for i, p in enumerate(cloud.pos):
            f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}")
            if rgb is not None and rgb[i, 0] != 0 and rgb[i, 0] >= 0:
                f.write(f" {rgb[i, 0]:g} {rgb[i, 1]:g} {rgb[i, 2]:g}")
            f.write("\n")
        if cloud.normal is not None:
            for n in cloud.normal:
                f.write(f"vn {n[0]:g} {n[1]:g} {n[2]:g}\n")
        if mesh.tex_coords is not None:
            for t in mesh.tex_coords:
                f.write(f"vt {t[0]:g} {t[1]:g}\n")
        has_n = cloud.normal is not None and mesh.tri_norm is not None
        has_t = mesh.tex_coords is not None and mesh.tri_tex is not None
        for i, tri in enumerate(mesh.tris):
            a, b, c = (int(x) + 1 for x in tri)
            if has_t:
                t1, t2, t3 = (int(x) + 1 for x in mesh.tri_tex[i])
                f.write(f"f {a}/{t1} {b}/{t2} {c}/{t3}\n")
            elif has_n:
                # standard v//vn syntax; the reference writes 'a/n'
                # (texcoord slot, ref:io.cc:448-450) which its own
                # reader then misparses — not reproduced
                n1, n2, n3 = (int(x) + 1 for x in mesh.tri_norm[i])
                f.write(f"f {a}//{n1} {b}//{n2} {c}//{n3}\n")
            else:
                f.write(f"f {a} {b} {c}\n")
    return True
