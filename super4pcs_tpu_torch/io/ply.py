"""PLY point-cloud reader/writer.

The port's copy of ``super4pcs_tpu.io.ply``: the native C++ parser
(io/native.py) reads a file when its library is loaded and it takes the
file, the numpy parser otherwise (e.g. an element declared before
``vertex``), with the same results. Follows the reference parser
contract (ref:src/super4pcs/io/io_ply.h,
ref:doc/File-formats.md): ASCII and binary (both endiannesses) input,
the supported property lists being position [+ normals] [+ uchar RGB(A)
colors]; ASCII additionally accepts double properties. Output is binary
little-endian with the same header the reference emits
(ref:io/io.cc:328-405).
"""

from __future__ import annotations

import numpy as np

from ..cloud import PointCloud

_NP_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def _parse_header(f):
    """Parse the PLY header; returns (fmt, elements, header_size).
    ``elements`` is the ordered list of (name, count, props) with props
    the raw token tuples after 'property' (so list properties keep
    their full declaration)."""
    magic = f.readline()
    if magic.strip() not in (b"ply", b"PLY"):
        raise ValueError("(PLY) not a PLY file")
    fmt = None
    elements = []
    props = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("(PLY) unexpected end of header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == "format":
            fmt = tokens[1]
        elif key == "element":
            props = []
            elements.append((tokens[1], int(tokens[2]), props))
        elif key == "property" and props is not None:
            props.append(tuple(tokens[1:]))
        elif key == "end_header":
            break
    return fmt, elements, f.tell()


def _skip_elements(f, fmt, elements):
    """Advance past non-vertex elements declared before the vertex
    block (e.g. a camera element). ASCII rows are lines; binary strides
    are computable only for non-list properties — a binary list element
    before the vertices is an error, not silent garbage."""
    for name, count, eprops in elements:
        if count <= 0:
            continue
        if fmt == "ascii":
            for _ in range(count):
                f.readline()
        else:
            if any(p[0] == "list" for p in eprops):
                raise ValueError(
                    f"(PLY) cannot skip binary list element '{name}' "
                    "declared before the vertex element")
            stride = sum(np.dtype(_NP_TYPES[p[0]]).itemsize
                         for p in eprops)
            f.seek(stride * count, 1)


def read_ply(path: str) -> PointCloud:
    # native C++ fast path (io/native.py); the numpy parser below is the
    # reference implementation of the same contract
    from .native import native_parse_ply
    parsed = native_parse_ply(path)
    if parsed is not None:
        pos, nrm, rgb = parsed
        return PointCloud(pos=pos, normal=nrm, rgb=rgb)
    with open(path, "rb") as f:
        fmt, elements, _ = _parse_header(f)
        vi = next((i for i, e in enumerate(elements)
                   if e[0] == "vertex"), None)
        if vi is None:
            raise ValueError("(PLY) no vertex element")
        n = elements[vi][1]
        if any(p[0] == "list" for p in elements[vi][2]):
            raise ValueError("(PLY) list property on vertex element")
        props = [(p[0], p[1]) for p in elements[vi][2]]
        _skip_elements(f, fmt, elements[:vi])

        names = [p[1] for p in props]
        if not all(c in names for c in ("x", "y", "z")):
            raise ValueError("(PLY) missing x/y/z vertex properties")

        if fmt == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            if body.shape[0] != n:
                raise ValueError(
                    f"(PLY) header declares {n} vertices, body has "
                    f"{body.shape[0]}")
            if body.shape[1] < len(props):
                raise ValueError("(PLY) fewer columns than properties")
            cols = {nm: body[:, i] for i, (_, nm) in enumerate(props)}
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            endian = "<" if fmt == "binary_little_endian" else ">"
            dtype = np.dtype(
                [(nm, endian + _NP_TYPES[t]) for t, nm in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype,
                                count=n)
            cols = {nm: raw[nm].astype(np.float64) for _, nm in props}
        else:
            raise ValueError(f"(PLY) no support for this PLY format: {fmt}")

    pos = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    normal = None
    if all(c in cols for c in ("nx", "ny", "nz")):
        normal = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1)
    rgb = None
    if all(c in cols for c in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
    return PointCloud(pos=pos, normal=normal, rgb=rgb)


def write_ply(path: str, cloud: PointCloud):
    """Binary little-endian writer with the reference header
    (ref:io/io.cc:328-405): normals written when present, uchar colors
    when any point has a valid color."""
    n = len(cloud)
    use_normals = cloud.normal is not None
    use_colors = cloud.rgb is not None and bool(cloud.has_color().any())

    header = ["ply", "format binary_little_endian 1.0",
              "comment super4pcs_tpu output file",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if use_normals:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if use_colors:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if use_normals:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if use_colors:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = cloud.pos.T
    if use_normals:
        rec["nx"], rec["ny"], rec["nz"] = cloud.normal.T
    if use_colors:
        rgb = np.clip(cloud.rgb, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = rgb.T

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
