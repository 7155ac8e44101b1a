"""File IO of the PyTorch port against the JAX package: the same files
read by both give equal arrays (exactly: both parse with numpy), files
written by each read back identically through the other, the Polyworks
matrix text is equal byte for byte, and malformed input raises in both.

The JAX package's numpy parser tier is forced here (its native C++ tier
is held to it by tests/test_io.py); the port has only that tier.
"""

import os

import numpy as np
import pytest

from super4pcs_tpu import io as jio
from super4pcs_tpu.cloud import PointCloud as JCloud
from super4pcs_tpu.io import native as jnative
from super4pcs_tpu_torch import io as tio
from super4pcs_tpu_torch.cloud import PointCloud as TCloud


@pytest.fixture(autouse=True)
def jax_numpy_parsers(monkeypatch):
    monkeypatch.setenv("SUPER4PCS_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)


def _same_cloud(a, b):
    np.testing.assert_array_equal(a.pos, b.pos)
    for k in ("normal", "rgb"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _same_mesh(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for k in ("tris", "tri_tex", "tri_norm", "tex_coords"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.mtls == b.mtls


def _read_both(path):
    (jc, jm), (tc, tm) = jio.read_object(path), tio.read_object(path)
    _same_cloud(jc, tc)
    _same_mesh(jm, tm)
    return tc, tm


def _arrays(rng, n, normals, colors):
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rgb = None
    if normals:
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    if colors:
        rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    return pos, nrm, rgb


# ------------------------------------------------------------------- PLY

def _ply_header(fmt, n, props, pre=""):
    lines = ["ply", f"format {fmt} 1.0", pre.rstrip("\n"),
             f"element vertex {n}"]
    lines += [f"property {t} {nm}" for t, nm in props]
    return "\n".join(x for x in lines if x) + "\nend_header\n"


_PROPS = [("float", "x"), ("float", "y"), ("float", "z"),
          ("float", "nx"), ("float", "ny"), ("float", "nz"),
          ("uchar", "red"), ("uchar", "green"), ("uchar", "blue"),
          ("uchar", "alpha")]


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
@pytest.mark.parametrize("camera", [False, True])
def test_ply_read_matches_jax(tmp_path, rng, fmt, camera):
    """Positions, normals and RGBA colors (alpha ignored), with and
    without a camera element declared before the vertices."""
    pos, nrm, rgb = _arrays(rng, 40, True, True)
    pre = ("element camera 1\nproperty float view_px\n"
           "property float view_py\n" if camera else "")
    head = _ply_header(fmt, 40, _PROPS, pre).encode()
    alpha = np.full((40, 1), 255.0)
    if fmt == "ascii":
        rows = np.hstack([pos, nrm, rgb, alpha])
        body = ("9 9\n" if camera else "") + "".join(
            " ".join(f"{v:.9g}" for v in r) + "\n" for r in rows)
        data = head + body.encode()
    else:
        e = "<" if fmt == "binary_little_endian" else ">"
        rec = np.zeros(40, np.dtype([(nm, e + ("f4" if t == "float"
                                                 else "u1"))
                                     for t, nm in _PROPS]))
        for i, nm in enumerate("x y z nx ny nz red green blue".split()):
            rec[nm] = np.hstack([pos, nrm, rgb])[:, i]
        rec["alpha"] = 255
        cam = np.asarray([9, 9], e + "f4").tobytes() if camera else b""
        data = head + cam + rec.tobytes()
    path = tmp_path / "c.ply"
    path.write_bytes(data)
    c, mesh = _read_both(str(path))
    assert mesh is None
    np.testing.assert_allclose(c.pos, pos, atol=1e-6)
    np.testing.assert_allclose(c.normal, nrm, atol=1e-6)
    np.testing.assert_array_equal(c.rgb, rgb)


@pytest.mark.parametrize("normals,colors", [(False, False), (True, False),
                                            (True, True)])
def test_ply_written_by_each_reads_back_through_the_other(
        tmp_path, rng, normals, colors):
    pos, nrm, rgb = _arrays(rng, 60, normals, colors)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jio.write_ply(jp, JCloud(pos=pos, normal=nrm, rgb=rgb))
    tio.write_ply(tp, TCloud(pos=pos, normal=nrm, rgb=rgb))
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for path in (jp, tp):
        c, _ = _read_both(path)
        np.testing.assert_array_equal(c.pos, pos)


@pytest.mark.parametrize("case", ["truncated_ascii", "truncated_binary",
                                  "binary_list_before_vertex", "no_xyz",
                                  "not_ply", "vertex_list"])
def test_ply_malformed_raises_in_both(tmp_path, case):
    head_xyz = [("float", "x"), ("float", "y"), ("float", "z")]
    if case == "truncated_ascii":
        data = (_ply_header("ascii", 10, head_xyz)
                + "0 0 0\n1 1 1\n2 2 2\n").encode()
    elif case == "truncated_binary":
        data = (_ply_header("binary_little_endian", 10, head_xyz).encode()
                + np.zeros((3, 3), "<f4").tobytes())
    elif case == "binary_list_before_vertex":
        pre = ("element face 1\n"
               "property list uchar int vertex_indices\n")
        data = (_ply_header("binary_little_endian", 1, head_xyz, pre)
                .encode() + b"\x03" + np.zeros(6, "<i4").tobytes())
    elif case == "no_xyz":
        data = (_ply_header("ascii", 1, head_xyz[:2]) + "0 0\n").encode()
    elif case == "not_ply":
        data = b"obj\n"
    else:
        data = ("ply\nformat ascii 1.0\nelement vertex 1\n"
                "property list uchar int idx\nend_header\n1 0\n").encode()
    path = str(tmp_path / "bad.ply")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        jio.read_ply(path)
    with pytest.raises(ValueError):
        tio.read_ply(path)


# ------------------------------------------------------------------- OBJ

_OBJ_CASES = {
    # faces with a//n: normals bound onto vertices, last face wins
    # (vertex 1 is in both faces, bound to vn 3 by the second)
    "face_normals": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                     "vn 1 0 0\nvn 0 1 0\nvn 0 0 1\n"
                     "f 1//1 2//2 3//1\nf 1//3 3//3 4//2\n"),
    # mixed a//n and bare faces: bare faces bind nothing
    "mixed": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 0\nv 1 0 1\n"
              "vn 1 0 0\nvn 0 1 0\nvn 0 0 1\n"
              "f 1//1 2//2 3//3\nf 4 5 6\n"),
    # negative indices resolve against the counts at the face line
    "negative": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf -3//-1 -2//-1 "
                 "-1//-1\nv 2 2 2\nv 3 2 2\nv 2 3 2\nvn 1 0 0\n"
                 "f -3//-1 -2//-1 -1//-1\n"),
    # no faces: normals 1:1 with the vertices when the counts agree
    "faceless": ("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "vn 1 0 0\nvn 0 1 0\nvn 0 0 1\n"),
    # no faces, count mismatch: no normals
    "faceless_mismatch": "v 0 0 0\nv 1 0 0\nvn 1 0 0\n",
    # a/t/n with texcoords and a material library (no texture file)
    "textured": ("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "vt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\n"
                 "f 1/1/1 2/2/1 3/3/1\n"),
    # vertex colors after the position, extra tokens ignored
    "vertex_colors": "v 0 0 0 10 20 30\nv 1 0 0 40 50 60\nv 0 1 0\nf 1 2 3\n",
}


@pytest.mark.parametrize("name", sorted(_OBJ_CASES))
def test_obj_read_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_text(_OBJ_CASES[name])
    c, mesh = _read_both(str(path))
    if name == "face_normals":
        np.testing.assert_array_equal(
            c.normal, [[0, 0, 1], [0, 1, 0], [0, 0, 1], [0, 1, 0]])
    elif name == "mixed":
        np.testing.assert_array_equal(c.normal[3:], np.zeros((3, 3)))
    elif name == "negative":
        np.testing.assert_array_equal(mesh.tris, [[0, 1, 2], [3, 4, 5]])
        np.testing.assert_array_equal(mesh.tri_norm, [[0, 0, 0], [1, 1, 1]])
    elif name == "faceless":
        np.testing.assert_array_equal(c.normal, np.eye(3))
    elif name == "faceless_mismatch":
        assert c.normal is None


def test_obj_empty_raises_in_both(tmp_path):
    path = tmp_path / "empty.obj"
    path.write_text("# nothing\nvn 0 0 1\n")
    with pytest.raises(ValueError):
        jio.read_obj(str(path))
    with pytest.raises(ValueError):
        tio.read_obj(str(path))


@pytest.mark.parametrize("form", ["normals", "texcoords", "bare", "cloud"])
def test_obj_written_by_each_reads_back_through_the_other(
        tmp_path, rng, form):
    pos, nrm, rgb = _arrays(rng, 12, form != "bare", form == "cloud")
    tris = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]],
                    np.int32)
    kw = {}
    if form == "normals":
        kw = dict(tri_norm=tris)
    elif form == "texcoords":
        kw = dict(tri_tex=tris, tex_coords=rng.uniform(0, 1, (12, 2))
                  .astype(np.float32), mtls=["m.mtl"])
    meshes = ((jio.Mesh(tris=tris, **kw), tio.Mesh(tris=tris, **kw))
              if form != "cloud" else (None, None))
    jp, tp = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    jio.write_obj(jp, JCloud(pos=pos, normal=nrm, rgb=rgb), meshes[0])
    tio.write_obj(tp, TCloud(pos=pos, normal=nrm, rgb=rgb), meshes[1])
    assert open(jp).read() == open(tp).read()
    for path in (jp, tp):
        c, mesh = _read_both(path)
        np.testing.assert_allclose(c.pos, pos, atol=1e-5)
        if form != "cloud":
            np.testing.assert_array_equal(mesh.tris, tris)


# ------------------------------------------------- PTX, matrix, dispatch

@pytest.mark.parametrize("colors", [False, True])
def test_ptx_read_matches_jax(tmp_path, rng, colors):
    pos = rng.uniform(-1, 1, (6, 3))
    lines = ["3", "2"] + ["0 0 0"] * 8
    for p in pos:
        lines.append(f"{p[0]} {p[1]} {p[2]} 0.5"
                     + (" 10 20 30" if colors else ""))
    path = tmp_path / "scan.ptx"
    path.write_text("\n".join(lines) + "\n")
    c, _ = _read_both(str(path))
    np.testing.assert_allclose(c.pos, pos, atol=1e-6)
    assert (c.rgb is not None) == colors
    bad = tmp_path / "bad.ptx"
    bad.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError):
        jio.read_ptx(str(bad))
    with pytest.raises(ValueError):
        tio.read_ptx(str(bad))


def test_polyworks_matrix_strings_match_jax(tmp_path, rng):
    mats = [np.eye(4), -np.eye(4), np.zeros((4, 4)),
            rng.normal(scale=100.0, size=(4, 4)),
            rng.normal(size=(4, 4)).astype(np.float32)]
    mats[2][0, 1] = -0.0
    mats[2][1, 2] = -4e-7          # rounds to -0.000000
    for m in mats:
        assert (tio.format_polyworks_matrix(m)
                == jio.format_polyworks_matrix(m))
        jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
        assert jio.write_matrix(jp, m) and tio.write_matrix(tp, m)
        assert open(jp).read() == open(tp).read()
    assert (tio.write_matrix(tp, mats[0], mode="other")
            == jio.write_matrix(jp, mats[0], mode="other") is False)
    assert open(tp).read() == open(jp).read() == ""


@pytest.mark.parametrize("name", ["thing.xyz", "thing.ply", "thing.obj",
                                  "thing"])
def test_write_object_dispatch_matches_jax(tmp_path, rng, name):
    pos, nrm, _ = _arrays(rng, 6, True, False)
    tris = np.array([[0, 1, 2]], np.int32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for mesh_j, mesh_t in ((None, None),
                           (jio.Mesh(tris=tris), tio.Mesh(tris=tris)),
                           (jio.Mesh(tris=tris[:0]),
                            tio.Mesh(tris=tris[:0]))):
        jout = jio.write_object(str(tmp_path / "j" / name),
                                JCloud(pos=pos, normal=nrm), mesh_j)
        tout = tio.write_object(str(tmp_path / "t" / name),
                                TCloud(pos=pos, normal=nrm), mesh_t)
        assert os.path.basename(jout) == os.path.basename(tout)
        assert open(jout, "rb").read() == open(tout, "rb").read()


@pytest.mark.parametrize("name", ["x.stl", "x", "x.PLY.gz"])
def test_unsupported_extension_raises_in_both(tmp_path, name):
    with pytest.raises(ValueError):
        jio.read_object(str(tmp_path / name))
    with pytest.raises(ValueError):
        tio.read_object(str(tmp_path / name))


def test_uppercase_extension_reads_in_both(tmp_path, rng):
    pos, _, _ = _arrays(rng, 5, False, False)
    path = str(tmp_path / "UP.PLY")
    tio.write_ply(path, TCloud(pos=pos))
    c, _ = _read_both(path)
    np.testing.assert_array_equal(c.pos, pos)
