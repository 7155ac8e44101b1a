"""The port's native IO tier (``super4pcs_tpu_torch.io.native``, its own
copy of the C++ parsers built with g++ at first use) on the CPU:
tests/test_io.py's native-tier tests on the port's loader (parity with
the numpy parsers, negative OBJ indices, a truncated PLY body, an
element before ``vertex``), and the port's reads against the JAX
package's reads of the same files in both tiers."""

import shutil

import numpy as np
import pytest

from super4pcs_tpu import io as jio
from super4pcs_tpu.io import native as jnative
from super4pcs_tpu_torch import io as tio
from super4pcs_tpu_torch.cloud import PointCloud
from super4pcs_tpu_torch.io import Mesh, write_obj, write_ply
from super4pcs_tpu_torch.io import native
from super4pcs_tpu_torch.io import obj as obj_mod
from super4pcs_tpu_torch.io import ply as ply_mod

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the parsers")


@pytest.fixture
def numpy_tier(monkeypatch):
    """A function that forces both packages' numpy parsers from then
    on (the port reads ``SUPER4PCS_TPU_NO_NATIVE`` at every call; the
    JAX loader at its first, so its cache is cleared)."""
    def force():
        monkeypatch.setenv("SUPER4PCS_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", False)
    return force


def _cloud(rng, n=40, colors=True):
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rgb = (rng.integers(0, 256, (n, 3)).astype(np.float32) if colors
           else None)
    return PointCloud(pos=pos, normal=nrm, rgb=rgb)


def _same_cloud(a, b):
    np.testing.assert_array_equal(a.pos, b.pos)
    for k in ("normal", "rgb"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _files(tmp_path, rng):
    """An OBJ mesh with face normals, a binary PLY with normals and
    colors, and an ASCII PLY: {kind: path}."""
    c = _cloud(rng)
    tris = np.array([[0, 1, 2], [5, 6, 7], [9, 3, 4]], np.int32)
    paths = {k: str(tmp_path / name) for k, name in (
        ("obj", "m.obj"), ("ply-binary", "c.ply"), ("ply-ascii", "a.ply"))}
    write_obj(paths["obj"], c, Mesh(tris=tris, tri_norm=tris))
    write_ply(paths["ply-binary"], c)
    rows = "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in c.pos)
    with open(paths["ply-ascii"], "w") as fh:
        fh.write("ply\nformat ascii 1.0\nelement vertex "
                 f"{len(c)}\nproperty float x\nproperty float y\n"
                 f"property float z\nend_header\n{rows}")
    return paths


def test_library_builds_into_the_package(tmp_path):
    """g++ builds the port's own csrc/io_native.cpp into _build/, named
    by the hash of the source and flags; the library exports the C
    interface."""
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SRC.name == "io_native.cpp"
    assert native.SRC.parent.name == "csrc"
    for fn in ("parse_obj", "parse_ply", "s4p_free"):
        assert hasattr(lib, fn)


@pytest.mark.parametrize("kind", ["obj", "ply-binary", "ply-ascii"])
def test_native_parser_parity(tmp_path, rng, numpy_tier, kind):
    """The C++ parser and the numpy parser read the same clouds and
    meshes."""
    path = _files(tmp_path, rng)[kind]
    parse = (native.native_parse_obj if kind == "obj"
             else native.native_parse_ply)
    assert parse(path) is not None               # the native tier read it
    c_nat, m_nat = tio.read_object(path)
    numpy_tier()
    assert parse(path) is None
    c_py, m_py = tio.read_object(path)
    _same_cloud(c_nat, c_py)
    if kind == "obj":
        np.testing.assert_array_equal(m_nat.tris, m_py.tris)
        np.testing.assert_array_equal(m_nat.tri_norm, m_py.tri_norm)


def test_obj_negative_indices(tmp_path, numpy_tier):
    """Relative (negative) face indices resolve against the running
    vertex count, identically in both tiers."""
    path = tmp_path / "neg.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "f -3 -2 -1\n"
        "v 2 2 2\nv 3 2 2\nv 2 3 2\n"
        "f -3 -2 -1\n")
    expected = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    assert native.native_parse_obj(str(path)) is not None
    _, mesh_nat = obj_mod.read_obj(str(path))
    numpy_tier()
    _, mesh_py = obj_mod.read_obj(str(path))
    np.testing.assert_array_equal(mesh_nat.tris, expected)
    np.testing.assert_array_equal(mesh_py.tris, expected)


def test_ply_truncated_body_rejected(tmp_path, numpy_tier):
    """A PLY body shorter than its declared vertex count: the native
    parser bails, and the read fails loudly (never phantom points)."""
    path = tmp_path / "trunc.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 10\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
        "0 0 0\n1 1 1\n2 2 2\n")
    assert native.get_lib() is not None
    assert native.native_parse_ply(str(path)) is None
    with pytest.raises(ValueError):
        ply_mod.read_ply(str(path))
    numpy_tier()
    with pytest.raises(ValueError):
        ply_mod.read_ply(str(path))


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply_pre_vertex_element(tmp_path, fmt):
    """An element (a camera) declared before the vertex element is not
    read as vertex data: the native parser bails and the numpy parser
    skips its rows (ascii) or its stride (binary)."""
    path = tmp_path / f"cam-{fmt}.ply"
    if fmt == "ascii":
        path.write_text(
            "ply\nformat ascii 1.0\n"
            "element camera 1\n"
            "property float view_px\nproperty float view_py\n"
            "property float view_pz\n"
            "element vertex 3\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
            "9 9 9\n"
            "0 0 0\n1 0 0\n0 1 0\n")
        want = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    else:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            "element camera 1\n"
            "property float view_px\nproperty float view_py\n"
            "element vertex 2\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n")
        path.write_bytes(header.encode()
                         + np.asarray([9.0, 9.0], "<f4").tobytes()
                         + np.asarray([[1, 2, 3], [4, 5, 6]],
                                      "<f4").tobytes())
        want = [[1, 2, 3], [4, 5, 6]]
    assert native.get_lib() is not None
    assert native.native_parse_ply(str(path)) is None
    np.testing.assert_allclose(ply_mod.read_ply(str(path)).pos, want,
                               atol=0)


@pytest.mark.parametrize("tier", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["obj", "ply-binary", "ply-ascii"])
def test_reads_equal_jax_package(tmp_path, rng, numpy_tier, kind, tier):
    """The port's read of a file equals the JAX package's read of it,
    each package in the same tier: cloud and mesh, exactly."""
    path = _files(tmp_path, rng)[kind]
    if tier == "numpy":
        numpy_tier()
    else:
        assert native.get_lib() is not None
        assert jnative.get_lib() is not None
    (jc, jm), (tc, tm) = jio.read_object(path), tio.read_object(path)
    _same_cloud(jc, tc)
    assert (jm is None) == (tm is None)
    if tm is not None:
        for k in ("tris", "tri_tex", "tri_norm", "tex_coords"):
            x, y = getattr(jm, k), getattr(tm, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert jm.mtls == tm.mtls
