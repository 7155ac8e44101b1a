"""The port's ``super4pcs-torch`` CLI against the JAX package's
``super4pcs``: the same flag parsing, typed ``--tpu-opts``, Options,
printed usage and exit codes for a table of command lines; one small
end-to-end run on the CPU that writes a Polyworks matrix and the
registered geometry; and the CUDA default, which fails loudly (exit -2
with the error) where there is no card."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from super4pcs_tpu import cli as jcli
from super4pcs_tpu_torch import cli as tcli
from super4pcs_tpu_torch import io as tio
from super4pcs_tpu_torch.cloud import PointCloud
from super4pcs_tpu_torch.sequence import reference_pose_diff

from _torch_threads import one_torch_thread_per_worker  # noqa: F401
from test_torch_package import shared_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clouds(tmp_path):
    """A 100-point bumpy sphere and a rigidly moved copy as PLY files
    (``q = R^T (p - t)``), and the q -> p pose."""
    rng = np.random.default_rng(42)
    v = rng.normal(size=(100, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.3 * np.sin(5 * v[:, 0]) + 0.2 * np.sin(4 * v[:, 2])
    pos = (v * bump[:, None]).astype(np.float32)
    ang = 0.8
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    # |shift|^2 < 0.1: the reference's trDiff is |t_est . t_gt|
    shift = np.float32([0.1, 0.05, -0.2])
    q = (pos - shift) @ rot
    p1, p2 = str(tmp_path / "p.ply"), str(tmp_path / "q.ply")
    tio.write_ply(p1, PointCloud(pos=pos))
    tio.write_ply(p2, PointCloud(pos=q))
    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = shift
    return p1, p2, pos, gt


_ARGV = [
    ["s", "-i", "a.ply", "b.ply"],
    ["s", "-i", "a.ply", "b.ply", "-o", "0.7", "-d", "0.01", "-n", "8192",
     "-t", "3", "-m", "m.txt", "-r", "out.ply"],
    ["s", "-i", "a.obj", "b.obj", "-x", "-a", "20", "-c", "60",
     "--sampled1", "s1.ply", "--sampled2", "s2.ply"],
    ["s", "-i", "a.ply", "b.ply", "--tpu-opts",
     "bases_per_step=8,direction_bins=healpix,healpix_nside=8,"
     "join_q_budget=none,use_full_time_budget=1,cone_cos_tolerance=0.25"],
    ["s", "-i", "a.ply", "b.ply", "--bogus"],
    ["s", "-i", "a.ply", "b.ply", "-o", "abc"],
    ["s", "-i", "a.ply", "b.ply", "-n"],
    ["s", "-i", "a.ply", "b.ply", "--tpu-opts", "delta=1"],
    ["s", "-i", "a.ply", "b.ply", "--tpu-opts", "phase_timing=maybe"],
    ["s", "-i", "a.ply", "b.ply", "-h"],
    ["s", "-i", "a.ply"],
]


@pytest.mark.parametrize("argv", _ARGV, ids=range(len(_ARGV)))
def test_get_args_matches_jax(argv, capsys):
    """Return code, every parsed field and the printed lines."""
    ja, ta = jcli.Args(), tcli.Args()
    jrc = jcli.get_args(argv, ja)
    jerr = capsys.readouterr().err
    trc = tcli.get_args(argv, ta)
    assert trc == jrc
    assert vars(ta) == vars(ja)
    assert capsys.readouterr().err == jerr


@pytest.mark.parametrize("spec", [
    "bases_per_step=32, pair_row_cap=96,use_full_time_budget=true",
    "direction_bins=healpix,join_q_budget=none,cone_cos_tolerance=0.25",
    "bases_per_step=none", "random_seed=7,estimate_scale=0", "",
    "delta=1", "nope=3", "bases_per_step", "phase_timing=maybe",
    "refine_iterations=none", "max_pairs=1.5"])
def test_parse_tpu_opts_matches_jax(spec):
    # the port's CLI also takes the pair engine
    assert tcli.TPU_OPT_KEYS == jcli.TPU_OPT_KEYS | {"pair_engine"}
    try:
        want = jcli.parse_tpu_opts(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tcli.parse_tpu_opts(spec)
        return
    assert tcli.parse_tpu_opts(spec) == want


@pytest.mark.parametrize("argv", _ARGV[:4], ids=range(4))
def test_options_from_args_matches_jax(argv):
    ja, ta = jcli.Args(), tcli.Args()
    assert jcli.get_args(argv, ja) == tcli.get_args(argv, ta) == 0
    jo = jcli.options_from_args(ja, jcli.Logger())
    to = tcli.options_from_args(ta, tcli.Logger())
    assert dataclasses.asdict(to) == shared_fields(jo)


def _exit_argv(kind, p1, p2, tmp):
    return {
        "usage": ["s"],
        "usage_short": ["s", "-i", p1],
        "unknown_flag": ["s", "-i", p1, p2, "--bogus"],
        "bad_value": ["s", "-i", p1, p2, "-o", "abc"],
        "bad_tpu_opts": ["s", "-i", p1, p2, "--tpu-opts", "delta=1"],
        "help": ["s", "-i", p1, p2, "-h"],
        "missing_file": ["s", "-i", str(tmp / "none1.ply"),
                         str(tmp / "none2.ply"), "-m", str(tmp / "m")],
        "unsupported_ext": ["s", "-i", str(tmp / "a.stl"), p2, "-m",
                            str(tmp / "m")],
        "missing_second": ["s", "-i", p1, str(tmp / "none.ply"), "-m",
                           str(tmp / "m")],
        "bad_overlap": ["s", "-i", p1, p2, "-o", "1.5"],
        "bad_delta": ["s", "-i", p1, p2, "-d", "0"],
        "bad_option": ["s", "-i", p1, p2, "--tpu-opts",
                       "search_delta_factor=0.5"],
    }[kind]


@pytest.mark.parametrize("kind,rc", [
    ("usage", -2), ("usage_short", -2), ("unknown_flag", 0),
    ("bad_value", 0), ("bad_tpu_opts", 0), ("help", 1),
    ("missing_file", -1), ("unsupported_ext", -1), ("missing_second", -1),
    ("bad_overlap", -3), ("bad_delta", -3), ("bad_option", -3)])
def test_exit_codes_match_jax(clouds, tmp_path, capsys, kind, rc):
    """Paths that end before the registration: both packages return the
    same code and print the same lines."""
    p1, p2, _, _ = clouds
    argv = _exit_argv(kind, p1, p2, tmp_path)
    assert jcli.main(argv) == rc
    jout = capsys.readouterr()
    assert tcli.main(argv, device="cpu") == rc
    tout = capsys.readouterr()
    assert (tout.out, tout.err) == (jout.out, jout.err)


def _read_polyworks(path):
    lines = open(path).read().splitlines()
    assert lines[:2] == ["VERSION\t=\t1", "MATRIX\t="] and len(lines) == 6
    return np.array([[float(x) for x in ln.split()] for ln in lines[2:]])


@pytest.mark.parametrize("algo", ["super4pcs", "4pcs"])
def test_end_to_end_on_cpu(clouds, tmp_path, capsys, algo):
    """Matrix (Polyworks) and registered geometry from a CPU run: the
    matrix within rotDiff <= 0.2 / trDiff <= 0.1 of the known pose, the
    geometry on the target, and the sampled clouds exported."""
    p1, p2, pos, gt = clouds
    mat, geo = str(tmp_path / "m.txt"), str(tmp_path / "reg.ply")
    s1, s2 = str(tmp_path / "s1.ply"), str(tmp_path / "s2.ply")
    # -t 600: the trial estimate, not the machine's load, ends the run
    argv = ["super4pcs-torch", "-i", p1, p2, "-o", "0.9", "-d", "0.05",
            "-n", "100", "-t", "600", "-m", mat, "-r", geo,
            "--sampled1", s1, "--sampled2", s2,
            "--tpu-opts", "random_seed=3"]
    if algo == "4pcs":
        argv.insert(4, "-x")
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert ("Use old 4PCS" if algo == "4pcs" else "Use Super4PCS") in out
    assert re.search(r"Score: (\S+)", out)
    m = _read_polyworks(mat)
    rot_diff, tr_diff = reference_pose_diff(m, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1
    moved, mesh = tio.read_object(geo)
    assert mesh is None
    d2 = ((moved.pos[:, None] - pos[None]) ** 2).sum(-1).min(1)
    assert (np.sqrt(d2) < 0.05).mean() > 0.9
    for path in (s1, s2):
        c, _ = tio.read_object(path)
        assert 0 < len(c) <= 100


def test_estimate_scale_exits_minus_two(clouds, tmp_path, capsys):
    """``--tpu-opts estimate_scale=true`` runs similarity mode (the name
    is kept from when it exited -2): on Q shrunk by 1.25 the run exits 0
    and the Polyworks matrix carries the scale, its linear part s R
    within the pose gates once s is divided out."""
    p1, _, pos, gt = clouds
    s = 1.25
    q = (pos - gt[:3, 3]) @ gt[:3, :3] / s
    p2 = str(tmp_path / "q_scaled.ply")
    tio.write_ply(p2, PointCloud(pos=q.astype(np.float32)))
    mat = tmp_path / "m.txt"
    rc = tcli.main(["s", "-i", p1, p2, "-o", "0.9", "-d", "0.05", "-n",
                    "100", "-t", "600", "-m", str(mat), "--tpu-opts",
                    "estimate_scale=true,random_seed=21,bases_per_step=8,"
                    "max_pairs=4096,max_quads=2048,max_candidates=8192"],
                   device="cpu")
    assert rc == 0
    assert "Score: " in capsys.readouterr().out
    m = _read_polyworks(mat)
    est = np.linalg.norm(m[:3, :3], axis=0).mean()
    assert abs(est - s) < 0.05, est
    m[:3, :3] /= est
    rot_diff, tr_diff = reference_pose_diff(m, gt)
    assert rot_diff <= 0.2 and tr_diff <= 0.1


def test_default_device_without_a_card_fails_loudly(clouds, tmp_path,
                                                    capsys):
    """No device argument means the CUDA device: without one the run
    exits -2 with torch's CUDA error and writes nothing (it does not
    carry on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p1, p2, _, _ = clouds
    mat = tmp_path / "m.txt"
    assert tcli.main(["s", "-i", p1, p2, "-m", str(mat)]) == -2
    err = capsys.readouterr().err
    assert "[Error]: " in err and "CUDA" in err
    assert not mat.exists()


def test_console_script_and_module_entry():
    """pyproject declares ``super4pcs-torch`` at ``cli:main``, and
    ``python -m super4pcs_tpu_torch.cli`` runs it (usage: exit -2)."""
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert re.search(r'^super4pcs-torch\s*=\s*"super4pcs_tpu_torch\.cli:'
                     r'main"', text, re.M)
    out = subprocess.run([sys.executable, "-m", "super4pcs_tpu_torch.cli"],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == (-2) & 0xFF
    assert "Usage: " in out.stderr
