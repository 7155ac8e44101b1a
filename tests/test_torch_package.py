"""The PyTorch port's package boundary: it never imports jax, its
Options are the JAX package's less one named field, and its kernel
modules import (and run their plain versions) without nvcc or a GPU."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import super4pcs_tpu
import super4pcs_tpu_torch
from super4pcs_tpu import options as jax_options
from super4pcs_tpu import sequence as jax_sequence
from super4pcs_tpu_torch import options as torch_options
from super4pcs_tpu_torch import sequence as torch_sequence
from super4pcs_tpu_torch.kernels import _build, lcp as k1, rowcap as k2

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "super4pcs_tpu_torch"


def test_import_leaves_jax_out():
    """A fresh interpreter importing the port (all of its modules) has
    no jax in sys.modules."""
    code = ("import sys, super4pcs_tpu_torch, "
            "super4pcs_tpu_torch.kernels._build, super4pcs_tpu_torch.cli, "
            "super4pcs_tpu_torch.io, super4pcs_tpu_torch.io.native, "
            "super4pcs_tpu_torch.ops.healpix; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'super4pcs_tpu.')) or m == 'super4pcs_tpu'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_jax_import_in_sources():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax")
                        or s.startswith("from jax")
                        or s.startswith("import super4pcs_tpu ")
                        or s.startswith("from super4pcs_tpu ")
                        or s.startswith("from super4pcs_tpu.")), \
                f"{path}: {line}"


#: JAX fields the port leaves out. ``steps_per_dispatch``: the JAX
#: package's fused K-step dispatch answers XLA's per-dispatch cost; the
#: port replays its step as one CUDA graph, which already removed that
#: cost, and its fused dispatch never beat one step a dispatch.
_JAX_ONLY_FIELDS = {"steps_per_dispatch"}


def shared_fields(opts) -> dict:
    """A JAX ``Options``'s fields as a dict, less the JAX-only ones."""
    return {k: v for k, v in dataclasses.asdict(opts).items()
            if k not in _JAX_ONLY_FIELDS}


def test_options_match_jax_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jax_options.Options)}
    tf = {f.name: f.default
          for f in dataclasses.fields(torch_options.Options)}
    assert set(jf) - set(tf) == _JAX_ONLY_FIELDS
    assert {k: v for k, v in jf.items() if k not in _JAX_ONLY_FIELDS} == tf
    for name in ("MT19937_DEFAULT_SEED", "K_NUMBER_OF_DIAMETER_TRIALS",
                 "K_LARGE_NUMBER", "DISTANCE_FACTOR"):
        assert getattr(jax_options, name) == getattr(torch_options, name)


@pytest.mark.parametrize("kw", [
    dict(delta=0.0), dict(sample_size=3), dict(search_delta_factor=0.5),
    dict(search_escalation_factor=-1.0), dict(search_escalation_stages=-1),
    dict(direction_bins="x"), dict(pair_engine="x"),
    dict(pair_engine="allpairs"), dict(rowcap_kernel="x"),
    dict(terminate_threshold=0.1),
])
def test_options_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jax_options.Options(**kw)
    with pytest.raises(ValueError):
        torch_options.Options(**kw)


def test_configure_overlap_matches_jax():
    a = jax_options.Options().configure_overlap(0.7, 0.8)
    b = torch_options.Options().configure_overlap(0.7, 0.8)
    assert shared_fields(a) == dataclasses.asdict(b)
    with pytest.raises(ValueError):
        torch_options.Options().configure_overlap(0.8, 0.5)


def test_public_names():
    """The JAX package's public names, plus the resume-state
    converter."""
    assert (set(super4pcs_tpu_torch.__all__)
            == set(super4pcs_tpu.__all__) | {"state_from_jax"})
    for name in super4pcs_tpu_torch.__all__:
        assert hasattr(super4pcs_tpu_torch, name)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_wrappers_run_plain_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-1, 1, (50, 3)), dtype=torch.float32)
    p = torch.as_tensor(rng.uniform(-1, 1, (70, 3)), dtype=torch.float32)
    tr = torch.eye(4).repeat(3, 1, 1)
    n1, n2 = k1.lcp_min_d2.launches, k2.rowcap_capture.launches
    d2 = k1.lcp_min_d2(tr, q, p)
    ref = ((q[:, None] - p[None]) ** 2).sum(-1).min(1).values
    torch.testing.assert_close(d2[0], ref, rtol=0, atol=1e-6)
    cols, rc = k2.rowcap_capture(q, 0.1, 0.5, k2.slots_for(50, 8))
    assert cols.shape == (2048, 8) and rc.shape == (2048,)
    assert (k1.lcp_min_d2.launches, k2.rowcap_capture.launches) == (n1, n2)


def test_kernel_wrappers_refuse_other_devices():
    """Off the CPU the wrappers launch the kernel or raise: a device
    that is neither CPU nor CUDA raises, nothing falls back."""
    q = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError):
        k1.lcp_min_d2(torch.zeros((1, 4, 4), device="meta"), q, q)
    with pytest.raises(ValueError):
        k2.rowcap_capture(q, 0.1, 0.5, k2.slots_for(8, 4))
    with pytest.raises(ValueError):
        k1.lcp_min_d2(torch.zeros((1, 4, 4)), torch.zeros((8, 2)),
                      torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        k2.rowcap_capture(torch.zeros((8, 3)), 0.1, 0.5, 5)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_sequence_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for _ in range(5):
        a, b = (np.eye(4, dtype=np.float32) for _ in range(2))
        for m in (a, b):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            m[:3, :3] = q * np.sign(np.linalg.det(q))
            m[:3, 3] = rng.normal(size=3)
        assert (torch_sequence.reference_pose_diff(a, b)
                == jax_sequence.reference_pose_diff(a, b))
    conf = tmp_path / "s.conf"
    conf.write_text("camera 0 0 0 0 0 0 1\n"
                    "bmesh a.ply 0.1 0.2 0.3 0.1 0.2 0.3 0.9\n"
                    "bmesh b.ply 0 0 0 0 0 0 1\n")
    fj, tj = jax_sequence.parse_stanford_conf(str(conf))
    ft, tt = torch_sequence.parse_stanford_conf(str(conf))
    assert fj == ft
    np.testing.assert_array_equal(np.stack(tj), np.stack(tt))
