"""The plain reference against brute forces at tiny sizes."""

import numpy as np
import pytest
import torch

from reference import lcp as ref


def _brute_lcp(transform, q, p, delta):
    moved = q.astype(np.float64) @ transform[:3, :3].T + transform[:3, 3]
    d2 = ((moved[:, None, :] - p[None].astype(np.float64)) ** 2).sum(-1)
    return float((d2.min(axis=1) <= float(np.float32(delta)) ** 2).mean())


def _brute_voxels(pos, voxel):
    seen, keep = set(), []
    for i, p in enumerate(pos.astype(np.float64)):
        key = tuple(np.floor(p / voxel).astype(np.int64))
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return np.asarray(keep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcp_equals_a_numpy_brute_force(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    q = (p[:200] + rng.normal(scale=0.02, size=(200, 3))).astype(np.float32)
    t = np.eye(4)
    t[:3, 3] = rng.normal(scale=0.01, size=3)
    for delta in (0.01, 0.03, 0.1):
        assert ref.lcp(t, q, p, delta, block=64) == _brute_lcp(t, q, p,
                                                               delta)


def test_voxels_keep_the_first_point_of_each_voxel():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    pos[1000:1100] = pos[:100]          # repeats land in taken voxels
    for voxel in (0.05, 0.2, 1.0):
        assert np.array_equal(ref.voxel_first(pos, voxel),
                              _brute_voxels(pos, voxel))


def test_samples_draw_one_generator_pair_after_pair():
    rng = np.random.default_rng(5)
    pairs = [dict(target=rng.uniform(-1, 1, (900, 3)).astype(np.float32),
                  source=rng.uniform(-1, 1, (900, 3)).astype(np.float32))
             for _ in range(3)]
    got = ref.samples(pairs, 0.02, 100, 7)
    draw = np.random.default_rng(7)
    for i, pair in enumerate(pairs):
        kept = pair["source"][_brute_voxels(pair["source"], 0.02)]
        want = kept[draw.permutation(len(kept))[:100]]
        assert np.array_equal(got[i][1], want)
        assert np.array_equal(got[i][0],
                              pair["target"][_brute_voxels(pair["target"],
                                                           0.02)])


def test_pose_errors():
    t = np.eye(4)
    assert ref.pose_errors(t, t) == (0.0, 0.0)
    c, s = np.cos(0.1), np.sin(0.1)
    r = np.eye(4)
    r[:2, :2] = [[c, -s], [s, c]]
    r[:3, 3] = [0.03, 0.04, 0.0]
    rot, tr = ref.pose_errors(r, t)
    assert abs(tr - 0.05) < 1e-12
    # |1 - cos(0.05)| + |sin(0.05)|
    assert abs(rot - (1 - np.cos(0.05) + np.sin(0.05))) < 1e-9
    # the quaternion's sign does not matter, nor the angle's branch
    big = np.eye(4)
    big[:3, :3] = -np.eye(3) + 2 * np.outer([0, 0, 1], [0, 0, 1])
    assert ref.pose_errors(big, big)[0] < 1e-12


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.14159265,
                      1e-3], dtype=torch.float32)
    y = ref.tf32(x)
    bits = y.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    assert (abs(y - x) <= abs(x) * 2 ** -11).all()
    assert y[2] == 1.0 and y[1] == 1.0 + 2 ** -10


def test_the_control_lands_away_from_the_reference():
    # a 1/1000 scale of a scan: TF32's rounding of the products moves
    # the squared distances by far more than delta^2
    rng = np.random.default_rng(6)
    p = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    q = (p[:1000] + rng.normal(scale=0.004, size=(1000, 3))).astype(
        np.float32)
    t = np.eye(4)
    exact = ref.lcp(t, q, p, 0.01)
    low = ref.lcp(t, q, p, 0.01, precision="tf32")
    assert exact == _brute_lcp(t, q, p, 0.01)
    assert abs(low - exact) > 0.05
