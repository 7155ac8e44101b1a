"""The generator: the same seed gives the same clouds, and the views
overlap as the configuration says."""

import json
import os

import numpy as np
import pytest

import generate
from conftest import BENCH

SCAN = json.load(open(os.path.join(BENCH, "configs", "scan100k.json")))
RGBN = json.load(open(os.path.join(BENCH, "configs",
                                   "scan100k_rgbn.json")))


def _small(data, points=3000):
    return dict(data, model=dict(data["model"], points=points))


@pytest.mark.parametrize("data", [SCAN["data"], RGBN["data"]],
                         ids=["slab_views", "full_posed"])
def test_the_same_seed_gives_the_same_calls(data):
    traffic = dict(calls=2, pairs_per_call=2)
    a = generate.make_calls(_small(data), traffic, 2 ** 31 + 7)
    b = generate.make_calls(_small(data), traffic, 2 ** 31 + 7)
    c = generate.make_calls(_small(data), traffic, 2 ** 31 + 8)
    for x, y in zip(a, b):
        assert x["random_seed"] == y["random_seed"]
        for p, q in zip(x["pairs"], y["pairs"]):
            assert p.keys() == q.keys()
            for k in p:
                assert np.array_equal(p[k], q[k])
    assert not np.array_equal(a[0]["pairs"][0]["source"],
                              c[0]["pairs"][0]["source"])


def test_views_are_slabs_that_overlap_as_configured():
    data = _small(SCAN["data"])
    model = generate.bumped_sphere(**data["model"])
    x = model[:, 0]
    lo, extent = x.min(), x.max() - x.min()
    rng = np.random.default_rng(5)
    for _ in range(20):
        pair = generate.slab_views(model, data, rng)
        first, second = pair["offsets"]
        assert data["first_offset"][0] <= first <= data["first_offset"][1]
        gap = second - first
        assert data["second_gap"][0] <= gap <= data["second_gap"][1]
        # each slab lies inside the model: no slab ends past its extent
        assert second + data["slab_width"] <= 1.0
        # the truth maps the source view back onto the target view's
        # frame: the shared slab's points coincide up to the noise
        t = pair["truth"]
        moved = pair["source"] @ t[:3, :3].T + t[:3, 3]
        assert abs(len(pair["target"]) - data["slab_width"]
                   * len(model)) < 0.1 * len(model)
        shared = data["slab_width"] - gap
        assert 0.5 <= shared / data["slab_width"] <= 0.93
        assert np.isfinite(moved).all()


def test_truth_maps_source_onto_target():
    data = _small(RGBN["data"])
    rng = np.random.default_rng(3)
    model = generate.bumped_sphere(**data["model"])
    pair = generate.full_posed(model, data, rng)
    t = pair["truth"]
    moved = pair["source"] @ t[:3, :3].T + t[:3, 3]
    err = np.linalg.norm(moved - pair["target"], axis=1)
    assert np.median(err) < 4 * data["noise"]
    # normals rotate with the source, colors are carried by index
    back = pair["source_normal"] @ t[:3, :3].T
    assert np.allclose(back, pair["target_normal"], atol=1e-5)
    assert np.array_equal(pair["source_rgb"], pair["target_rgb"])
