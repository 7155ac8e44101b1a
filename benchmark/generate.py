"""The one generator of the benchmark's registration work.

Everything here is numpy and follows the data recipe of a configuration
file (``configs/<config>.json``, key ``data``) and the call shape of a
traffic file (``traffic/<traffic>.json``). A later cell adds a recipe or
a traffic mix as a data file; a new ``kind`` of recipe is a file of its
own, ``recipes/<kind>.py`` with ``pair(model, data, rng)`` as below,
found by name.

Recipes (``data["kind"]``):

- ``slab_views``: two views of one model, each a slab of
  ``slab_width`` of the model's x extent; the first slab starts at an
  offset drawn in ``first_offset``, the second ``second_gap`` further
  on (fractions of the extent). Each view is moved to its own pose and
  gets Gaussian noise of ``noise`` (sigma). The source is the second
  view, the target the first.
- ``full_posed``: the whole model as the target, and the model moved to
  a pose with noise as the source; with ``attributes`` the radial
  normals (rotated with the source) and the colors ``abs(model) *
  color_scale``, carried by index.

The model (``data["model"]``) is the bumped sphere of ``points`` points
from numpy seed ``seed``: unit directions scaled by ``1 + 0.3 sin(5x)
cos(3y) + 0.2 sin(4z)``.

A pose is a uniform random rotation (a normalized Gaussian quaternion)
and a translation uniform in ``[-translation, translation]^3``.
"""

from __future__ import annotations

import os

import numpy as np

from byname import load

HERE = os.path.dirname(os.path.abspath(__file__))


def bumped_sphere(points: int, seed: int) -> np.ndarray:
    """(points, 3) float32: the bumped sphere of numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(points, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = (1 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
            + 0.2 * np.sin(4 * v[:, 2]))
    return (v * bump[:, None]).astype(np.float32)


def random_pose(rng: np.random.Generator, translation: float) -> np.ndarray:
    """(4, 4) float64: a uniform random rotation and a translation in
    ``[-translation, translation]^3``."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.uniform(-translation, translation, 3)
    return m


def _moved(pos: np.ndarray, pose: np.ndarray, noise: float,
           rng: np.random.Generator) -> np.ndarray:
    out = pos.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]
    out += rng.normal(scale=noise, size=out.shape)
    return out.astype(np.float32)


def slab_views(model: np.ndarray, data: dict,
               rng: np.random.Generator) -> dict:
    """One pair of the ``slab_views`` recipe: target, source and the
    source -> target pose ``truth`` (4, 4) float64."""
    x = model[:, 0]
    lo, extent = float(x.min()), float(x.max() - x.min())
    first = rng.uniform(*data["first_offset"])
    second = first + rng.uniform(*data["second_gap"])
    views, poses = [], []
    for start in (first, second):
        a = lo + start * extent
        slab = model[(x >= a) & (x <= a + data["slab_width"] * extent)]
        pose = random_pose(rng, data["translation"])
        views.append(_moved(slab, pose, data["noise"], rng))
        poses.append(pose)
    return dict(target=views[0], source=views[1],
                truth=poses[0] @ np.linalg.inv(poses[1]),
                offsets=(first, second))


def full_posed(model: np.ndarray, data: dict,
               rng: np.random.Generator) -> dict:
    """One pair of the ``full_posed`` recipe (see the module doc)."""
    pose = random_pose(rng, data["translation"])
    pair = dict(target=model, source=_moved(model, pose, data["noise"], rng),
                truth=np.linalg.inv(pose))
    if data.get("attributes"):
        normal = (model / np.linalg.norm(model, axis=1, keepdims=True))
        rgb = (np.abs(model) * data["color_scale"]).astype(np.float32)
        pair.update(target_normal=normal.astype(np.float32),
                    source_normal=(normal @ pose[:3, :3].T).astype(
                        np.float32),
                    target_rgb=rgb, source_rgb=rgb)
    return pair


#: the built-in recipes
RECIPES = {"slab_views": slab_views, "full_posed": full_posed}


def recipe(kind: str, here: str = HERE):
    """The recipe ``kind``: a built-in of :data:`RECIPES`, else the
    ``pair`` of ``<here>/recipes/<kind>.py``."""
    return RECIPES[kind] if kind in RECIPES else load(
        here, "recipes", kind).pair


def make_calls(data: dict, traffic: dict, seed: int, here: str = HERE
               ) -> list:
    """The cell's calls, from ``seed``: ``traffic["calls"]`` calls of
    ``traffic["pairs_per_call"]`` pairs each, every call with its own
    registration seed (``random_seed``). Each pair is a dict with
    ``target``, ``source``, ``truth`` and, by recipe, the attributes.
    ``here``: the benchmark's folder, where a recipe not built in is
    found."""
    model = bumped_sphere(**data["model"])
    make = recipe(data["kind"], here)
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(traffic["calls"]):
        pairs = [make(model, data, rng)
                 for _ in range(traffic["pairs_per_call"])]
        calls.append(dict(pairs=pairs,
                          random_seed=int(rng.integers(1, 2 ** 31 - 1))))
    return calls
