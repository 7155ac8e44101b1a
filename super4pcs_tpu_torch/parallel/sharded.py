"""Bases-axis sharding of the RANSAC device step over a device mesh.

PyTorch counterpart of ``super4pcs_tpu.parallel.sharded``. Each mesh
device runs the *same* step (``matcher.build_step``) on its shard of the
step's bases; the global best candidate is then picked from the tiny
per-shard results with an argmax on the host (the first shard wins a
tie), as the JAX package's ``all_gather`` + argmax picks it. This
replaces the reference's shared ``best_LCP_`` + ``omp critical``
(ref:src/super4pcs/algorithms/match4pcsBase.hpp:467-484) with a
reduction.

Point clouds and the run's indexes are replicated: the sampled clouds
are small, the per-base work (extraction, join, fit, verify) is the
big axis.

Where the port differs from a JAX mesh: the shards are Python-level
launches, one after another from the calling thread, each on its
device's current stream, and every shard is launched before any result
is fetched, so the devices overlap. A mesh may name a device more than
once (``make_mesh(["cpu"] * 8)``, ``make_mesh(["cuda:0"] * 2)``); the
shards on a shared device then run one after another. That is how the
CPU tests stand in for the JAX tests' 8 virtual devices, and how one
card runs the sharded path. A mesh made by
``distributed.global_mesh`` spans processes: each process runs its own
shard and the results are all-gathered over ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

BASES_AXIS = "bases"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard, in shard order.

    ``group``: the ``torch.distributed`` process group of a mesh that
    spans processes (``distributed.global_mesh``; one shard per process,
    shard ``i`` on process ``i``), None for a mesh of this process's
    devices. ``rank`` is this process's shard then."""
    devices: tuple
    axis: str = BASES_AXIS
    group: Optional[object] = None
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def world_size(self) -> int:
        """Processes the mesh spans."""
        return 1 if self.group is None else self.size

    def local_shards(self) -> Sequence[int]:
        """The shards this process runs."""
        return range(self.size) if self.group is None else (self.rank,)

    def bounds(self, n: int, i: int):
        """(lo, hi) of shard ``i`` of an axis of ``n`` entries, which the
        mesh size divides."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not shard over "
                             f"{self.size} devices")
        k = n // self.size
        return i * k, (i + 1) * k


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, axis: str = BASES_AXIS) -> Mesh:
    """1-D mesh over ``devices`` (torch devices or their names, all of
    one type; a device may appear more than once, and its shards then
    run one after another). ``None`` means every visible CUDA card; it
    raises when there is none (no CPU fallback: ask for
    ``["cpu"] * k``)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh(): no CUDA device is visible; "
                               "name the devices, e.g. ['cpu'] * 8")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(_device(d) for d in devices)
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh needs devices of one type, got "
                         f"{[str(d) for d in devices]}")
    return Mesh(devices=devices, axis=axis)


def _on_device(dev: torch.device):
    """Context that makes ``dev`` the current CUDA device (a no-op for
    the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _fetch(out: dict) -> dict:
    """numpy copies of a dict of tensors on one device, through one
    device-to-host copy: the tensors' bytes are packed into one buffer
    on the device and split again on the host."""
    ts = {k: v.contiguous() for k, v in out.items()}
    if not ts or next(iter(ts.values())).device.type == "cpu":
        return {k: v.numpy().copy() for k, v in ts.items()}
    flat = torch.cat([v.reshape(-1).view(torch.uint8)
                      for v in ts.values()]).cpu()
    host, o = {}, 0
    for k, v in ts.items():
        nb = v.numel() * v.element_size()
        host[k] = flat[o:o + nb].view(v.dtype).reshape(v.shape).numpy()
        o += nb
    return host


def run_shards(mesh: Mesh, fn, lazy=()) -> list:
    """``fn(i, device)`` (a dict of tensors on ``device``) for every
    shard this process runs, all launched before any is fetched; returns
    every shard's results in shard order as numpy arrays (fetched with
    one copy a shard, then all-gathered across the mesh's processes).
    The keys in ``lazy`` stay on their shard's device in a one-process
    mesh (the host reads them when it needs them)."""
    outs = []
    for i in mesh.local_shards():
        dev = mesh.devices[i]
        with _on_device(dev):
            outs.append(fn(i, dev))
    if mesh.group is not None:
        lazy = ()
    got = []
    for out in outs:
        host = _fetch({k: v for k, v in out.items() if k not in lazy})
        host.update({k: out[k] for k in lazy})
        got.append(host)
    return gather_objects(mesh, got[0]) if mesh.group is not None else got


def gather_objects(mesh: Mesh, obj) -> list:
    """Every process's ``obj``, in process order, from one
    ``all_gather_object`` over the group of ``mesh``, a mesh that spans
    processes."""
    import torch.distributed as dist
    every = [None] * mesh.size
    dist.all_gather_object(every, obj, group=mesh.group)
    return every


#: the outputs taken from the winning shard
_OUT_NAMES = ("lcp", "rank_lcp", "transform", "qcentroid1", "qcentroid2",
              "base_ids", "congruent_ids")


def sharded_step(step_fn, mesh: Mesh, axis: str = BASES_AXIS,
                 gather_telemetry: bool = True):
    """Wrap a one-device step into a step over ``mesh``.

    ``step_fn(keys, device)`` runs the step on ``device`` for its shard
    of ``keys`` and returns the matcher step dict of the *best local*
    candidate (lcp, rank_lcp, transform, qcentroid1, qcentroid2,
    base_ids, congruent_ids), n_congruent, cands_dropped and the
    per-base ``pair_counts`` table, as tensors on ``device``.

    Returns ``sharded(keys)``: ``keys`` is a tensor or a tuple of
    tensors whose first axis is ``axis`` (the step's bases, which the
    mesh size must divide; on any device: each shard's slice is moved
    to its device). The result is one dict of numpy arrays, reduced as
    the JAX package reduces it: the winner is the argmax of rank_lcp
    (the first shard wins a tie) and gives every name above;
    n_congruent and cands_dropped are summed; pair_counts are
    concatenated in shard order.

    ``gather_telemetry=False`` leaves each shard's ``pair_counts`` (the
    one output that grows with the bases) out of its fetch: they are
    concatenated on the mesh's first device and returned as a tensor,
    for the host to read when it needs them. The numbers are the same.
    Across processes the table is gathered either way.
    """
    del axis   # the mesh has one axis; the name is kept for the JAX form
    lazy = () if gather_telemetry else ("pair_counts",)

    def sharded(keys):
        one = torch.is_tensor(keys)
        ks = (keys,) if one else tuple(keys)
        n = ks[0].shape[0]

        def shard(i, dev):
            lo, hi = mesh.bounds(n, i)
            part = tuple(k[lo:hi].to(dev) for k in ks)
            return step_fn(part[0] if one else part, dev)

        got = run_shards(mesh, shard, lazy)
        rank = np.asarray([float(g["rank_lcp"]) for g in got])
        best = int(np.argmax(rank))
        out = {name: got[best][name] for name in _OUT_NAMES}
        out["n_congruent"] = np.sum([g["n_congruent"] for g in got])
        out["cands_dropped"] = np.sum([g["cands_dropped"] for g in got])
        pcs = [g["pair_counts"] for g in got]
        out["pair_counts"] = (
            torch.cat([t.to(mesh.devices[0]) for t in pcs])
            if torch.is_tensor(pcs[0]) else np.concatenate(pcs))
        return out

    return sharded
