"""One process's part of a run over several cards: one process a card,
each a rank of one ``torch.distributed`` job (``launch.py`` starts
them; ``run.py`` joins each to the job).

Every process builds the same calls from the traffic's pool and sends
them in the same order, drawn from the seed; the traffic's entry point
shards each call's pairs over the job. The window is the one-card
run's (``harness.window``), with process 0 keeping the clock: after
each call it tells every process whether the window goes on, so that
each sends the same calls and none is left inside a collective. A
traced run profiles every card over the same calls; the breakdown and
the per-layer readings are process 0's, the device's busy seconds the
mean of the cards'.

After the window each process checks its own shard's answers against
the plain reference on its own card, and every process's digest of each
call's full result list is compared with process 0's (``ranks_disagree``,
limit 0: every process holds every pair's result). Process 0 gathers
the readings and prints the one result line.

The harness's own collectives call
``torch.distributed.distributed_c10d``'s functions: a traced run's
proxies sit on ``torch.distributed``'s names, where the port calls
them, so ``exchange_ms`` reads the port's exchange alone.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
from torch.distributed import distributed_c10d as c10d

import harness


def _from_rank0(value):
    """Process 0's ``value``, in every process."""
    box = [value]
    c10d.broadcast_object_list(box, src=0)
    return box[0]


def _gathered(value) -> list:
    """Every process's ``value``, in process order."""
    out = [None] * c10d.get_world_size()
    c10d.all_gather_object(out, value)
    return out


def digest(rec: dict) -> str:
    """A digest of a call's full result list: every pair's score and
    transform, in pair order ("raised" for a call that raised)."""
    if rec.get("error"):
        return "raised"
    h = hashlib.sha256()
    for a in rec["answers"]:
        h.update(np.float64(a["score"]).tobytes())
        h.update(np.asarray(a["transform"], np.float64).tobytes())
        h.update(bytes([a["redeemed"]]))
    return h.hexdigest()


def _reduced(stretch) -> dict:
    """Process 0's reduced trace, with the device's busy and traced
    seconds the mean of every card's (busy 0 when a card recorded no
    device operation)."""
    out = harness._reduced(stretch)
    got = _gathered((out["busy_s"], out["window_s"]))
    busy = [b for b, _ in got]
    out["busy_s"] = float(np.mean(busy)) if min(busy) > 0 else 0.0
    out["window_s"] = float(np.mean([w for _, w in got]))
    return out


def run(root: str, cell_name: str, seed: int, seconds: float, traced: bool,
        *, rank: int, device: str, t_start: float, control: bool = False,
        cell: Optional[harness.Cell] = None,
        pool_seed: Optional[int] = None) -> Optional[dict]:
    """This process's part of a run of ``cell_name`` on ``device``, as
    rank ``rank`` of the job; returns the result line's object in
    process 0 and None in the others. ``t_start``: the epoch time the
    launcher started."""
    cell = cell or harness.Cell(root, cell_name)
    import super4pcs_tpu_torch as port
    torch.set_num_threads(1)
    dev = torch.device(device)
    calls, warm, rng = harness.calls_of(cell, seed, pool_seed)
    one = harness.caller(port, cell, dev)
    done, window_s, setup_s, trace_out, peak = harness.window(
        one, calls, warm, rng, seconds, traced, dev, t_start,
        exchange=True, decide=_from_rank0, reduce=_reduced)
    world = c10d.get_world_size()
    g = len(calls[0]["pairs"])
    shard = (g // world * rank, g // world * (rank + 1))
    readings = harness.check_pairs(cell, calls, done, dev, control, shard)
    every = _gathered(dict(readings=readings, peak=peak,
                           digests=[digest(r) for r in done]))
    if rank != 0:
        return None
    readings = [x for e in every for x in e["readings"]]
    correct, attempted, failed, checks = harness.verdict(cell, done,
                                                         readings)
    disagree = sum(len({e["digests"][i] for e in every}) > 1
                   for i in range(len(done)))
    checks["ranks_disagree"] = [disagree, 0]
    return harness.result_line(
        cell, done, (correct and disagree == 0, attempted, failed, checks),
        window_s, setup_s, trace_out, traced, dev,
        max(e["peak"] for e in every), count=world)
