"""Multi-process execution over ``torch.distributed``.

PyTorch counterpart of ``super4pcs_tpu.parallel.distributed``: each
process drives one device (one process per card), and a global
:class:`~.sharded.Mesh` over every process's device carries the
scan-graph batch of ``register_batch`` on its pairs axis. The only
traffic between processes is each step's per-pair results (a few
hundred bytes a pair), process 0's clock, and once a call the
redeemed stragglers' answers.

The collectives run on the gloo backend over host tensors: the host
reads every step's results anyway, gloo takes any number of processes
on one card (NCCL refuses two ranks on one device), and it is the same
backend on the CPU, where the tests run.

Run recipe (one process per card; the same inputs in every process):

    # process 0 (coordinator) and process 1
    python my_job.py --coordinator=host0:8476 --nprocs=2 --pid=0
    python my_job.py --coordinator=host0:8476 --nprocs=2 --pid=1

    # my_job.py
    from super4pcs_tpu_torch.parallel import distributed, register_batch
    distributed.initialize(coordinator, nprocs, pid)
    results = register_batch(pairs, opts, mesh=distributed.global_mesh())

Every process receives the full result list.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sharded import Mesh, _device

#: this process's device, set by :func:`initialize` (the process's
#: identity in the job, beside torch.distributed's default group)
_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None) -> torch.device:
    """Join the job: a TCP rendezvous at ``coordinator_address``
    ("host:port", process 0 listens there) of ``num_processes``
    processes, this one ``process_id``, on the gloo backend.

    ``device``: this process's device. ``None`` puts it on CUDA card
    ``process_id`` modulo the visible cards (every process on
    ``cuda:0`` on a one-card machine), and raises when no card is
    visible; the tests pass ``"cpu"``. Returns the device.
    """
    import torch.distributed as dist
    global _DEVICE
    if device is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("distributed.initialize(): no CUDA device is "
                               "visible; pass device='cpu' to run on the "
                               "CPU")
        device = f"cuda:{process_id % n}"
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(
        "gloo", init_method=addr, world_size=num_processes,
        rank=process_id)
    _DEVICE = dev
    return dev


def global_mesh(axis: str = "pairs") -> Mesh:
    """1-D mesh over every process's device, in process order (call
    after :func:`initialize`)."""
    import torch.distributed as dist
    if _DEVICE is None or not dist.is_initialized():
        raise RuntimeError("call distributed.initialize() first")
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(_DEVICE))
    return Mesh(devices=tuple(torch.device(n) for n in names), axis=axis,
                group=dist.group.WORLD, rank=dist.get_rank())

