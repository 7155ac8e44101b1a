"""Multi-device scaling: the bases axis, the pairs axis, processes.

PyTorch counterpart of ``super4pcs_tpu.parallel``:

- **bases axis** (``sharded``): a device step's bases shard across a
  1-D mesh (:func:`make_mesh`); each device runs base selection ->
  pair extraction -> congruent join -> rigid fit -> LCP on its shard,
  and an argmax over the tiny per-shard results picks the global best
  (:func:`sharded_step`; ``MatchSuper4PCS(opts, mesh=...)``);
- **pairs axis** (``batch``): independent scan pairs of a scan graph
  register in one batched step (:func:`register_batch`, BASELINE.json
  config 5), sharded over a mesh's devices when one is given;
- **processes** (``distributed``): ``torch.distributed`` set-up and a
  global mesh over every process's device, so the pairs axis runs one
  process per card.
"""

from . import distributed
from .sharded import make_mesh, sharded_step
from .batch import register_batch

__all__ = ["make_mesh", "sharded_step", "register_batch", "distributed"]
