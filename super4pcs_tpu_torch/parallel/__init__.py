"""Batched registration of many cloud pairs on one GPU.

PyTorch counterpart of ``super4pcs_tpu.parallel``: the pairs axis
(:func:`register_batch`, BASELINE.json config 5). The JAX package's
device meshes (``make_mesh``, ``sharded_step``, multi-host
``distributed``) are not ported yet (see ROADMAP.md): ``mesh=`` raises
``NotImplementedError``.
"""

from .batch import register_batch

__all__ = ["register_batch"]
