"""``register_batch`` over ``distributed.global_mesh()``: a call's pairs
sharded over the job's processes, one card each, every process holding
every pair's result after each step. The process joined its job before
the run (``run.py``); the mesh is made once, at the first call."""

import functools

import harness


@functools.cache
def _mesh():
    from super4pcs_tpu_torch.parallel import distributed
    return distributed.global_mesh()


def call(port, pairs, opts, device):
    from super4pcs_tpu_torch.parallel import register_batch
    return register_batch([harness._clouds(port, pair) for pair in pairs],
                          opts, mesh=_mesh())
