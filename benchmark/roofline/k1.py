"""K1, the pruned verify (``kernels/lcp.py``, ``csrc/lcp.cu``
``lcp_min_d2_within_kernel``): for every candidate transform and source
sample, the squared distance to the nearest target sample when it lies
within epsilon.

One launch reads the transforms (16 floats each), the source samples
and the target samples once, and writes one float per (candidate,
sample). Its results need each sample moved by its transform, 9
multiplications and 9 additions; the distances to the neighbours are
data-dependent and not counted.
"""

SPY = ("super4pcs_tpu_torch.kernels.lcp", "lcp_min_d2_within")
COUNTER = "launches"
KERNELS = ("lcp_min_d2_within",)

FLOPS_PER_RESULT = 18


def work(args, kwargs, out):
    """(bytes, flops) of one launch: ``args`` = (transforms (G?, C, 4,
    4), q (G?, nq, 3), p (G?, np, 3), eps, ...), ``out`` (G?, C, nq)."""
    transforms, q, p = args[:3]
    nbytes = 4 * (transforms.numel() + q.numel() + p.numel() + out.numel())
    return nbytes, FLOPS_PER_RESULT * out.numel()
