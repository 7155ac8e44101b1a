"""K2, the row-capped band capture (``kernels/rowcap.py``,
``csrc/rowcap.cu``: ``rowcap_prep_kernel`` fills the tables and stages
the planes, ``rowcap_capture_kernel`` captures): for every trial's base
edge and every source sample (row), the first hits of the distance band
in each column segment, the exact hit count of the row and, for the
first edge, the join hash of each hit.

One launch reads the points (and the filters' planes: normals, the
per-trial score and angle planes, the per-trial band scalars, the tile
bounds) once, and writes the whole tables once: ``cols`` and ``h``
(T, n_pad, row_cap) int32 and ``rc`` (T, n_pad) int32. The hits'
distance tests depend on the data and are not counted, so the bound is
the bytes'.
"""

SPY = ("super4pcs_tpu_torch.kernels.rowcap", "rowcap_capture")
COUNTER = "launches"
KERNELS = ("rowcap_capture_kernel", "rowcap_prep_kernel")

#: band scalars a trial carries (lo2, hi2, inv, cell; with filters the
#: normal angle and threshold and the angle cosine)
SCALARS = 7


def work(args, kwargs, out):
    """(bytes, flops) of one launch: ``args[0]`` = q (G?, n, 3), the
    filter planes in ``kwargs``, ``out`` = (cols, rc[, h])."""
    q = args[0]
    reads = q.numel()
    for key in ("normals", "aux", "rcscore"):
        t = kwargs.get(key)
        if t is not None:
            reads += t.numel()
    bounds = kwargs.get("bounds")
    if bounds is not None:
        reads += sum(b.numel() for b in bounds)
    trials = out[1].shape[0] if out[1].ndim == 2 else 1
    reads += SCALARS * trials
    writes = sum(o.numel() for o in out)
    return 4 * (reads + writes), 0
