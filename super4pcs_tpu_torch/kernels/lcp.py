"""K1: candidate-transform LCP min squared distances.

``lcp_min_d2(transforms, q, p)[c, i] = min_j |R_c q_i + t_c - p_j|^2``:
the verify core of the matcher (the reference's ``Verify`` kd-tree walk,
ref:src/super4pcs/algorithms/match4pcsBase.cc:504-567). The CUDA kernel
(``csrc/lcp.cu``) replaces the TPU kernel
``super4pcs_tpu/kernels/lcp_pallas.py::_lcp_min_kernel``; its note says
what bounds it and how it is laid out.

The same kernel covers the TPU's streamed-P variant
``_lcp_min_stream_kernel`` (K3) and the untransformed
``_min_dist_kernel`` / ``_min_dist_stream_kernel`` (K4a / K4b) through
:func:`min_sq_dists`.

The wrappers send a CPU tensor to the plain version and launch the
kernel for a CUDA tensor (or raise): there is no fallback between the
two. Both compute d^2 as the sum of squared coordinate differences in
the same order, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _elem_budget(device: torch.device) -> int:
    # live elements of one d^2 block of the plain version
    return 1 << 27 if device.type == "cuda" else 1 << 22


def _transformed(transforms: torch.Tensor, q: torch.Tensor):
    """(C, nq) x, y, z of the transformed queries, each row
    ``((m0 x + m1 y) + m2 z) + m3`` (the kernel's order)."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    out = []
    for k in range(3):
        m = transforms[:, k]
        out.append(((m[:, 0:1] * x + m[:, 1:2] * y) + m[:, 2:3] * z)
                   + m[:, 3:4])
    return out


def _min_d2_rows(tx, ty, tz, p: torch.Tensor) -> torch.Tensor:
    """(M,) min over P of ``(tx - px)^2 + (ty - py)^2 + (tz - pz)^2``
    for the (M, 1) coordinate columns, blocked over the rows and over
    P, in the kernel's order."""
    m, np_ = tx.shape[0], p.shape[0]
    out = torch.full((m,), float("inf"), dtype=torch.float32,
                     device=p.device)
    if m == 0 or np_ == 0:
        return out
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    budget = _elem_budget(p.device)
    pb = min(np_, max(budget // 64, 1024))
    rb = max(budget // pb, 1)
    for r0 in range(0, m, rb):
        r1 = min(r0 + rb, m)
        best = out[r0:r1]
        for p0 in range(0, np_, pb):
            p1 = min(p0 + pb, np_)
            d = tx[r0:r1] - px[p0:p1]
            d.mul_(d)
            e = ty[r0:r1] - py[p0:p1]
            d.add_(e.mul_(e))
            e = tz[r0:r1] - pz[p0:p1]
            d.add_(e.mul_(e))
            torch.minimum(best, d.amin(dim=1), out=best)
    return out


def lcp_min_d2_plain(transforms: torch.Tensor, q: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: blocked over the flattened
    (C * nq) rows and over P, the same arithmetic order."""
    c, nq = transforms.shape[0], q.shape[0]
    if c * nq == 0:
        return torch.empty((c, nq), dtype=torch.float32, device=q.device)
    tx, ty, tz = (t.reshape(-1, 1) for t in _transformed(transforms, q))
    return _min_d2_rows(tx, ty, tz, p).view(c, nq)


def lcp_min_d2(transforms: torch.Tensor, q: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """(C, nq) f32 min squared distances of every transformed query to
    P. ``transforms`` (C, 4, 4), ``q`` (nq, 3), ``p`` (np, 3), all
    float32 on one device. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    dev = q.device
    for name, t, shape in (("transforms", transforms, (4, 4)),
                           ("q", q, (3,)), ("p", p, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape[1:]) != shape:
            raise ValueError(f"lcp_min_d2: {name} must be float32 "
                             f"(N, {', '.join(map(str, shape))}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("lcp_min_d2: inputs on different devices")
    if dev.type == "cpu":
        return lcp_min_d2_plain(transforms, q, p)
    if dev.type != "cuda":
        raise ValueError(f"lcp_min_d2: unsupported device {dev}")
    transforms, q, p = (t.contiguous() for t in (transforms, q, p))
    c, nq, np_ = transforms.shape[0], q.shape[0], p.shape[0]
    out = torch.empty((c, nq), dtype=torch.float32, device=dev)
    if c * nq == 0:
        return out
    if np_ == 0:
        return out.fill_(float("inf"))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lcp_min_d2(
            transforms.data_ptr(), q.data_ptr(), p.data_ptr(),
            out.data_ptr(), c, nq, np_, stream), "lcp_min_d2")
    lcp_min_d2.launches += 1
    return out


#: kernel launches since the count was last reset (CUDA path only)
lcp_min_d2.launches = 0


def _lib():
    lib = _build.load("lcp")
    fn = lib.lcp_min_d2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def min_sq_dists_plain(tq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`min_sq_dists`: the direct
    ``min_j |tq_m - p_j|^2`` with no transform, in the kernel's order."""
    return _min_d2_rows(tq[:, 0:1], tq[:, 1:2], tq[:, 2:3], p)


def min_sq_dists(tq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(M,) f32 ``min_j |tq_m - p_j|^2`` of the (M, 3) rows ``tq`` to the
    (Np, 3) cloud ``p``, with no transform.

    It launches K1 with one identity transform, which reproduces ``tq``
    exactly (``((1 x + 0 y) + 0 z) + 0 = x`` in IEEE arithmetic), so it
    is bit-identical to :func:`min_sq_dists_plain`. This covers three
    TPU kernels of ``super4pcs_tpu/kernels/lcp_pallas.py``:
    ``_min_dist_kernel`` (K4a, via ``min_sq_dists``),
    ``_min_dist_stream_kernel`` (K4b, via ``min_sq_dists_streamed``) and,
    for transformed queries, ``_lcp_min_stream_kernel`` (K3, via
    ``candidate_min_sq_dists_streamed``, which is :func:`lcp_min_d2`).
    The TPU split each into a VMEM-resident P (up to 300k points) and a
    P streamed through the Pallas pipeline; on the card K1 always
    streams P through shared memory in 1024-point tiles, so one kernel
    serves every Np. CPU tensors take the plain version.
    """
    if tq.dtype != torch.float32 or tq.ndim != 2 or tq.shape[1] != 3:
        raise ValueError(f"min_sq_dists: tq must be float32 (M, 3), got "
                         f"{tq.dtype} {tuple(tq.shape)}")
    if tq.device.type == "cpu":
        return min_sq_dists_plain(tq, p)
    eye = torch.eye(4, dtype=torch.float32, device=tq.device)[None]
    return lcp_min_d2(eye, tq, p)[0]
