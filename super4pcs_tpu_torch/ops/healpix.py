"""HEALPix ring-scheme pixelization in PyTorch.

The port's counterpart of ``super4pcs_tpu.ops.healpix``. The reference's
deprecated ``IndexedNormalHealSet`` bins pair directions into HEALPix
pixels via the vendored chealpix C library
(ref:src/super4pcs/accelerators/normalHealSet.h:102-106,
3rdparty/chealpix — only ``vec2pix_ring`` / ``nside2npix`` are used).
This is the public HEALPix ring pixelization (Górski et al. 2005, ApJ
622) as tensor arithmetic, so direction binning runs on the device
beside the join that reads it.

The arithmetic is the JAX package's, op for op: float32 throughout,
int32 pixel ids, ``floor`` then truncation to int32, and Python-style
``mod`` (``torch.remainder``; ``torch.fmod`` truncates) and floor
division. All functions are elementwise over leading batch dims.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32
_I32 = torch.int32


def nside2npix(nside: int) -> int:
    """Total pixels of an nside tessellation (ref API chealpix.h:80)."""
    return 12 * nside * nside


def _floor_i32(x):
    return torch.floor(x).to(_I32)


def ang2pix_ring(nside: int, z, phi):
    """Ring-scheme pixel of direction(s) given z=cos(theta), phi."""
    z = torch.as_tensor(z, dtype=_F32)
    phi = torch.as_tensor(phi, dtype=_F32, device=z.device)
    tt = torch.remainder(phi, 2.0 * math.pi) * (2.0 / math.pi)  # in [0, 4)
    za = z.abs()

    # --- equatorial belt: |z| <= 2/3 ---
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = _floor_i32(temp1 - temp2)                    # ascending edge
    jm = _floor_i32(temp1 + temp2)                    # descending edge
    ir = nside + 1 + jp - jm                          # ring 1..2n+1
    kshift = 1 - (ir & 1)
    ip = torch.div(jp + jm - nside + kshift + 1, 2, rounding_mode="floor")
    ip = torch.remainder(ip, 4 * nside)
    ncap = 2 * nside * (nside - 1)
    pix_eq = ncap + (ir - 1) * (4 * nside) + ip

    # --- polar caps: |z| > 2/3 ---
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(torch.clamp(3.0 * (1.0 - za), min=0.0))
    jp_c = _floor_i32(tp * tmp)
    jm_c = _floor_i32((1.0 - tp) * tmp)
    ir_c = jp_c + jm_c + 1                            # ring counted from pole
    ip_c = _floor_i32(tt * ir_c)
    ip_c = torch.remainder(ip_c, 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = nside2npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = torch.where(z > 0, pix_north, pix_south)

    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_cap).to(_I32)


def vec2pix_ring(nside: int, vec):
    """Ring-scheme pixel of 3D direction(s) ``vec`` (..., 3)
    (ref API chealpix.h:97)."""
    vec = torch.as_tensor(vec, dtype=_F32)
    vlen = torch.linalg.vector_norm(vec, dim=-1)
    z = vec[..., 2] / torch.clamp(vlen, min=1e-30)
    phi = torch.atan2(vec[..., 1], vec[..., 0])
    return ang2pix_ring(nside, z, phi)


def _cap_ring(ipix):
    """Ring of a polar-cap pixel counted from its pole (integer sqrt
    with its edge cases refined)."""
    iring = ((1 + torch.sqrt(1.0 + 2.0 * ipix)) / 2).to(_I32)
    iring = torch.where(2 * iring * (iring - 1) > ipix, iring - 1, iring)
    return torch.where(2 * iring * (iring + 1) <= ipix, iring + 1, iring)


def pix2vec_ring(nside: int, ipix):
    """Center direction of ring-scheme pixel(s) — the inverse map, used
    to validate the pixelization round-trip."""
    ipix = torch.as_tensor(ipix, dtype=_I32)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    # north cap
    iring_n = _cap_ring(ipix)
    iphi_n = ipix - 2 * iring_n * (iring_n - 1)
    z_n = 1.0 - (iring_n * iring_n) / (3.0 * nside * nside)
    phi_n = (iphi_n + 0.5) * math.pi / (2.0 * iring_n)

    # equatorial belt
    ipe = ipix - ncap
    iring_e = torch.div(ipe, 4 * nside, rounding_mode="floor") + nside
    iphi_e = torch.remainder(ipe, 4 * nside)
    # rings where (iring + nside) is odd are unshifted; even rings sit
    # half a pixel east (Gorski et al. 2005, ring scheme)
    fodd = torch.where(torch.remainder(iring_e + nside, 2) == 1, 0.0, 0.5)
    z_e = (2.0 * nside - iring_e) * 2.0 / (3.0 * nside)
    phi_e = (iphi_e + fodd) * math.pi / (2.0 * nside)

    # south cap
    ips = npix - 1 - ipix
    iring_s = _cap_ring(ips)
    iphi_s = ips - 2 * iring_s * (iring_s - 1)
    z_s = -1.0 + (iring_s * iring_s) / (3.0 * nside * nside)
    phi_s = (4.0 * iring_s - iphi_s - 0.5) * math.pi / (2.0 * iring_s)

    in_ncap = ipix < ncap
    in_scap = ipix >= npix - ncap
    z = torch.where(in_ncap, z_n, torch.where(in_scap, z_s, z_e))
    phi = torch.where(in_ncap, phi_n, torch.where(in_scap, phi_s, phi_e))
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], dim=-1)
