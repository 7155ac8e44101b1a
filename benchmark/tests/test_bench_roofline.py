"""The roofline counts come from the shapes of a launch."""

import torch

import roofline
from roofline import k1, k2


def test_k1_counts_inputs_outputs_and_the_moves():
    tr = torch.zeros(2, 64, 4, 4)
    q, p = torch.zeros(2, 8192, 3), torch.zeros(2, 50000, 3)
    out = torch.zeros(2, 64, 8192)
    nbytes, flops = k1.work((tr, q, p, 0.01), {}, out)
    assert nbytes == 4 * (2 * 64 * 16 + 2 * 8192 * 3 + 2 * 50000 * 3
                          + 2 * 64 * 8192)
    assert flops == 18 * 2 * 64 * 8192
    least = roofline.least_seconds(nbytes, flops)
    assert least == nbytes / roofline.PEAKS["hbm_bytes_per_s"]


def test_k2_counts_the_tables_and_the_planes():
    q = torch.zeros(4, 8192, 3)
    cols = torch.zeros(64, 8192, 96, dtype=torch.int32)
    rc = torch.zeros(64, 8192, dtype=torch.int32)
    h = torch.zeros_like(cols)
    bounds = (torch.zeros(4, 32, 4), torch.zeros(4, 16, 4))
    nbytes, flops = k2.work((q,), dict(bounds=bounds), (cols, rc, h))
    reads = 4 * 8192 * 3 + 4 * 32 * 4 + 4 * 16 * 4 + k2.SCALARS * 64
    assert nbytes == 4 * (reads + 2 * 64 * 8192 * 96 + 64 * 8192)
    assert flops == 0
    aux = torch.zeros(64, 2, 8192)
    more, _ = k2.work((q,), dict(aux=aux, rcscore=aux, normals=q),
                      (cols, rc))
    assert more == 4 * (4 * 8192 * 3 * 2 + 2 * 64 * 2 * 8192
                        + k2.SCALARS * 64 + 64 * 8192 * 96 + 64 * 8192)


def test_peaks_are_the_h100_data_sheet():
    assert roofline.PEAKS["f32_flops"] == 67.0e12
    assert roofline.PEAKS["hbm_bytes_per_s"] == 3.35e12
