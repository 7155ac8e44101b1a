"""super4pcs_tpu_torch — the PyTorch / CUDA port of super4pcs_tpu.

Global point-cloud registration (4PCS / Super4PCS) on an NVIDIA GPU:
the same algorithm, options and results as the JAX package
``super4pcs_tpu``, which stays the reference. Plain tensor work is
PyTorch; the two TPU kernels of the main path are hand-written CUDA
kernels (``csrc/``, built with nvcc at first use): the LCP min-distance
kernel (``kernels/lcp.py``) and the band-capture kernel
(``kernels/rowcap.py``). Above nq = 65536 the banded pair engine
(``ops/band_extract.py``, torch ops over a once-per-run sorted
cell-pair table) extracts the pairs instead of the capture kernel. On
CPU tensors every kernel wrapper runs its plain PyTorch version
instead. Entry points: :func:`register`, the
matchers, :func:`register_sequence`, and the ``super4pcs-torch`` CLI
(``cli.py``, reading and writing files through ``io/``).

The package never imports jax. Float32 throughout: TF32 matmuls and
convolutions are switched off below, because the fits and the verify
need full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .options import Options  # noqa: E402
from .cloud import PointCloud  # noqa: E402
from .matcher import (Match4PCS, MatchSuper4PCS,  # noqa: E402
                      RegistrationResult, state_from_jax)
from .api import register  # noqa: E402
from .sequence import (SequenceStepResult, parse_stanford_conf,  # noqa: E402
                       reference_pose_diff, register_sequence)

__version__ = "0.1.0"

__all__ = [
    "Options",
    "PointCloud",
    "Match4PCS",
    "MatchSuper4PCS",
    "RegistrationResult",
    "register",
    "register_sequence",
    "state_from_jax",
    "parse_stanford_conf",
    "reference_pose_diff",
    "SequenceStepResult",
    "__version__",
]
