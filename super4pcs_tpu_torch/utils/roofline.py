"""Per-phase roofline accounting.

PyTorch counterpart of ``super4pcs_tpu.utils.roofline``, with the same
logic and output keys. The step's builder attaches a first-order
analytic cost model (operations + device-memory bytes per phase, from
the same static capacities that size the buffers, and for the verify
from the pair tests its kernel makes: see ``matcher.build_step``), and
:func:`attribute` turns (cost, measured seconds) into achieved rates,
percent of peak, a bound classification and the headroom left.

The model is first-order by design: gathers count each logical byte
once, a sort counts its keys read once and its keys and permutation
written once. That is enough to say whether a phase is bound by
operations, memory or launches, and how much speed-up is left.
"""

from __future__ import annotations

#: NVIDIA H100 SXM peaks, NVIDIA's data sheet (dense, at the 700 W power
#: limit), under the JAX package's keys: ``vpu_f32_flops`` is float32
#: outside the tensor cores (the port's phases and kernels), the
#: ``mxu_*`` keys are the tensor cores (the port runs no tensor-core
#: phase; float32 matmuls run in full float32, TF32 off), and HBM3.
H100 = dict(
    name="NVIDIA H100 80GB HBM3 (SXM data sheet, 700 W)",
    mxu_bf16_flops=989.0e12,
    mxu_f32_flops=495.0e12,
    vpu_f32_flops=67.0e12,
    hbm_bytes_per_s=3.35e12,
)

#: below this time a phase is bound by its launches, and neither
#: ceiling is meaningful: the fit phase of the headline step (one
#: batched rigid fit over 16 x 8192 candidate slots in small launches,
#: whose bytes bound it at ~4 us) measured 0.484 ms on an NVIDIA H100
#: 80GB HBM3 at a 700 W power limit (chip_smoke.py phase 5o)
DISPATCH_FLOOR_S = 0.5e-3
#: below this fraction of BOTH peaks the phase is overhead-bound even
#: if it takes visible time (e.g. serial dependency chains)
UTILIZATION_FLOOR = 0.02


def attribute(costs: dict, seconds: dict, peaks: dict = H100) -> dict:
    """Join the analytic cost model with measured per-phase seconds.

    ``costs``: {phase: {"flops": F, "hbm_bytes": B, "unit": "vpu"|"mxu"}}
    (unit selects which compute ceiling the phase's operations are
    judged against; default "vpu"). ``seconds``: {phase: measured_s}.

    Returns {phase: {"seconds", "gflops", "gbps", "compute_pct",
    "memory_pct", "bound", "headroom_x"}} where ``bound`` is
    "compute" / "memory" / "dispatch" and ``headroom_x`` is the factor
    left to the binding ceiling (capped at 1e4 for dispatch-bound
    phases, where the fix is fewer launches, not kernel work).
    """
    out = {}
    for phase, c in costs.items():
        t = seconds.get(phase)
        if t is None:
            continue
        t = max(float(t), 1e-9)
        fl = float(c.get("flops", 0.0))
        by = float(c.get("hbm_bytes", 0.0))
        if t < DISPATCH_FLOOR_S:
            # a launch-bound phase's rates say nothing of its kernels:
            # report only the classification
            fl = by = 0.0
        peak_f = (peaks["mxu_f32_flops"] if c.get("unit") == "mxu"
                  else peaks["vpu_f32_flops"])
        comp = fl / t / peak_f
        mem = by / t / peaks["hbm_bytes_per_s"]
        if t < DISPATCH_FLOOR_S or max(comp, mem) < UTILIZATION_FLOOR:
            bound = "dispatch"
            headroom = 1.0e4
        elif mem >= comp:
            bound = "memory"
            headroom = 1.0 / max(mem, 1e-12)
        else:
            bound = "compute"
            headroom = 1.0 / max(comp, 1e-12)
        out[phase] = dict(
            seconds=round(t, 6),
            gflops=round(fl / t / 1e9, 2),
            gbps=round(by / t / 1e9, 2),
            compute_pct=round(100.0 * comp, 2),
            memory_pct=round(100.0 * mem, 2),
            bound=bound,
            headroom_x=round(min(headroom, 1.0e4), 1),
        )
    return out


def table(roof: dict) -> str:
    """Human-readable roofline table (the verbose log's form)."""
    hdr = (f"{'phase':<16}{'s':>9}{'GFLOP/s':>10}{'GB/s':>9}"
           f"{'%comp':>8}{'%mem':>8}  bound (headroom)")
    lines = [hdr]
    for ph, r in roof.items():
        lines.append(
            f"{ph:<16}{r['seconds']:>9.4f}{r['gflops']:>10.1f}"
            f"{r['gbps']:>9.1f}{r['compute_pct']:>8.2f}"
            f"{r['memory_pct']:>8.2f}  {r['bound']}"
            f" ({r['headroom_x']:g}x)")
    return "\n".join(lines)
