"""Subprocess body of tests/test_torch_distributed.py: one process of a
2-process ``torch.distributed`` (gloo) CPU run of the port's
``register_batch`` over ``distributed.global_mesh()``.

Prints one JSON line with the per-pair results, so that the parent can
assert that both processes completed and that they agree bit for bit.
An optional control file carries a wall-clock budget, a process to slow
down (its visitor sleeps on every call), and a ``batch_state`` to resume
from, or a step after which every process dies (a preempted job). With
``budget_steps`` the budget is measured on the machine as it is loaded
now: a first job without the slowed process gives the slowest process's
search seconds per step, and the budget is ``budget_steps`` steps of
that plus the sleep. With ``redeem`` straggler redemption is on (one
refine iteration, the escalation above the search factor) and each
straggler's matcher is :class:`_Redeemer`, a fixed answer that names the
process that ran it (after ``redeem_sleep`` seconds); ``alone`` adds the
same pairs registered in this one process, with no mesh.
"""

import json
import os
import sys
import time


def main():
    coordinator, nprocs, pid = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    control = {}
    if len(sys.argv) > 4 and sys.argv[4] != "-":
        with open(sys.argv[4]) as fh:
            control = json.load(fh)

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from super4pcs_tpu_torch import Options, PointCloud
    from super4pcs_tpu_torch.parallel import distributed, register_batch
    distributed.initialize(coordinator, nprocs, pid, device="cpu")

    # deterministic tiny fixture (the same in every process): the JAX
    # package's worker's, and a second pair with noise at 0.6 delta
    rng = np.random.default_rng(0)
    v = rng.normal(size=(80, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.3 * np.sin(5 * v[:, 0]) * np.cos(3 * v[:, 1])
    pos = (v * bump[:, None]).astype(np.float32)
    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                    [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]], np.float32)
    q = (pos @ rot.T + np.float32([0.2, -0.1, 0.3])).astype(np.float32)
    noisy = (q + rng.normal(scale=0.03, size=q.shape)).astype(np.float32)

    pairs = [(PointCloud(pos=pos), PointCloud(pos=q)),
             (PointCloud(pos=pos), PointCloud(pos=noisy))]
    opts = Options(delta=0.05, sample_size=80,
                   max_time_seconds=control.get("max_time_seconds", 60),
                   bases_per_step=4, max_quads=256, max_candidates=256,
                   refine_iterations=1 if control.get("redeem") else 0,
                   random_seed=3,
                   use_full_time_budget=control.get("full_budget", False),
                   ).configure_overlap(control.get("overlap", 0.9),
                                       control.get("threshold", 1.0))

    if control.get("redeem"):
        from super4pcs_tpu_torch.matcher import RegistrationResult
        from super4pcs_tpu_torch.parallel import batch

        class _Redeemer:
            """A straggler's matcher: the noisy pair's true pose at LCP
            0.995, in no time (a real redemption runs to its wall
            budget on the CPU); its stats name the process that ran it
            and the search factor it was given."""

            def __init__(self, options, device=None):
                self.options = options

            def compute_transformation(self, P, Q):
                time.sleep(control.get("redeem_sleep", 0.0))
                mat = np.eye(4, dtype=np.float32)
                mat[:3, :3] = rot.T
                mat[:3, 3] = -rot.T @ np.float32([0.2, -0.1, 0.3])
                return RegistrationResult(
                    score=0.995, transform=mat,
                    transformed_q=Q.transformed(mat), n_trials=64,
                    improved=True,
                    stats={"search_seconds": 0.0, "redeemed_by": pid,
                           "factor": self.options.search_delta_factor})

        batch.MatchSuper4PCS = _Redeemer

    if "budget_steps" in control:
        probe = register_batch(
            pairs, opts.replace(max_time_seconds=60,
                                use_full_time_budget=False),
            mesh=distributed.global_mesh())
        b = opts.bases_per_step
        per_step = torch.tensor([probe[0].stats["search_seconds"] * b
                                 / max(probe[0].n_trials, b)],
                                dtype=torch.float64)
        dist.all_reduce(per_step, op=dist.ReduceOp.MAX)
        opts = opts.replace(max_time_seconds=control["budget_steps"] * (
            float(per_step[0]) + control.get("sleep", 0.0)))

    visitor = None
    if control.get("slow_rank") == pid:
        # a straggling process: its visitor sleeps on every call
        def visitor(fraction, scores, mats):
            time.sleep(control["sleep"])

    on_checkpoint = None
    die_after = control.get("die_after_steps")
    if die_after is not None:
        # preemption: persist the replicated state every step and
        # hard-kill every process after the same step
        steps = [0]

        def on_checkpoint(state):
            steps[0] += 1
            with open(control["state_path"] + f".{pid}", "w") as fh:
                json.dump(state, fh)
            if steps[0] >= die_after:
                os._exit(3)

    results = register_batch(pairs, opts, mesh=distributed.global_mesh(),
                             visitor=visitor,
                             resume_state=control.get("resume_state"),
                             on_checkpoint=on_checkpoint)
    out = dict(_summary(results), pid=pid,
               batch_state=results[0].stats["batch_state"])
    if control.get("alone") and pid == 0:
        out["alone"] = _summary(register_batch(pairs, opts, device="cpu"))
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def _summary(results) -> dict:
    """What the parent compares: each pair's score, improved flag,
    transform and trials, a redeemed pair's flag and matcher stats, the
    call's redemption counters and its seconds inside the gather of the
    redeemed answers."""
    import numpy as np
    spans = results[0].stats["spans"]
    return {
        "scores": [float(r.score) for r in results],
        "improved": [bool(r.improved) for r in results],
        "transforms": [np.asarray(r.transform).tolist() for r in results],
        "trials": results[0].n_trials,
        "n_trials": [int(r.n_trials) for r in results],
        "escalated": [r.stats.get("straggler_escalated_to")
                      for r in results],
        "redeemed_by": [r.stats.get("redeemed_by") for r in results],
        "factor": [r.stats.get("factor") for r in results],
        "counters": {k: spans.get(k) for k in (
            "stragglers", "redeemed_here", "redeem_kept")},
        "exchange_s": spans["spans"].get("redeem/exchange",
                                         {}).get("host_s"),
    }


if __name__ == "__main__":
    main()
