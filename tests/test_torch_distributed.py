"""The port's multi-process ``register_batch``: real 2-process
``torch.distributed`` (gloo) jobs on the CPU, one process per device of
``distributed.global_mesh()``, as tests/test_distributed.py runs the
JAX package's ``jax.distributed`` jobs. Every wait has a timeout, and a
job that overruns it is killed and fails."""

import json
import os
import socket
import subprocess
import sys

import pytest

#: seconds a job may take (a job takes a few seconds)
_JOB_TIMEOUT = 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_job(control=None, tmp_path=None, expect_rc=0):
    """Launch one 2-process job; return {pid: its JSON line} (or {} when
    a nonzero exit is expected: crashed workers print nothing)."""
    path = "-"
    if control is not None:
        path = str(tmp_path / f"control-{_free_port()}.json")
        with open(path, "w") as fh:
            json.dump(control, fh)
    coordinator = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__),
                          "_torch_distributed_worker.py")
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(worker))
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, worker, coordinator, "2", str(pid), path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=_JOB_TIMEOUT)
            assert p.returncode == expect_rc, \
                f"worker rc={p.returncode} (want {expect_rc}):\n{err[-3000:]}"
            if expect_rc == 0:
                o = json.loads(out.strip().splitlines()[-1])
                outs[o["pid"]] = o
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _same_on_both(by_pid):
    assert set(by_pid) == {0, 1}
    a, b = by_pid[0], by_pid[1]
    for key in ("scores", "improved", "transforms", "trials",
                "batch_state"):
        assert a[key] == b[key], key


def test_two_process_register_batch():
    """Both processes end with the same results, bit for bit; both pairs
    register (the JAX worker's pair, and a noisy copy)."""
    by_pid = _spawn_job()
    _same_on_both(by_pid)
    s_clean, s_noisy = by_pid[0]["scores"]
    assert all(by_pid[0]["improved"])
    assert s_clean > 0.8 and s_noisy > 0.5, (s_clean, s_noisy)


def test_two_process_slow_rank_stops_on_the_same_step(tmp_path):
    """Process 1's visitor sleeps on every call; the stop rule reads
    process 0's clock, so both stop after the same step (a process that
    stopped alone would leave the other in a collective: the job would
    hang and time out)."""
    by_pid = _spawn_job(dict(max_time_seconds=2, full_budget=True,
                             threshold=1.01, slow_rank=1, sleep=0.15),
                        tmp_path)
    _same_on_both(by_pid)
    assert by_pid[0]["trials"] >= 8


def test_two_process_crash_resume(tmp_path):
    """A 2-process job is hard-killed after one step; each process's
    ``on_checkpoint`` state is an identical replica, and a fresh job
    resuming from it completes (tests/test_distributed.py's fault
    test)."""
    state_path = str(tmp_path / "batch_state.json")
    outs = _spawn_job(dict(die_after_steps=1, state_path=state_path,
                           threshold=1.0), tmp_path, expect_rc=3)
    assert outs == {}
    with open(state_path + ".0") as fh:
        state = json.load(fh)
    with open(state_path + ".1") as fh:
        assert json.load(fh) == state
    assert state["step_idx"] >= 1

    by_pid = _spawn_job(dict(resume_state=state), tmp_path)
    _same_on_both(by_pid)
    assert by_pid[0]["trials"] > state["trial"]
    assert all(by_pid[0]["improved"])
    assert by_pid[0]["scores"][0] > 0.8


def test_initialize_without_a_card_raises():
    """With no CUDA card visible, ``initialize`` without a device raises
    before it joins any job (no quiet CPU run); so does ``make_mesh()``."""
    import torch
    from super4pcs_tpu_torch.parallel import distributed, make_mesh
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.global_mesh()
