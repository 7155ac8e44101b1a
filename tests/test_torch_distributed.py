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
    hang and time out). The wall budget is six steps as this machine
    runs them now (the worker's ``budget_steps``), so more than one
    step runs however loaded the machine is."""
    by_pid = _spawn_job(dict(budget_steps=6, full_budget=True,
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


#: a job whose noisy pair stays below the stop (0.99) after the batch:
#: the one straggler, redeemed by process 0 (straggler 0 of the list)
_REDEEM = dict(redeem=True, overlap=0.99, threshold=0.99)


def test_two_process_redemption_equals_one_process(tmp_path):
    """Straggler redemption over two processes: process 0 redeems the
    one straggler, the gather gives process 1 its answer, and both
    return what one process's ``register_batch`` of the same pairs
    returns, bit for bit."""
    by_pid = _spawn_job(dict(_REDEEM, alone=True), tmp_path)
    _same_on_both(by_pid)
    a, b = by_pid[0], by_pid[1]
    alone = a.pop("alone")
    for key in ("n_trials", "escalated", "redeemed_by", "factor"):
        assert a[key] == b[key], key
    for key in ("scores", "improved", "transforms", "n_trials",
                "escalated", "redeemed_by", "factor"):
        assert a[key] == alone[key], key
    assert a["escalated"] == [None, 2.0] and a["factor"] == [None, 2.0]
    assert a["redeemed_by"] == [None, 0] and a["scores"][1] == 0.995
    assert a["n_trials"][1] == a["trials"] + 64
    assert a["counters"] == dict(stragglers=1, redeemed_here=1,
                                 redeem_kept=1)
    assert b["counters"] == dict(stragglers=1, redeemed_here=0,
                                 redeem_kept=1)
    assert alone["counters"] == a["counters"]
    assert alone["exchange_s"] is None and b["exchange_s"] > 0


def test_two_process_redemption_with_an_empty_share_does_not_hang(
        tmp_path):
    """Process 1 has no straggler to redeem and its visitor sleeps on
    every call; it still enters the one gather and waits there for
    process 0's redemption (a second), and the job ends with the same
    results on both."""
    by_pid = _spawn_job(dict(_REDEEM, slow_rank=1, sleep=0.15,
                             redeem_sleep=1.0), tmp_path)
    _same_on_both(by_pid)
    assert by_pid[1]["redeemed_by"] == [None, 0]
    assert by_pid[1]["counters"]["redeemed_here"] == 0
    assert by_pid[1]["exchange_s"] >= 0.5


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_straggler_split_and_merge(world):
    """Every process computes the same list, worst first; straggler j
    goes to process j mod world, so the shares cover the list once. The
    merge keeps, in list order, the answers that improved and beat the
    batch's LCP, flagged with the escalated factor."""
    import numpy as np
    from super4pcs_tpu_torch.matcher import RegistrationResult
    from super4pcs_tpu_torch.parallel import batch
    lcp = np.float32([0.9, 0.2, 0.5, 0.2, 0.95, 0.1, 0.69])
    order = batch.straggler_order(lcp, 0.7)
    assert order == [5, 1, 3, 2, 6]
    shares = [batch.straggler_share(order, r, world) for r in range(world)]
    assert sorted(sum(shares, [])) == sorted(order)
    assert shares[0][0] == 5 and all(
        order.index(i) % world == r for r, share in enumerate(shares)
        for i in share)

    def answer(score, improved):
        return RegistrationResult(score=score, transform=np.eye(4),
                                  transformed_q=None, n_trials=1,
                                  improved=improved, stats={})

    answers = {6: answer(0.8, True), 1: answer(0.2, True),
               3: answer(0.9, False), 2: answer(0.75, True)}
    kept = batch.merge_redeemed(order, answers, lcp, 2.0)
    assert list(kept) == [2, 6]
    assert all(kept[i] is answers[i] for i in kept)
    assert [answers[i].stats for i in (6, 1, 3, 2)] == [
        {"straggler_escalated_to": 2.0}, {}, {},
        {"straggler_escalated_to": 2.0}]


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
