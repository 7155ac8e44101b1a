"""The launcher of a run over several cards: one process a card.

``run.py`` starts ``n`` processes of itself on a free loopback address,
process ``r`` on card ``r`` (``ranks.py``), and waits for all of them
under one time limit. When one fails or the limit passes, it kills all
of them and the run fails with no result line. Otherwise it passes on
the others' standard error (its end), then process 0's, so that the
checks stay the last lines, and returns process 0's standard output,
whose last line is the result.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

#: seconds the processes of one run may take together: a first run in a
#: checkout builds the kernels
LIMIT_S = 1100.0
#: the characters of each other process's standard error passed on
TAIL = 4000


def free_address() -> str:
    """A free loopback address for the job's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def die_with(parent: int):
    """End this process when its launcher ``parent`` ends (Linux's
    parent-death signal), and now if it already has."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
        prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
        prctl.restype = ctypes.c_int
        prctl(1, signal.SIGKILL)    # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _text(f) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")


def launch(script: str, args: list, n: int, limit_s: float = LIMIT_S
           ) -> tuple:
    """Run ``n`` processes of ``script args --coordinator <address>
    --rank <r> --parent <this pid>`` to their end; returns (exit code,
    process 0's standard output), the code 0 only when every process
    exited 0 within ``limit_s`` seconds."""
    addr = free_address()
    outs = [tempfile.TemporaryFile() for _ in range(n)]
    errs = [tempfile.TemporaryFile() for _ in range(n)]
    procs = []

    def stop():
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    def ended(signum, frame):
        stop()
        sys.exit(128 + signum)

    old = signal.signal(signal.SIGTERM, ended)
    failure = None
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, script, *args, "--coordinator", addr,
                 "--rank", str(r), "--parent", str(os.getpid())],
                stdout=outs[r], stderr=errs[r]))
        print(f"launched {n} processes, pids "
              f"{' '.join(str(p.pid) for p in procs)}", file=sys.stderr,
              flush=True)
        deadline = time.monotonic() + limit_s
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"process {bad[0][0]} exited {bad[0][1]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = f"the processes ran past {limit_s:.0f} s"
            else:
                time.sleep(0.1)
    finally:
        stop()
        signal.signal(signal.SIGTERM, old)
    for r in range(1, n):
        print(f"--- process {r} (exit {procs[r].returncode}), standard "
              f"error, its end:\n{_text(errs[r])[-TAIL:]}", file=sys.stderr)
    print(f"--- process 0 (exit {procs[0].returncode}), standard error:\n"
          f"{_text(errs[0])}", file=sys.stderr, flush=True)
    out = _text(outs[0])
    for f in outs + errs:
        f.close()
    if failure:
        print(f"run failed: {failure}; every process was ended",
              file=sys.stderr, flush=True)
        return 1, ""
    return 0, out
