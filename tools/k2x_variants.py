#!/usr/bin/env python3
"""Time variants of K2x (csrc/rowcap_layout.cu) on one CUDA card, at the
shapes of chip_smoke.py's phase 4c (nq 8192 T 16, the same at T 64,
nq 8192 T 16 with the four filters, nq 32768 T 16), with the rejection
on.

Each variant is the kernel's source with text replacements, or another
source file; each is built with the port's nvcc flags (all builds
started together) and loaded in place of the current build, then timed
by profiler device time (chip_smoke._kernel_ms) in turns: every variant
in order, then in reverse order. A variant whose output differs from the
current source's is marked DIFFERS (a variant that only measures a
cost, such as one that skips the stores, may differ on purpose).

    python3 tools/k2x_variants.py '{"base": [], "tile1024": [["static
        constexpr int TILE = kFilt ? 256 : 512;", "static constexpr int
        TILE = kFilt ? 256 : 1024;"]], "old": "path/to/rowcap_layout.cu"}'
        [--out DIR]

Run from the repository root; builds go to DIR (default
super4pcs_tpu_torch/_build/k2x_variants, beside the kernels' own
builds).
"""

import ctypes
import json
import os
import subprocess
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2x_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import bench
    import chip_smoke as cs
    import super4pcs_tpu_torch as s4
    from super4pcs_tpu_torch.kernels import _build
    from super4pcs_tpu_torch.kernels import rowcap_layout as k2x
    from super4pcs_tpu_torch.ops import select

    spec = json.loads(sys.argv[1])
    out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
           else str(_build.BUILD_DIR / "k2x_variants"))
    os.makedirs(out, exist_ok=True)
    src = (_build.CSRC / "rowcap_layout.cu").read_text()
    procs = {}
    for name, reps in spec.items():
        text = open(reps).read() if isinstance(reps, str) else src
        for old, new in ([] if isinstance(reps, str) else reps):
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(name, [ln.strip() for ln in log.splitlines()
                     if "registers" in ln], flush=True)
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rowcap_layout.argtypes = [p] * 8 + [i] * 10 + [f, f, p, p, p]
        lib.rowcap_layout.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    P, Q = bench.fine_delta_pair()
    opts = cs._headline_options(s4)
    p_pos, q_pos = cs._samples(s4, P, Q, opts.delta, opts.sample_size,
                               opts.random_seed, dev)
    fP, fQ = cs._filtered_clouds(P, Q, s4)
    cases = cs._layout_cases(s4, P, Q, fP, fQ, p_pos, q_pos, opts, dev)[:3]
    cases.insert(1, ("nq=8192 T=64",) + cases[0][1:4] + (64,)
                 + cases[0][5:])
    gen = torch.Generator(device=dev)
    current = _build.load("rowcap_layout")
    for label, q, p, cfg, nt, row_cap, eps in cases:
        n = q[0].shape[0]
        gen.manual_seed(nt + n)
        ids, _, _, _ = select.select_base(
            p[0], float(torch.linalg.vector_norm(q[0], dim=1).max() * 2),
            *select.draw_base_indices(gen, p[0].shape[0], nt, 1000))
        bases = tuple(c[ids] for c in p)
        offs = torch.randint(0, n, (nt,), generator=gen, device=dev)
        args = (*(c[None] for c in q), *bases)
        rb = k2x.reject_bounds(args[0])

        def call():
            return k2x.rowcap_layout(*args, eps, cfg, row_cap,
                                     col_offset=offs, bounds=rb)

        _build._libs["rowcap_layout"] = current
        ref = call()
        line = [label]
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                _build._libs["rowcap_layout"] = libs[name]
                got = call()
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for a, b in zip(got, ref)
                           for x, y in zip(a, b))
                ms = cs._kernel_ms(call, cs.K2X_NAME, reps=10)
                line.append(f"{name} {ms:.4f}" + ("" if same
                                                  else " DIFFERS"))
        _build._libs["rowcap_layout"] = current
        print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
