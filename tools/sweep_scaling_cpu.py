"""Measured multi-PROCESS sweep-scaling efficiency on CPU (r3 verdict #8).

The sweep axis is the one parallelism whose efficiency CAN be honestly
measured in this environment (work-parallel: zero in-solve collectives;
the only cross-process traffic is the final replicating gather). This
tool runs the SAME sweep program — same 8-device global mesh, same
t-grid, same per-device work — decomposed across 1, 2, and 4 real OS
processes via jax.distributed (parallel/launch.py --mode sweep), and
reports the wall-time ratio vs the single-process baseline.

Ideal = flat time (the per-device work is identical in every row; only
the process decomposition changes), so

    efficiency(N) = t(1 process) / t(N processes)

isolates exactly the process-boundary cost the SCALING.md analytic model
claims is negligible for sweep parallelism. NOT a GPU number — CPU
devices behind a distributed service — but it validates the claimed
near-linear sweep scaling with a real multi-process measurement instead
of an argument.

Usage: python tools/sweep_scaling_cpu.py [--devices 8] [--m 1024] [--n 512]
       [--maxit 400]
Writes one JSON line per configuration + a summary; paste the table into
SCALING.md.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_config(nproc, devices_total, m, n, maxit, x64=False):
    dpp = devices_total // nproc
    out = os.path.join(tempfile.mkdtemp(), "sweep.json")
    cmd = [
        sys.executable, "-m", "adaprox_tpu.parallel.launch",
        "--spawn", str(nproc), "--devices-per-process", str(dpp),
        "--mode", "sweep", "--backend", "cpu",
        "--m", str(m), "--n", str(n), "--maxit", str(maxit),
        "--tol", "0.0", "--t-count", str(devices_total),
        "--out", out,
    ]
    if x64:
        cmd.append("--x64")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(
            f"nproc={nproc} failed rc={r.returncode}:\n{r.stderr[-2000:]}")
    with open(out) as fh:
        return json.load(fh)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8,
                   help="global device count, fixed across configurations")
    p.add_argument("--m", type=int, default=1024)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--maxit", type=int, default=400)
    p.add_argument("--procs", default="1,2,4")
    args = p.parse_args()

    rows = {}
    base = None
    for nproc in (int(v) for v in args.procs.split(",")):
        if args.devices % nproc:
            print(json.dumps({"processes": nproc,
                              "error": "devices % nproc != 0"}), flush=True)
            continue
        payload = run_config(nproc, args.devices, args.m, args.n, args.maxit)
        t = payload["timed_s"]
        # the efficiency denominator is the 1-PROCESS run specifically —
        # not whichever config happened to be listed first in --procs
        if nproc == 1:
            base = t
        row = {
            "processes": nproc,
            "devices_per_process": args.devices // nproc,
            "global_devices": payload["global_devices"],
            "t_count": payload["t_count"],
            "timed_s": t,
            "efficiency_vs_1proc": round(base / t, 4),
        }
        rows[nproc] = row
        print(json.dumps(row), flush=True)

    print(json.dumps({
        "summary": "sweep-axis multi-process scaling (CPU devices)",
        "fixed": {"devices": args.devices, "m": args.m, "n": args.n,
                  "maxit": args.maxit},
        "efficiency": {str(k): v["efficiency_vs_1proc"]
                       for k, v in rows.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
