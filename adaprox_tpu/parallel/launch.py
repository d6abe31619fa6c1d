"""Multi-process (multi-host) launch of the sharded solver program.

The reference is single-process (SURVEY.md §2.4); this is the net-new
multi-process component: the SAME SPMD solve that runs on one device spans
processes once ``jax.distributed`` is initialized — the program text does
not change, only the device set behind the mesh.

Launch modes:

  * ``--spawn N``          — convenience: fork N local worker processes and
    wait. With ``--backend cpu`` each gets ``--devices-per-process``
    virtual CPU devices, which exercises the real multi-process runtime
    (cross-process collectives over the distributed service) on one host:

        python -m adaprox_tpu.parallel.launch --spawn 2 \\
            --devices-per-process 4 --m 512 --n 128 --maxit 300 \\
            --out /tmp/dist.json

    With ``--backend gpu`` each process gets ONE card of the host through
    ``CUDA_VISIBLE_DEVICES`` (a JAX process reserves most of a card's
    memory, so two processes must never share one). One process over all
    cards (no ``--spawn``) is the simpler layout on a single host.

  * worker mode (used by --spawn, or run manually on each host):

        python -m adaprox_tpu.parallel.launch --backend gpu \\
            --coordinator host0:12345 --num-processes 2 --process-id i ...

Every process builds the same deterministic problem (models.synthetic),
shards it over the global ("rows", "cols") mesh via
``jax.make_array_from_callback`` (each process materializes only its
addressable shards), and runs AdaPGM. The iterate ``x`` lands replicated
(P(cols) with a 1-wide cols axis), so process 0 can read it whole and write
the result artifact for comparison against a single-process run.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_global(np_arr, mesh, spec):
    """Materialize a global array on a (possibly multi-process) mesh: each
    process fills only its addressable shards from the deterministic host
    copy."""
    import jax
    from jax.sharding import NamedSharding

    return jax.make_array_from_callback(
        np_arr.shape, NamedSharding(mesh, spec), lambda idx: np_arr[idx])


def _worker_sweep(args) -> int:
    """Sweep-axis (work) parallelism across the PROCESS boundary: a
    Malitsky-Pock t-sweep (experiments.scaling.mp_t_sweep, the engine
    vmapped over t) with its sweep dim sharded over the global mesh
    (parallel/sweep.py). No collectives inside the solves; the final
    replicating gather of the outputs is the only cross-process traffic.
    T must divide the global device count here (the edge-repeat pad path
    is covered by the single-process tests)."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adaprox_tpu.experiments.scaling import mp_t_sweep
    from adaprox_tpu.parallel.sweep import SWEEP, sharded_sweep, sweep_mesh

    pid, nproc = jax.process_index(), jax.process_count()
    devices = jax.devices()
    mesh = sweep_mesh(devices=devices)
    dtype = jnp.float64 if args.x64 else jnp.float32

    rng = np.random.default_rng(3)
    a_np = rng.standard_normal((args.m, args.n)).astype(dtype)
    bv_np = rng.standard_normal(args.m).astype(dtype)
    # --t-count pins the sweep size independently of the device count so a
    # scaling measurement can hold TOTAL work fixed while varying the
    # process decomposition (tools/sweep_scaling_cpu.py); default keeps the
    # one-cell-per-device behavior
    t_count = args.t_count or len(devices)
    ts_np = np.geomspace(0.1, 10.0, t_count).astype(dtype)

    arrays = {"a": _make_global(a_np, mesh, P()),
              "bv": _make_global(bv_np, mesh, P()),
              "ts": _make_global(ts_np, mesh, P(SWEEP))}
    fn = functools.partial(mp_t_sweep, maxit=args.maxit)
    x_sharded = sharded_sweep(fn, mesh, arrays, {"ts"})

    # replicate the sweep-sharded outputs so every process can read them
    # whole — the compiled all-gather IS the cross-process hop.
    # ONE jitted gather reused everywhere: jit caches key on function
    # identity, so a fresh jit(lambda) per call would retrace inside the
    # timed loop below and land lowering cost in timed_s (review r5-5)
    _gather = jax.jit(lambda u: u, out_shardings=NamedSharding(mesh, P()))

    def rep(v):
        return np.asarray(_gather(v))

    x_full = rep(x_sharded)

    # timed reps AFTER the compile+first-execution above: each rep runs the
    # sharded sweep and forces global completion through the replicating
    # gather of its output — the same sync every process sees, so process
    # 0's best-of-3 is the program's wall time.
    import time as _time

    best_s = float("inf")
    for _ in range(3):
        t0 = _time.perf_counter()
        rep(sharded_sweep(fn, mesh, arrays, {"ts"}))
        best_s = min(best_s, _time.perf_counter() - t0)

    if pid == 0:
        payload = {
            "processes": nproc,
            "global_devices": len(devices),
            "t_count": t_count,
            "timed_s": round(best_s, 4),
            "x_norms": [float(v) for v in np.linalg.norm(x_full, axis=1)],
        }
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(payload, fh)
            np.save(args.out + ".x.npy", x_full)
        print(json.dumps(payload), flush=True)
    return 0


def worker(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu" if args.backend == "cpu"
                      else "cuda")
    jax.config.update("jax_enable_x64", bool(args.x64))

    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    if args.mode == "sweep":
        return _worker_sweep(args)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.models.synthetic import random_lasso
    from adaprox_tpu.parallel.mesh import COLS, ROWS, make_mesh

    pid, nproc = jax.process_index(), jax.process_count()
    devices = jax.devices()
    mesh = make_mesh((len(devices), 1), devices=devices)
    dtype = jnp.float64 if args.x64 else jnp.float32

    prob = random_lasso(m=args.m, n=args.n, pfactor=10, seed=0)
    a_np = np.asarray(prob.a, dtype)
    b_np = np.asarray(prob.b, dtype)

    a = _make_global(a_np, mesh, P(ROWS, COLS))
    b = _make_global(b_np, mesh, P(ROWS))
    x0 = _make_global(np.zeros(args.n, dtype), mesh, P(COLS))

    f = LeastSquares(a=a, b=b)
    g = ap.L1Norm(lam=1.0)
    lf = float(np.linalg.norm(a_np, 2) ** 2)
    res = ap.adaptive_proxgrad(
        x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=1 / lf),
        tol=args.tol, maxit=args.maxit, history=False,
    )

    numit = int(res.numit)
    norm_res = float(res.norm_res)
    obj = float(f.value(res.x) + g(res.x))
    x_full = np.asarray(res.x)  # replicated on the 1-wide cols axis

    if pid == 0:
        out = {
            "processes": nproc,
            "global_devices": len(devices),
            "numit": numit,
            "norm_res": norm_res,
            "objective": obj,
            "x_norm": float(np.linalg.norm(x_full)),
            "grad_f_evals": int(res.counters.grad_f_evals),
        }
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh)
            np.save(args.out + ".x.npy", x_full)
        print(json.dumps(out), flush=True)
    return 0


def spawn(args) -> int:
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    base_env = dict(os.environ)
    if args.backend == "cpu":
        base_env["XLA_FLAGS"] = (
            base_env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices_per_process}"
        )
    procs = []
    for i in range(args.spawn):
        env = dict(base_env)
        if args.backend == "gpu":
            env["CUDA_VISIBLE_DEVICES"] = str(i)  # one card per process
        cmd = [
            sys.executable, "-m", "adaprox_tpu.parallel.launch",
            "--coordinator", coordinator,
            "--num-processes", str(args.spawn),
            "--process-id", str(i),
            "--backend", args.backend,
            "--m", str(args.m), "--n", str(args.n),
            "--maxit", str(args.maxit), "--tol", str(args.tol),
            "--mode", args.mode,
            "--t-count", str(args.t_count),
        ]
        if args.x64:
            cmd.append("--x64")
        if args.out and i == 0:
            cmd += ["--out", args.out]
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--spawn", type=int, default=0,
                   help="N>0: fork N local worker processes and wait")
    p.add_argument("--devices-per-process", type=int, default=4,
                   help="virtual CPU devices per spawned process (cpu)")
    p.add_argument("--coordinator", default="")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--backend", choices=("cpu", "gpu"), default="cpu")
    p.add_argument("--mode", choices=("lasso", "sweep"), default="lasso",
                   help="lasso: operand-sharded AdaPGM; sweep: sweep-axis-"
                        "sharded vmapped t-sweep (work parallelism)")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--maxit", type=int, default=300)
    p.add_argument("--t-count", type=int, default=0,
                   help="sweep mode: fixed sweep size (0 = one per device)")
    p.add_argument("--tol", type=float, default=0.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    if args.spawn:
        return spawn(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
