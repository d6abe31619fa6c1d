"""Scaling-efficiency benchmark harness (BASELINE.json: ">=80% iterations/s
scaling efficiency at 1 chip, 1 host, N>=2 hosts").

Measures AdaPGM iterations/s on a row-sharded lasso across growing mesh
sizes, in two regimes:

  * strong scaling — fixed global problem, more devices;
  * weak scaling   — fixed per-device rows, problem grows with the mesh;
  * sweep scaling  — the OTHER parallel axis: a fixed Malitsky-Pock
    t-sweep, the engine vmapped over t, with its sweep dimension sharded
    over the mesh (parallel/sweep.py). Zero collectives inside the solves,
    so this is the embarrassingly-parallel ceiling the operand-sharded
    modes are measured against.

Emits one JSON line per mesh size with iterations/s and efficiency vs the
single-device run. On several GPUs this is the real measurement; on the
CPU it validates the harness and the compiled collective program (set
--cpu N to use N virtual CPU devices).

Multi-host: launch the same script under `jax.distributed` on every host
(parallel.mesh.distributed_init runs first when --multihost is passed).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def measure(mesh_devices, m, n, iters, dtype_name="float32"):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.parallel.mesh import COLS, ROWS, make_mesh, shard_array
    from adaprox_tpu.utils.profiling import timed

    dtype = jnp.dtype(dtype_name)
    mesh = make_mesh((len(mesh_devices), 1), devices=mesh_devices)
    key = jax.random.PRNGKey(0)
    # NB float(...): a raw np.float64 scalar is strong-typed in JAX and
    # would silently promote the f32 matrix to f64 under jax_enable_x64
    a = shard_array(
        jax.random.normal(key, (m, n), dtype) * float(1.0 / np.sqrt(n)),
        mesh, P(ROWS, COLS),
    )
    b = shard_array(jax.random.normal(jax.random.PRNGKey(1), (m,), dtype), mesh, P(ROWS))
    x0 = shard_array(jnp.zeros(n, dtype), mesh, P(COLS))
    f = LeastSquares(a=a, b=b)
    g = ap.L1Norm(lam=jnp.asarray(0.01, dtype))

    def run():
        res = ap.adaptive_proxgrad(
            x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=jnp.asarray(1e-3, dtype)),
            tol=0.0, maxit=iters, history=False,
        )
        return res.norm_res

    secs, _ = timed(run)
    return iters / secs


def mp_t_sweep(a, bv, ts, *, maxit, lam=0.1):
    """x of every cell of a square-root-lasso Malitsky-Pock t-sweep: the
    engine vmapped over the coupling t (tol=0 pins each cell's work to
    ``maxit`` iterations). A sweep launcher for parallel/sweep.py."""
    import jax
    import jax.numpy as jnp

    import adaprox_tpu as ap

    m, n = a.shape
    h = ap.Translate(inner=ap.L2Norm(lam=1.0), b=-bv)

    def one(t):
        return ap.malitsky_pock(
            jnp.zeros(n, a.dtype), jnp.zeros(m, a.dtype), f=ap.ZeroSmooth(),
            g=ap.L1Norm(lam=lam), h=h, A=ap.DenseOperator(a=a), t=t,
            sigma=1.0, tol=0.0, maxit=maxit).x

    return jax.vmap(one)(ts)


def measure_sweep(mesh_devices, m, n, t_count, maxit):
    """Executed sweep cells/s for a sweep-sharded Malitsky-Pock t-sweep
    (each cell is a full maxit-iteration solve). Counts the PADDED cell
    total: when t_count does not divide the mesh, the edge-repeat pad cells
    are full extra solves — dividing by the unpadded count would bias
    throughput (and efficiency vs the unpadded 1-device baseline) low."""
    import functools

    import jax.numpy as jnp

    from adaprox_tpu.parallel.sweep import sharded_sweep, sweep_mesh
    from adaprox_tpu.utils.profiling import timed

    mesh = sweep_mesh(devices=mesh_devices)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    bv = jnp.asarray(rng.standard_normal(m), jnp.float32)
    ts = jnp.asarray(np.geomspace(0.1, 10.0, t_count), jnp.float32)
    fn = functools.partial(mp_t_sweep, maxit=maxit)

    def run():
        return sharded_sweep(fn, mesh, {"a": a, "bv": bv, "ts": ts}, {"ts"})

    secs, _ = timed(run)
    nd = len(mesh_devices)
    executed = -(-t_count // nd) * nd  # edge-repeat pad cells are real work
    return executed / secs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=None,
                   help="global rows (strong) / per-device rows (weak); "
                        "defaults: 8192 operand modes, 1024 sweep mode")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--mode", choices=["strong", "weak", "sweep"],
                   default="strong")
    p.add_argument("--tcount", type=int, default=32,
                   help="sweep mode: number of sweep cells (fixed total work)")
    p.add_argument("--devices", type=int, default=0, help="0 = all available")
    p.add_argument("--cpu", type=int, default=0, help="N>0: use N virtual CPU devices")
    p.add_argument("--multihost", action="store_true")
    args = p.parse_args(argv)
    if args.m is None:
        args.m = 1024 if args.mode == "sweep" else 8192
    if args.n is None:
        args.n = 512 if args.mode == "sweep" else 4096

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    if args.multihost:
        from adaprox_tpu.parallel.mesh import distributed_init

        distributed_init()

    devices = jax.devices()
    # clamp to what exists: devices[:nd] on a short list would silently run
    # a smaller mesh while the JSON row claims nd devices
    n_max = min(args.devices or len(devices), len(devices))
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_max]

    base_ips = None
    for nd in sizes:
        if args.mode == "sweep":
            # strong scaling over the sweep axis: fixed t grid, more devices
            m = args.m
            ips = measure_sweep(devices[:nd], m, args.n, args.tcount,
                                args.iters)
            unit = "cells/s"
        else:
            m = args.m if args.mode == "strong" else args.m * nd
            ips = measure(devices[:nd], m, args.n, args.iters)
            unit = "iter/s"
        if base_ips is None:
            base_ips = ips
        if args.mode == "weak":
            # ideal: iterations/s stays flat as the problem grows with mesh
            eff = ips / base_ips
        else:
            # ideal: throughput scales with devices
            eff = ips / (base_ips * nd)
        print(json.dumps({
            "metric": f"scaling_{args.mode}_{unit.replace('/', '_per_')}",
            "devices": nd,
            "rows": m,
            "cols": args.n,
            "value": round(ips, 2),
            "unit": unit,
            "efficiency": round(eff, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
