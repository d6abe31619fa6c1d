"""Multi-process (2-process) execution of the sharded solver program.

Spawns 2 real OS processes on localhost, each with 4 virtual CPU devices;
``jax.distributed`` connects them (Gloo collectives across the process
boundary), the 8-device global mesh spans both, and the
sharded AdaPGM trajectory must match a single-process solve of the same
problem.

Runs in subprocesses, so it does not disturb this process's JAX config.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares
from adaprox_tpu.models.synthetic import random_lasso

M, N, MAXIT = 256, 64, 200


def test_two_process_sweep_matches_single(tmp_path):
    """Sweep-axis (work) parallelism across a REAL process boundary: the
    vmapped Malitsky-Pock t-sweep sharded over the 8-device 2-process mesh
    must reproduce the single-process vmapped program — the only
    cross-process traffic is the final output gather."""
    from adaprox_tpu.experiments.scaling import mp_t_sweep

    m, n, maxit = 64, 32, 40
    out = tmp_path / "sweep.json"
    cmd = [
        sys.executable, "-m", "adaprox_tpu.parallel.launch",
        "--spawn", "2", "--devices-per-process", "4", "--x64",
        "--mode", "sweep", "--m", str(m), "--n", str(n),
        "--maxit", str(maxit), "--out", str(out),
    ]
    proc = subprocess.run(cmd, env=dict(os.environ), capture_output=True,
                          text=True, timeout=540)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(out.read_text())
    assert got["processes"] == 2 and got["global_devices"] == 8
    assert got["t_count"] == 8

    # single-process launch of the identical sweep (f64)
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal((m, n)))
    bv = jnp.asarray(rng.standard_normal(m))
    ts = jnp.asarray(np.geomspace(0.1, 10.0, 8))
    ref = mp_t_sweep(a, bv, ts, maxit=maxit)
    assert len(got["x_norms"]) == 8
    x_dist = np.load(str(out) + ".x.npy")
    # per-device batches reorder f64 sums in the batched products
    np.testing.assert_allclose(x_dist, np.asarray(ref), rtol=1e-8, atol=1e-12)


def test_two_process_matches_single(tmp_path):
    out = tmp_path / "dist.json"
    cmd = [
        sys.executable, "-m", "adaprox_tpu.parallel.launch",
        "--spawn", "2", "--devices-per-process", "4", "--x64",
        "--m", str(M), "--n", str(N), "--maxit", str(MAXIT),
        "--out", str(out),
    ]
    env = dict(os.environ)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=540)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(out.read_text())
    assert got["processes"] == 2
    assert got["global_devices"] == 8

    # single-process reference run (this process: CPU f64 via conftest)
    prob = random_lasso(m=M, n=N, pfactor=10, seed=0)
    f = LeastSquares(a=jnp.asarray(prob.a), b=jnp.asarray(prob.b))
    lf = float(np.linalg.norm(prob.a, 2) ** 2)
    res = ap.adaptive_proxgrad(
        jnp.zeros(N), f=f, g=ap.L1Norm(lam=1.0),
        rule=ap.AdaPGMRule(gamma=1 / lf), tol=0.0, maxit=MAXIT,
    )
    assert got["numit"] == int(res.numit)
    assert got["grad_f_evals"] == int(res.counters.grad_f_evals)
    # sharded matvecs reassociate reductions -> f64-level drift only
    x_single = np.asarray(res.x)
    x_dist = np.load(str(out) + ".x.npy")
    np.testing.assert_allclose(x_dist, x_single, rtol=1e-9, atol=1e-12)
    assert got["objective"] == pytest.approx(
        float(f.value(res.x) + ap.L1Norm(lam=1.0)(res.x)), rel=1e-10
    )
