"""Benchmark: AdaPGM hot-loop throughput on synthetic lasso, on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The reference publishes no wall-clock numbers (BASELINE.md); its figure of
merit is convergence vs oracle calls (asserted by tests/test_solvers.py).
An AdaPGM iteration needs A@x (f-eval) and A'res (pullback):

  * XLA path: two passes over A per iteration.
  * One-pass GPU kernel (ops.kernels.fused_ls_value_grad): one read of A
    from device memory per iteration.

``vs_baseline`` = achieved bandwidth / the device's published memory
bandwidth (utils/profiling.PEAKS), counting one pass per iteration for the
fused path and two for the XLA path. Each timing ends in
``jax.block_until_ready``. The line names the platform, device kind,
device count, and the card's name and power limit. Without a GPU the
script exits non-zero and prints no result.
"""

import json
import os
import statistics
import sys
import time

import numpy as np


def _sync(out):
    import jax

    jax.block_until_ready(out)


def time_solve(run, reps=3):
    best = float("inf")
    out = run()
    _sync(out)  # compile + settle
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def time_interleaved(runners, rounds=4):
    """Round-robin timing: compile every runner, then time them interleaved
    for ``rounds`` passes, returning per-runner (best, median) seconds.
    Interleaving puts every variant through the same clock and power state
    of the card; best-of rejects transient spikes."""
    for fn in runners.values():
        _sync(fn())  # compile + settle
    times = {name: [] for name in runners}
    for _ in range(rounds):
        for name, fn in runners.items():
            t0 = time.perf_counter()
            _sync(fn())
            times[name].append(time.perf_counter() - t0)
    return {name: (min(ts), statistics.median(ts)) for name, ts in times.items()}


def device_fields():
    """What every result line carries about where it ran."""
    import jax

    from adaprox_tpu.platform import gpu_name_and_power_limit

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit()}


def measure(m, n, iters, interpret=False, peak_gbps=None,
            ref_size=(4000, 1000)):
    """Run every cell and return the result payload. ``interpret`` runs the
    one-pass kernel in the Pallas interpreter, and ``ref_size`` shrinks the
    reference-size cells (the CPU test of this script); ``peak_gbps``
    defaults to the device's published bandwidth."""
    import jax
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.models.synthetic import random_lasso
    from adaprox_tpu.utils.profiling import device_peaks

    dtype = jnp.float32
    peak = peak_gbps or device_peaks().hbm_gbps

    # large on-device problem for throughput (no host transfer of A)
    a = jax.random.normal(jax.random.PRNGKey(0), (m, n), dtype) * float(1.0 / np.sqrt(n))
    b = jax.random.normal(jax.random.PRNGKey(1), (m,), dtype)
    x0 = jnp.zeros(n, dtype)
    g = ap.L1Norm(lam=jnp.asarray(0.01, dtype))
    gamma0 = jnp.asarray(1e-3, dtype)
    a_bf16 = a.astype(jnp.bfloat16)

    def ls(a_mat, fused):
        return LeastSquares(a=a_mat, b=b, fused=fused, interpret=interpret)

    def make_run(fused, bf16=False, n_it=None):
        f = ls(a_bf16 if bf16 else a, fused)
        n_it = iters if n_it is None else n_it

        def run():
            res = ap.adaptive_proxgrad(
                x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=gamma0),
                tol=0.0, maxit=n_it, history=False,
            )
            return res.norm_res, res.numit

        return run

    yv = jax.random.normal(jax.random.PRNGKey(5), (m,), dtype)
    h = ap.Translate(inner=ap.L2Norm(lam=jnp.asarray(1.0, dtype)), b=-yv)
    rule_pd = ap.AdaPGMRule.make(t=1.0, norm_a=float(jnp.sqrt(jnp.sum(a * a))))
    y0_pd = jnp.zeros(m, dtype)

    def make_run_pd(a_mat, n_it):
        def run():
            res = ap.adaptive_primal_dual(
                x0, y0_pd, f=ap.ZeroSmooth(), g=g, h=h,
                A=ap.DenseOperator(a=a_mat), rule=rule_pd,
                tol=0.0, maxit=n_it, history=False)
            return res.norm_res, res.numit
        return run

    # name -> (runner, passes over A per iter, bytes/elem, iters); bf16
    # variants run 2x the iterations to equalize wall time per measurement
    spec = {
        "xla": (make_run(False), 2, 4, iters),
        "fused": (make_run(True), 1, 4, iters),
        "fused_bf16": (make_run(True, bf16=True, n_it=2 * iters), 1, 2, 2 * iters),
        "pd_xla": (make_run_pd(a, iters), 2, 4, iters),
        "pd_xla_bf16": (make_run_pd(a_bf16, 2 * iters), 2, 2, 2 * iters),
    }
    results = {}
    runners = {}
    for name, (fn, _, _, reps_n) in spec.items():
        out = fn()
        _sync(out)
        # a NaN residual exits the while_loop early (NaN > 0 is False) and
        # would silently inflate iters_per_sec — reject it
        if int(out[1]) != reps_n:
            raise RuntimeError(f"{name}: early exit at numit={int(out[1])}, "
                               f"expected {reps_n}")
        runners[name] = fn
    for name, (best_s, med_s) in time_interleaved(runners, rounds=4).items():
        _, passes, nbytes, reps_n = spec[name]
        gbps = passes * m * n * nbytes * reps_n / best_s / 1e9
        results[name] = {
            "iters_per_sec": round(reps_n / best_s, 2),
            "achieved_gbps": round(gbps, 1),
            "frac_peak": round(gbps / peak, 4),
            # spread across the interleaved rounds (median/best - 1)
            "spread": round(med_s / best_s - 1, 4),
        }
    results["fused"]["speedup_vs_xla"] = round(
        results["fused"]["iters_per_sec"] / results["xla"]["iters_per_sec"], 3)

    # headline metric: best FULL-f32 variant; bf16 storage stays in detail.
    # The metric NAME is pinned to the fused series whichever variant won;
    # ``variant`` records what actually ran.
    best_name = max(("xla", "fused"), key=lambda k: results[k]["iters_per_sec"])
    best = results[best_name]

    # the reference's largest lasso (4000x1000) to residual 1e-4 on the
    # engine: per-iteration overhead, not bandwidth, bounds it
    m_r, n_r = ref_size
    prob_r = random_lasso(m=m_r, n=n_r, pfactor=10, seed=0)
    f_r = LeastSquares(a=jnp.asarray(prob_r.a, dtype), b=jnp.asarray(prob_r.b, dtype))
    lf_r = float(np.linalg.norm(prob_r.a, 2) ** 2)

    def run_ref(f_ref=f_r):
        res = ap.adaptive_proxgrad(
            jnp.zeros(n_r, dtype), f=f_ref, g=ap.L1Norm(lam=jnp.asarray(1.0, dtype)),
            rule=ap.AdaPGMRule(gamma=jnp.asarray(1 / lf_r, dtype)),
            tol=1e-4, maxit=20_000)
        return res.norm_res, res.numit

    dt_r, out_r = time_solve(run_ref)
    results["reference_size"] = {
        "solve_ms": round(dt_r * 1e3, 3), "numit": int(out_r[1]),
        "iters_per_sec": round(int(out_r[1]) / dt_r, 1),
    }

    # 16-value regularization path at 4000x1000: one vmapped program vs
    # the sequential loop
    from adaprox_tpu.solvers.batch import regularization_path

    lams = jnp.asarray(np.geomspace(0.05, 5.0, 16), dtype)
    it_b = 300

    def run_batched():
        res = regularization_path(
            jnp.zeros(n_r, dtype), f=f_r, lams=lams,
            gamma=jnp.asarray(1 / lf_r, dtype), tol=0.0, maxit=it_b)
        return res.norm_res

    def run_sequential():
        return jnp.stack([ap.adaptive_proxgrad(
            jnp.zeros(n_r, dtype), f=f_r, g=ap.L1Norm(lam=lams[i]),
            rule=ap.AdaPGMRule(gamma=jnp.asarray(1 / lf_r, dtype)),
            tol=0.0, maxit=it_b).norm_res for i in range(lams.shape[0])])

    dt_bat, _ = time_solve(run_batched)
    dt_seq, _ = time_solve(run_sequential)
    results["batched_regpath_16x4000x1000"] = {
        "batched_s": round(dt_bat, 4), "sequential_s": round(dt_seq, 4),
        "speedup": round(dt_seq / dt_bat, 2),
    }

    # time to residual 1e-4: bf16 storage can inflate iterations, so
    # per-iteration speed says nothing about solution time on its own
    def to_tol(run):
        dt_s, out = time_solve(run, reps=2)
        return {"secs": round(dt_s, 6), "numit": int(out[1]),
                "final_res": float(out[0])}

    def run_big(a_mat):
        f_t = ls(a_mat, True)
        return lambda: (lambda r: (r.norm_res, r.numit))(ap.adaptive_proxgrad(
            x0, f=f_t, g=g, rule=ap.AdaPGMRule(gamma=gamma0),
            tol=1e-4, maxit=20_000, history=False))

    ttr = {"target_res": 1e-4, "fused_f32": to_tol(run_big(a)),
           "fused_bf16": to_tol(run_big(a_bf16))}
    f_r16 = LeastSquares(a=jnp.asarray(prob_r.a, jnp.bfloat16),
                         b=jnp.asarray(prob_r.b, dtype))
    ttr["reference_f32"] = to_tol(run_ref)
    ttr["reference_bf16"] = to_tol(lambda: run_ref(f_r16))
    results["time_to_res"] = ttr

    # live-telemetry overhead: plain history=False solve vs the chunked
    # live solve on the SAME problem, interleaved best-of-2
    from adaprox_tpu.utils.live import live_solve, logstep_boundaries

    f_live = ls(a, True)
    live_iters = max(iters, 2000)

    def live_solve_fn(maxit, resume_state, it_cap):
        return ap.adaptive_proxgrad(
            x0, f=f_live, g=g, rule=ap.AdaPGMRule(gamma=gamma0),
            tol=0.0, maxit=maxit, resume_state=resume_state, it_cap=it_cap)

    def wall_plain():
        t0 = time.perf_counter()
        _sync(live_solve_fn(live_iters, None, None).norm_res)
        return time.perf_counter() - t0

    def wall_live():
        t0 = time.perf_counter()
        res_l, _ = live_solve(live_solve_fn, live_iters, method="AdaPGM",
                              out=lambda s_: None)
        _sync(res_l.norm_res)
        return time.perf_counter() - t0

    wall_plain(); wall_live()  # compile + settle
    pw = lw = float("inf")
    for _ in range(2):
        pw = min(pw, wall_plain())
        lw = min(lw, wall_live())
    results["live_telemetry"] = {
        "iters": live_iters, "plain_s": round(pw, 4), "live_s": round(lw, 4),
        "boundaries": len(logstep_boundaries(live_iters)),
        "overhead_frac": round((lw - pw) / max(pw, 1e-9), 4),
    }

    # convergence sanity on the known-optimum problem (f32, small)
    prob = random_lasso(m=1024, n=2048, pfactor=10, seed=0)
    f_small = LeastSquares(a=jnp.asarray(prob.a, dtype), b=jnp.asarray(prob.b, dtype))
    g1 = ap.L1Norm(lam=jnp.asarray(1.0, dtype))
    lf = float(np.linalg.norm(prob.a, 2) ** 2)
    res = ap.adaptive_proxgrad(
        jnp.zeros(2048, dtype), f=f_small, g=g1,
        rule=ap.AdaPGMRule(gamma=jnp.asarray(1 / lf, dtype)), tol=1e-5, maxit=4000,
    )
    gap = float(f_small.value(res.x) + g1(res.x)) - prob.optimum

    return {
        "metric": f"lasso_adapgm_iters_per_sec_{m}x{n}_f32_fused",
        "value": best["iters_per_sec"],
        "unit": "iter/s",
        "vs_baseline": best["frac_peak"],
        "variant": best_name,
        "peak_gbps": peak,
        "detail": results,
        "convergence_gap_f32": gap,
        "numit_to_1e-5": int(res.numit),
    }


def main():
    import jax

    from adaprox_tpu.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    payload = measure(int(os.environ.get("BENCH_M", 16384)),
                      int(os.environ.get("BENCH_N", 16384)),
                      int(os.environ.get("BENCH_ITERS", 200)))
    print(json.dumps({**payload, **device_fields()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
