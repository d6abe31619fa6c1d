"""Smoke run of the solver engine on the GPU, through its normal entry points.

    python chip_smoke.py           # one card: phases 1-6
    python chip_smoke.py --four    # four cards: the two sharded checks only

Phases (one card):

1. Device and compile check: platform, device kind and count, JAX version,
   the card's name and power limit; ``memory_analysis()`` of every jitted
   step below, printed once when it is compiled.
2. The reference lasso grid through ``experiments.lasso.main`` (three
   sizes, nine methods, maxit 2000, tol 1e-7, f32) against the analytic
   optimum; the 4000x1000 size again in f64 (AdaPGM rows must meet tol
   1e-7); the other six drivers once each at a reduced maxit on their
   synthetic-fallback data.
3. AdaPGM lasso at 16384^2 f32 (the bench's problem) with the XLA oracle
   and with the one-pass GPU kernel: iterates compared, the kernel alone
   compared with ``ls_value_grad_xla`` (f32, bf16 storage, the unaligned
   4000x1000, and rows wider than one tile), and both paths timed.
4. The square-root-lasso primal-dual iteration on the same matrix, f32
   against an f64 run on the card.
5. L1-logistic regression at the LIBSVM ``epsilon`` shape (400,000 x
   2,000 f32), f32 against an f64 run on the card.
6. ``regularization_path`` with 16 lambdas against the sequential loop.

With ``--four`` (four cards) only: the row-sharded AdaPGM lasso at
65536x16384 against the one-card solve, and ``regularization_path`` with
its lambda axis sharded on a ("sweep", "rows") mesh against the unsharded
result.

Every check states its reference and tolerance. Any failure raises, so the
script exits non-zero; it never falls back to the CPU. The last line of
standard output is one JSON object naming the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

CARD = ""  # "name, power limit" from nvidia-smi, set in main()


def say(phase, msg):
    print(f"[{phase}] {msg} | card: {CARD}", flush=True)


def check(phase, name, value, limit):
    """Fail unless ``value <= limit``; print both either way."""
    ok = bool(np.isfinite(value) and value <= limit)
    say(phase, f"{'PASS' if ok else 'FAIL'} {name}: {value:.3e} <= {limit:.1e}")
    if not ok:
        raise AssertionError(f"phase {phase}: {name} = {value!r} exceeds {limit!r}")


def rel(a, b):
    """||a - b|| / ||b|| in float64 on the host."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def compiled(phase, name, fn, *args):
    """jit ``fn``, compile it for ``args``, print its memory analysis once,
    and return the compiled executable."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    say(phase, f"compiled {name} in {time.perf_counter() - t0:.1f} s: "
               f"{exe.memory_analysis()}")
    return exe


class x64:
    """Run a block with float64 enabled; restore the previous setting."""

    def __enter__(self):
        import jax

        self.prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax

        jax.config.update("jax_enable_x64", self.prev)


def device_line():
    """The result line: the device as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}})


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


def phase1_device():
    import jax

    d = jax.devices()[0]
    say(1, f"platform={d.platform} device_kind={d.device_kind!r} "
           f"count={len(jax.devices())} jax={jax.__version__}")
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {d.platform!r}")


# --------------------------------------------------------------------------
# phase 2: the reference grid and the other drivers
# --------------------------------------------------------------------------

# Budget-bound baselines: fixed PG, backtracking PG (xi=1), backtracking
# Nesterov and aGRAAL do not converge within 2000 iterations even in f64
# (aGRAAL ends 1.2e-2 above F* at 500x1000), so the bound on every row is
# the menu's budget, 5e-2 relative. The AdaPGM rows converge: 1e-5
# relative is their f32 floor with a 60x margin (worst CPU f32 row 1.5e-7).
GAP_ALL = 5e-2
GAP_ADAPGM = 1e-5
ADAPGM_ROWS = ("AdaPGM (MM)", "AdaPGM (Ours)")


def _last_rows(path):
    from adaprox_tpu.utils.logging import read_jsonl

    last = {}
    for r in read_jsonl(path):
        if r.get("method"):
            last[r["method"]] = r
    return last


def phase2_drivers(outdir, sizes=((100, 300), (500, 1000), (4000, 1000)),
                   other_maxit=100, cpu=False):
    from adaprox_tpu.experiments import (cubic_sparse_logreg, dual_svm, lasso,
                                         least_absolute_deviation,
                                         nesterov_worst_case, sparse_logreg,
                                         square_root_lasso)
    from adaprox_tpu.models.synthetic import random_lasso

    flag = ["--cpu"] if cpu else []
    spec = ",".join(f"{m}x{n}x10" for m, n in sizes)
    t0 = time.perf_counter()
    lasso.main(["--outdir", f"{outdir}/lasso", "--sizes", spec, "--no-plot"]
               + flag)
    say(2, f"lasso grid (f32, maxit 2000, tol 1e-7) ran in "
           f"{time.perf_counter() - t0:.1f} s")
    for m, n in sizes:
        opt = random_lasso(m=m, n=n, pfactor=10, seed=0).optimum
        for name, r in _last_rows(f"{outdir}/lasso/lasso_{m}_{n}_10.jsonl").items():
            gap = abs(r["objective"] - opt) / abs(opt)
            limit = GAP_ADAPGM if name in ADAPGM_ROWS else GAP_ALL
            check(2, f"{m}x{n} {name} |F-F*|/|F*| (it={r['it']})", gap, limit)

    m, n = sizes[-1]
    with x64():
        lasso.main(["--outdir", f"{outdir}/lasso64", "--sizes", f"{m}x{n}x10",
                    "--f64", "--no-plot"] + flag)
    rows = _last_rows(f"{outdir}/lasso64/lasso_{m}_{n}_10.jsonl")
    for name in ADAPGM_ROWS:
        r = rows[name]
        check(2, f"f64 {m}x{n} {name} norm_res at it={r['it']} (< 2000)",
              r["norm_res"] if r["it"] < 2000 else np.inf, 1e-7)

    drivers = [
        ("sparse_logreg", sparse_logreg.main, []),
        ("dual_svm", dual_svm.main, []),
        ("square_root_lasso", square_root_lasso.main, []),
        ("least_absolute_deviation", least_absolute_deviation.main, []),
        ("cubic_sparse_logreg", cubic_sparse_logreg.main, []),
        ("nesterov_worst_case", nesterov_worst_case.main, []),
    ]
    for name, main, extra in drivers:
        t0 = time.perf_counter()
        main(["--outdir", f"{outdir}/{name}", "--maxit", str(other_maxit),
              "--no-plot"] + extra + flag)
        files = [f for f in os.listdir(f"{outdir}/{name}") if f.endswith(".jsonl")]
        worst = 0.0
        for fname in files:
            for r in _last_rows(f"{outdir}/{name}/{fname}").values():
                v = r.get("norm_res", r.get("objective"))
                if v is None or not np.isfinite(v):
                    raise AssertionError(f"phase 2: {name} {fname} {r}")
                worst = max(worst, abs(v))
        if not files:
            raise AssertionError(f"phase 2: {name} wrote no JSONL")
        say(2, f"PASS {name}: {len(files)} JSONL files, every final residual "
               f"finite (largest {worst:.3e}), {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 3: least squares at scale, XLA against the one-pass kernel
# --------------------------------------------------------------------------

# Kernel alone vs ls_value_grad_xla(precision="highest"): both accumulate
# in f32 in different orders; measured relative errors ~2e-7, so 1e-5.
KERNEL_TOL = 1e-5
# Full solves: 200 adaptive iterations amplify last-bit differences of the
# two oracles through the stepsize rule. Perturbing b by 1e-6 relative moves
# x by ~2e-5 and the final residual (a difference of successive iterates)
# by ~5e-4 after 200 iterations (CPU, 2048^2): 1e-3 on x, 1e-2 on norm_res.
SOLVE_TOL = 1e-3
RES_TOL = 1e-2


def _lasso_data(n, m=None, seed=0):
    import jax
    import jax.numpy as jnp

    m = m or n
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    a = jax.random.normal(k1, (m, n), jnp.float32) * float(1.0 / np.sqrt(n))
    b = jax.random.normal(k2, (m,), jnp.float32)
    return a, b


def _adapgm(fused, iters, interpret=False):
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares

    def step(a, b):
        f = LeastSquares(a=a, b=b, fused=fused, interpret=interpret)
        g = ap.L1Norm(lam=jnp.float32(0.01))
        res = ap.adaptive_proxgrad(
            jnp.zeros(a.shape[1], jnp.float32), f=f, g=g,
            rule=ap.AdaPGMRule(gamma=jnp.float32(1e-3)),
            tol=0.0, maxit=iters)
        obj = LeastSquares(a=a, b=b).value(res.x) + g(res.x)
        return res.x, res.numit, res.norm_res, obj

    return step


def _best_time(exe, args, reps=3):
    import jax

    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase3_least_squares(n=16384, iters=200, small=(4000, 1000),
                         wide=(1024, 65600), interpret=False):
    import jax
    import jax.numpy as jnp

    from adaprox_tpu.ops import kernels

    a, b = _lasso_data(n)
    x = jax.random.normal(jax.random.PRNGKey(7), (n,), jnp.float32)
    for label, a_s in (("f32", a), ("bf16 storage", a.astype(jnp.bfloat16))):
        f0, g0 = jax.jit(kernels.ls_value_grad_xla)(a_s, b, x)
        f1, g1 = kernels.fused_ls_value_grad(a_s, b, x, interpret=interpret)
        check(3, f"kernel {n}x{n} {label}: |f-f_xla|/|f_xla|",
              abs(float(f1) - float(f0)) / abs(float(f0)), KERNEL_TOL)
        check(3, f"kernel {n}x{n} {label}: ||g-g_xla||/||g_xla||",
              rel(g1, g0), KERNEL_TOL)
    # unaligned rows of one tile, and rows wider than a tile (the chunked
    # path that streams each panel twice through L2)
    for (ms, ns), label in ((small, "unaligned"), (wide, "wide rows, chunked")):
        a2, b2 = _lasso_data(ns, ms, seed=1)
        x2 = jax.random.normal(jax.random.PRNGKey(8), (ns,), jnp.float32)
        f0, g0 = kernels.ls_value_grad_xla(a2, b2, x2)
        f1, g1 = kernels.fused_ls_value_grad(a2, b2, x2, interpret=interpret)
        check(3, f"kernel {ms}x{ns} ({label}): |f-f_xla|/|f_xla|",
              abs(float(f1) - float(f0)) / abs(float(f0)), KERNEL_TOL)
        check(3, f"kernel {ms}x{ns} ({label}): ||g-g_xla||/||g_xla||",
              rel(g1, g0), KERNEL_TOL)

    rates = {}
    for label, a_s in (("f32", a), ("bf16", a.astype(jnp.bfloat16))):
        out = {}
        for path, fused in (("xla", False), ("kernel", True)):
            exe = compiled(3, f"AdaPGM {n}x{n} {label} {path}",
                           _adapgm(fused, iters, interpret), a_s, b)
            out[path] = jax.block_until_ready(exe(a_s, b))
            rates[(label, path)] = iters / _best_time(exe, (a_s, b))
        xx, nx, rx, _ = out["xla"]
        xk, nk, rk, _ = out["kernel"]
        if int(nx) != iters or int(nk) != iters:
            raise AssertionError(f"phase 3: numit {int(nx)}, {int(nk)} != {iters}")
        say(3, f"PASS {label} numit xla={int(nx)} kernel={int(nk)}")
        check(3, f"AdaPGM {label} ||x_kernel-x_xla||/||x_xla||", rel(xk, xx),
              SOLVE_TOL)
        check(3, f"AdaPGM {label} |res_kernel-res_xla|/res_xla",
              abs(float(rk) - float(rx)) / float(rx), RES_TOL)
    for label in ("f32", "bf16"):
        say(3, f"AdaPGM {n}x{n} {label} storage: XLA two-pass "
               f"{rates[(label, 'xla')]:.1f} it/s, one-pass kernel "
               f"{rates[(label, 'kernel')]:.1f} it/s "
               f"({rates[(label, 'kernel')] / rates[(label, 'xla')]:.3f}x)")
    return rates


# --------------------------------------------------------------------------
# phase 4: primal-dual at scale, f32 against f64
# --------------------------------------------------------------------------

# 200 adaptive primal-dual iterations in f32 against the same iterations in
# f64: the f32 rounding of both products and the prox enters every step;
# 1e-3 relative on x and on the final residual.
PD_TOL = 1e-3


def _pd_step(iters, dtype):
    import jax.numpy as jnp

    import adaprox_tpu as ap

    def step(a, yv, na):
        a = a.astype(dtype)
        yv = yv.astype(dtype)
        h = ap.Translate(inner=ap.L2Norm(lam=jnp.asarray(1.0, dtype)), b=-yv)
        res = ap.adaptive_primal_dual(
            jnp.zeros(a.shape[1], dtype), jnp.zeros(a.shape[0], dtype),
            f=ap.ZeroSmooth(), g=ap.L1Norm(lam=jnp.asarray(0.01, dtype)), h=h,
            A=ap.DenseOperator(a=a),
            rule=ap.AdaPGMRule.make(t=1.0, norm_a=na.astype(dtype)),
            tol=0.0, maxit=iters)
        return res.x, res.numit, res.norm_res

    return step


def phase4_primal_dual(n=16384, iters=200):
    import jax
    import jax.numpy as jnp

    a, yv = _lasso_data(n, seed=2)
    na = jnp.sqrt(jnp.sum(a * a))
    exe32 = compiled(4, f"AdaPDM {n}x{n} f32", _pd_step(iters, jnp.float32),
                     a, yv, na)
    x32, n32, r32 = jax.block_until_ready(exe32(a, yv, na))
    with x64():
        a64 = a.astype(jnp.float64)
        exe64 = compiled(4, f"AdaPDM {n}x{n} f64", _pd_step(iters, jnp.float64),
                         a64, yv.astype(jnp.float64), na.astype(jnp.float64))
        x64_, n64, r64 = jax.block_until_ready(
            exe64(a64, yv.astype(jnp.float64), na.astype(jnp.float64)))
        x64_, r64 = np.asarray(x64_), float(r64)
        del a64
    say(4, f"numit f32={int(n32)} f64={int(n64)}, norm_res f32={float(r32):.6e} "
           f"f64={r64:.6e}")
    check(4, "AdaPDM ||x_f32-x_f64||/||x_f64||", rel(x32, x64_), PD_TOL)
    check(4, "AdaPDM |res_f32-res_f64|/res_f64",
          abs(float(r32) - r64) / r64, PD_TOL)


# --------------------------------------------------------------------------
# phase 5: L1-logistic regression at the LIBSVM epsilon shape
# --------------------------------------------------------------------------

# f32 against f64 on the card after the same number of iterations: the
# objective is a mean over 400k rows, accumulated in f32; 1e-4 relative.
LOGREG_TOL = 1e-4


def _logreg_step(iters, dtype):
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LogisticLoss

    def step(xm, y, gamma):
        f = LogisticLoss(x=xm.astype(dtype), y=y.astype(dtype))
        g = ap.L1Norm(lam=jnp.asarray(1e-4, dtype))
        res = ap.adaptive_proxgrad(
            jnp.zeros(xm.shape[1] + 1, dtype), f=f, g=g,
            rule=ap.AdaPGMRule(gamma=gamma.astype(dtype)), tol=0.0,
            maxit=iters, history=True)
        return res.x, res.records.norm_res, f.value(res.x) + g(res.x)

    return step


def phase5_logistic(m=400_000, n=2_000, iters=100):
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    xm = jax.random.normal(k1, (m, n), jnp.float32)
    w = jax.random.normal(k2, (n,), jnp.float32) / np.sqrt(n)
    z = jnp.matmul(xm, w, precision="highest")
    y = ((z + 0.5 * jax.random.normal(k3, (m,))) > 0).astype(jnp.float32)
    # the reference's Lf seed: ||X1'X1||_F / 4m bounds the gradient's
    # Lipschitz constant; ||X1||_F^2 / 4m is a cheaper, looser bound
    gamma = jnp.float32(4 * m / float(jnp.sum(xm * xm) + m))
    exe = compiled(5, f"AdaPGM logistic {m}x{n} f32", _logreg_step(iters, jnp.float32),
                   xm, y, gamma)
    _, hist, obj32 = jax.block_until_ready(exe(xm, y, gamma))
    hist = np.asarray(hist)
    if not np.all(np.isfinite(hist)):
        raise AssertionError("phase 5: non-finite residual")
    check(5, "logistic residual last/first (decreasing)", hist[-1] / hist[0], 0.5)
    with x64():
        x64m = xm.astype(jnp.float64)
        exe64 = compiled(5, f"AdaPGM logistic {m}x{n} f64",
                         _logreg_step(iters, jnp.float64), x64m,
                         y.astype(jnp.float64), gamma.astype(jnp.float64))
        _, _, obj64 = jax.block_until_ready(
            exe64(x64m, y.astype(jnp.float64), gamma.astype(jnp.float64)))
        obj64 = float(obj64)
        del x64m
    say(5, f"objective f32={float(obj32):.8f} f64={obj64:.8f}, residual "
           f"{hist[0]:.3e} -> {hist[-1]:.3e} in {iters} iterations")
    check(5, "logistic |F_f32-F_f64|/|F_f64|", abs(float(obj32) - obj64) / abs(obj64),
          LOGREG_TOL)


# --------------------------------------------------------------------------
# phase 6: the batched regularization path
# --------------------------------------------------------------------------

# The vmapped path runs batched products where the loop runs single
# matvecs, so sums differ in order. In f32 the stopping iteration of the
# slow instances wandered by ~200 of ~3200 at tol 1e-4 (H100 run), so the
# path is checked in native f64 at the reference's tol 1e-7: numit within
# the repo's batch-test margin max(20, 5%). Instances that stop some
# iterations apart, or are cut at maxit mid-convergence, differ in x by up
# to 1.1e-4 relative (H100, f64) along directions where the objective is
# flat, and in the objective by up to 1.8e-8 relative (CPU f64, 2000x500):
# objectives must agree to 1e-6 relative, x to 1e-3.
PATH_TOL = 1e-3
PATH_OBJ_TOL = 1e-6


def _regpath(gamma, tol, maxit):
    import jax

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.solvers.batch import regularization_path

    def objective(a, b, x, lam):
        return LeastSquares(a=a, b=b).value(x) + ap.L1Norm(lam=lam)(x)

    def batched(a, b, x0, lams):
        res = regularization_path(x0, f=LeastSquares(a=a, b=b), lams=lams,
                                  gamma=gamma, tol=tol, maxit=maxit)
        obj = jax.vmap(objective, in_axes=(None, None, 0, 0))(a, b, res.x, lams)
        return res.x, res.numit, obj

    def single(a, b, x0, lam):
        res = ap.adaptive_proxgrad(
            x0, f=LeastSquares(a=a, b=b), g=ap.L1Norm(lam=lam),
            rule=ap.AdaPGMRule(gamma=gamma), tol=tol, maxit=maxit)
        return res.x, res.numit, objective(a, b, res.x, lam)

    return batched, single


def _path_problem(m, n, k):
    """random_lasso data, x0, 1/Lf and k lambdas, in float64."""
    import jax.numpy as jnp

    from adaprox_tpu.models.synthetic import random_lasso

    prob = random_lasso(m=m, n=n, pfactor=10, seed=0)
    gamma = jnp.float64(1.0 / float(np.linalg.norm(prob.a, 2) ** 2))
    return (jnp.asarray(prob.a, jnp.float64), jnp.asarray(prob.b, jnp.float64),
            jnp.zeros(n, jnp.float64), gamma,
            jnp.asarray(np.geomspace(0.05, 5.0, k), jnp.float64))


def phase6_regpath(m=4000, n=1000, k=16, tol=1e-7, maxit=5000):
    with x64():
        _phase6(m, n, k, tol, maxit)


def _phase6(m, n, k, tol, maxit):
    import jax

    a, b, x0, gamma, lams = _path_problem(m, n, k)
    batched, single = _regpath(gamma, tol, maxit)
    exe = compiled(6, f"regularization_path {k}x{m}x{n} f64", batched, a, b, x0, lams)
    xb, nb, ob = jax.block_until_ready(exe(a, b, x0, lams))
    one = jax.jit(single)
    worst = worst_obj = 0.0
    loop_numit = []
    for i in range(k):
        xs, ns, os_ = one(a, b, x0, lams[i])
        loop_numit.append(int(ns))
        margin = max(20, int(ns) // 20)
        if abs(int(nb[i]) - int(ns)) > margin:
            raise AssertionError(f"phase 6: lam[{i}] numit {int(nb[i])} vs {int(ns)}")
        worst = max(worst, rel(xb[i], xs))
        worst_obj = max(worst_obj, abs(float(ob[i]) - float(os_)) / abs(float(os_)))
    say(6, f"per-instance numit (batched): {[int(v) for v in nb]}")
    say(6, f"per-instance numit (loop):    {loop_numit}")
    check(6, f"max_i |F_batched-F_loop|/|F_loop| over {k} lambdas",
          worst_obj, PATH_OBJ_TOL)
    check(6, f"max_i ||x_batched-x_loop||/||x_loop|| over {k} lambdas",
          worst, PATH_TOL)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

# psum over 4 shards reorders the f32 sums of both products. The tall
# 65536x16384 problem is well conditioned, so 100 iterations reach the f32
# floor of the residual, where a relative comparison of norm_res means
# nothing: compare x (1e-3) and the objective (1e-5) instead.
SHARD_TOL = 1e-3
SHARD_OBJ_TOL = 1e-5


def _check_spread(phase, arr, n_dev):
    devs = {s.device for s in arr.addressable_shards}
    say(phase, f"array {arr.shape} on {len(devs)} devices: "
               f"{sorted(str(d) for d in devs)}")
    if len(devs) != n_dev:
        raise AssertionError(f"array landed on {len(devs)} devices, not {n_dev}")


def four_sharded_lasso(m=65536, n=16384, iters=100):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adaprox_tpu.parallel.mesh import ROWS, make_mesh

    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 devices, JAX found {len(jax.devices())}")
    a, b = _lasso_data(n, m, seed=4)
    a = jax.device_put(a, devs[0])
    b = jax.device_put(b, devs[0])
    step = _adapgm(False, iters)
    exe1 = compiled("four", f"AdaPGM {m}x{n} one card", step, a, b)
    x1, n1, r1, o1 = jax.block_until_ready(exe1(a, b))
    x1, r1, o1 = np.asarray(x1), float(r1), float(o1)
    mesh = make_mesh((4, 1), devices=devs)
    a_sh = jax.device_put(a, NamedSharding(mesh, P(ROWS, None)))
    b_sh = jax.device_put(b, NamedSharding(mesh, P(ROWS)))
    del a, b
    _check_spread("four", a_sh, 4)
    exe4 = compiled("four", f"AdaPGM {m}x{n} rows over 4 cards", step, a_sh, b_sh)
    x4, n4, r4, o4 = jax.block_until_ready(exe4(a_sh, b_sh))
    say("four", f"numit one={int(n1)} four={int(n4)}; norm_res one={r1:.6e} "
                f"four={float(r4):.6e}; objective one={o1:.8f} four={float(o4):.8f}")
    check("four", "row-sharded ||x_4-x_1||/||x_1||", rel(x4, x1), SHARD_TOL)
    check("four", "row-sharded |F_4-F_1|/|F_1|", abs(float(o4) - o1) / abs(o1),
          SHARD_OBJ_TOL)
    del a_sh, b_sh


def four_sweep_regpath(m=4000, n=1000, k=16, tol=1e-7, maxit=5000):
    with x64():  # f64 for the reason given at PATH_TOL
        _four_sweep(m, n, k, tol, maxit)


def _four_sweep(m, n, k, tol, maxit):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adaprox_tpu.parallel.mesh import ROWS
    from adaprox_tpu.parallel.sweep import SWEEP, composed_mesh

    a, b, x0, gamma, lams = _path_problem(m, n, k)
    batched, _ = _regpath(gamma, tol, maxit)
    x1, n1, o1 = jax.block_until_ready(jax.jit(batched)(a, b, x0, lams))

    mesh = composed_mesh(2, 2, devices=jax.devices()[:4])
    put = lambda v, spec: jax.device_put(v, NamedSharding(mesh, spec))
    lams_sh = put(lams, P(SWEEP))
    a_sh, b_sh, x0_sh = put(a, P(ROWS, None)), put(b, P(ROWS)), put(x0, P())
    _check_spread("four", a_sh, 4)
    exe = compiled("four", f"regularization_path {k} lambdas on (sweep=2, rows=2)",
                   batched, a_sh, b_sh, x0_sh, lams_sh)
    x4, n4, o4 = jax.block_until_ready(exe(a_sh, b_sh, x0_sh, lams_sh))
    _check_spread("four", x4, 4)
    say("four", f"numit unsharded={[int(v) for v in n1]}")
    say("four", f"numit sharded  ={[int(v) for v in n4]}")
    excess = max(abs(int(p) - int(q)) - max(20, int(q) // 20)
                 for p, q in zip(n4, n1))
    check("four", "sweep-sharded max(|numit_4 - numit_1| - max(20, 5%))",
          excess, 0)
    check("four", "sweep-sharded max_i |F_4-F_1|/|F_1|",
          float(np.max(np.abs(np.asarray(o4) - np.asarray(o1)) / np.abs(np.asarray(o1)))),
          PATH_OBJ_TOL)
    check("four", "sweep-sharded ||x_4-x_1||/||x_1||", rel(x4, x1), PATH_TOL)


# --------------------------------------------------------------------------


def main(argv=None):
    global CARD
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the two four-card sharded checks")
    args = p.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    from adaprox_tpu.platform import enable_compile_cache, gpu_name_and_power_limit

    enable_compile_cache()
    CARD = gpu_name_and_power_limit().replace("\n", " / ")
    print(CARD, flush=True)
    t0 = time.perf_counter()
    phase1_device()
    if args.four:
        four_sharded_lasso()
        four_sweep_regpath()
    else:
        with tempfile.TemporaryDirectory() as outdir:
            phase2_drivers(outdir)
        phase3_least_squares()
        phase4_primal_dual()
        phase5_logistic()
        phase6_regpath()
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
