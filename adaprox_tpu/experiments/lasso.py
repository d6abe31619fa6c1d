"""Lasso experiment (reference experiments/lasso/runme.jl).

Synthetic problem with a known optimum by construction (runme.jl:45-77);
runs fixed PG, backtracking PG (xi in {1, 1.5, 2}), fixed + backtracking
Nesterov, AdaPGM-MM, AdaPGM-Ours, and aGRAAL; sizes (m, n, pfactor) in
{(100,300,10), (500,1000,10), (4000,1000,10)}, maxit 2000, tol 1e-7
(runme.jl:191-211). Plot: F(x_k) - F* vs (grad_f_evals + f_evals).

``--fused`` makes every solver's LS oracle the one-pass GPU kernel
(ops.kernels.fused_ls_value_grad): one read of A per oracle call instead
of two. Per-method wall-clock is emitted as a ``wall_s`` meta row.
"""

from __future__ import annotations

import argparse
import os
import numpy as np

from .common import Sink, group_rows, pick_platform, plot_lines, run_menu


def run_random_lasso(m, n, pfactor, sink, tol=1e-7, maxit=2000, seed=0, dtype=None,
                     fused=False, live=False):
    import jax
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.models.synthetic import random_lasso

    prob = random_lasso(m=m, n=n, pfactor=pfactor, seed=seed, lam=1.0)
    dtype = dtype or jnp.asarray(prob.a).dtype
    a = jnp.asarray(prob.a, dtype)
    b = jnp.asarray(prob.b, dtype)
    f = LeastSquares(a=a, b=b, fused=fused)
    lam = jnp.asarray(prob.lam, dtype)
    g = ap.L1Norm(lam=lam)

    # pseudo-record with the analytic optimum (runme.jl:79)
    sink.emit_pseudo({"method": None, "it": 1, "objective": prob.optimum})

    lf = float(np.linalg.norm(prob.a, 2) ** 2)
    gam = 1.0 / lf
    x0 = jnp.zeros(n, dtype)
    times = {}

    # aGRAAL's companion point: the same draw as its default
    x0_ag = x0 + jax.random.normal(jax.random.PRNGKey(0), (n,), x0.dtype)
    base = dict(f=f, g=g, tol=tol)
    menu = [
        ("PGM (fixed)", maxit, lambda **o: ap.fixed_proxgrad(
            x0, gamma=gam, name="PGM (fixed)", **base, **o)),
    ] + [
        (f"PGM (backtracking)-(xi={xi})", maxit,
         lambda xi=xi, **o: ap.backtracking_proxgrad(
             x0, gamma0=gam, xi=xi,
             name=f"PGM (backtracking)-(xi={xi})", **base, **o))
        for xi in (1.0, 1.5, 2.0)
    ] + [
        ("Nesterov (backtracking)", maxit,
         lambda **o: ap.backtracking_nesterov(
            x0, gamma0=gam, name="Nesterov (backtracking)", **base, **o)),
        ("Nesterov (fixed)", maxit, lambda **o: ap.fixed_nesterov(
            x0, gamma=gam, name="Nesterov (fixed)", **base, **o)),
        ("AdaPGM (MM)", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.MalitskyMishchenkoRule(gamma=gam),
            name="AdaPGM (MM)", **base, **o)),
        ("AdaPGM (Ours)", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.AdaPGMRule(gamma=gam), name="AdaPGM (Ours)",
            **base, **o)),
        ("aGRAAL", maxit, lambda **o: ap.agraal(
            x0, x0=x0_ag, gamma0=gam, name="aGRAAL", **base, **o)),
    ]
    # the reference's in-flight console echo (emission inside the
    # loop at src/AdaProx.jl:351, log-decimated at
    # experiments/logging.jl:13-17) when --live; record solves
    # otherwise (common.run_menu — shared wiring + fast_path label)
    menu_path = run_menu(sink, times, menu, live=live,
                         objective=lambda x: f.value(x) + g(x))
    # which timed methods took a fast path (the summarizer pairs only
    # these); the fused oracle feeds every method
    sink.emit_meta(wall_s=times, fast_path="fused" if fused else menu_path,
                   fast_methods=sorted(times) if fused else [])
    return prob.optimum


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    groups = group_rows(rows)
    series = [
        (name, [r["grad_f_evals"] + r["f_evals"] for r in rs],
         [r["objective"] - optimum for r in rs])
        for name, rs in groups.items()
    ]
    return plot_lines(path, series, f"Lasso ({os.path.basename(path)})",
                      "calls to A, A'", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/lasso")
    p.add_argument("--maxit", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--sizes", default="100x300x10,500x1000x10,4000x1000x10")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--fused", action="store_true",
                   help="one-pass GPU least-squares oracle for every solver")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo "
                        "(reference-style live telemetry; JSONL gets the "
                        "log-spaced rows)")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)

    for spec in args.sizes.split(","):
        m, n, pf = (int(v) for v in spec.split("x"))
        path = os.path.join(args.outdir, f"lasso_{m}_{n}_{pf}.jsonl")
        sink = Sink(path)
        opt = run_random_lasso(m, n, pf, sink, tol=args.tol, maxit=args.maxit,
                               fused=args.fused, live=args.live)
        print(f"{path}: optimum={opt:.8f}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
