"""Nesterov worst-case quadratic experiment
(experiments/nesterov_worst_case/runme.jl).

WorstQuadratic(k, L) with known optimum (L/8)(1/(k+1) - 1) (runme.jl:53);
k = n = 100, L = 100, tol 1e-6, maxit 10_000. Sanity check that adaptive
methods degrade gracefully against accelerated ones. Plot: F - F* vs
grad_f_evals.
"""

from __future__ import annotations

import argparse
import os

from .common import Sink, group_rows, pick_platform, plot_lines, run_menu, run_timed


def run_nesterov_worst_case(sink, k=100, n=100, lip=100.0, tol=1e-6, live=False,
                            maxit=10_000):
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import WorstQuadratic

    assert n >= k
    f = WorstQuadratic(k=k, lip=jnp.asarray(lip))
    g = ap.Zero()
    optimum = (lip / 8) * (1 / (k + 1) - 1)
    sink.emit_pseudo({"method": None, "it": 1, "objective": optimum})

    x0 = jnp.zeros(n)
    times = {}

    def add(name, fn):
        sink.add(run_timed(times, name, fn))

    base = dict(f=f, g=g, tol=tol)
    menu = [
        ("Fixed stepsize PGM", maxit, lambda **o: ap.fixed_proxgrad(
            x0, gamma=1 / lip, name="Fixed stepsize PGM", **base, **o)),
        ("Backtracking PG", maxit, lambda **o: ap.backtracking_proxgrad(
            x0, gamma0=1.0, name="Backtracking PG", **base, **o)),
        ("Fixed Nesterov", maxit, lambda **o: ap.fixed_nesterov(
            x0, gamma=1 / lip, name="Fixed Nesterov", **base, **o)),
        ("Backtracking Nesterov", maxit,
         lambda **o: ap.backtracking_nesterov(
             x0, gamma0=1.0, name="Backtracking Nesterov", **base, **o)),
        ("AdaPGM (MM)", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.MalitskyMishchenkoRule(gamma=1 / lip),
            name="AdaPGM (MM)", **base, **o)),
        ("AdaPGM", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.AdaPGMRule(gamma=1 / lip), name="AdaPGM",
            **base, **o)),
    ]
    menu_path = run_menu(sink, times, menu, live=live,
                         objective=lambda x: f.value(x) + g(x))
    sink.emit_meta(wall_s=times, fast_path=menu_path, fast_methods=[])
    return optimum


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    groups = group_rows(rows)
    series = [
        (name, [r["grad_f_evals"] for r in rs], [r["objective"] - optimum for r in rs])
        for name, rs in groups.items()
    ]
    return plot_lines(path, series, "Nesterov's worst case",
                      "grad f evaluations", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/nesterov_worst_case")
    p.add_argument("--maxit", type=int, default=10_000)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--L", type=float, default=100.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)

    path = os.path.join(args.outdir, "nesterov_worst_case.jsonl")
    sink = Sink(path)
    opt = run_nesterov_worst_case(sink, k=args.k, n=args.n, lip=args.L,
                                  tol=args.tol, maxit=args.maxit,
                                  live=args.live)
    print(f"{path}: optimum={opt:.8f}")
    if not args.no_plot:
        plot_convergence(path)


if __name__ == "__main__":
    main()
