"""Square-root lasso experiment (experiments/square_root_lasso/runme.jl).

Fully nonsmooth composite: f = 0, g = lambda*||.||_1,
h = Translate(NormL2, -y) i.e. ||A x - y||_2, A = [X 1] dense
(runme.jl:37-42). Condat-Vu + Malitsky-Pock(t) + AdaPDM+(t, eta=||A||) over
15 t-values (runme.jl:48); datasets cpusmall_scale / abalone /
housing_scale, lambda = 10, maxit 5000, tol 1e-5; cost metric =
A_evals + At_evals; logs [method, norm_res, A_evals, At_evals].
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import (Sink, group_rows, live_menu, pick_platform, plot_lines,
                     run_timed)

T_VALUES = [0.01, 0.15, 0.02, 0.025, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 50, 100]
KEYS = ["method", "norm_res", "A_evals", "At_evals"]


def _load(name_or_path):
    from adaprox_tpu.utils.datasets import load_or_synthesize
    from adaprox_tpu.utils.libsvm import load_libsvm_dataset

    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path)
        return x_np, y_np, "libsvm"
    return load_or_synthesize(str(name_or_path))


def make_h(inner_cls, y):
    """h = Translate(inner, -y): ||Ax - y|| in the chosen norm."""
    import jax.numpy as jnp

    import adaprox_tpu as ap

    inner = inner_cls(lam=1.0)
    return ap.Translate(inner=inner, b=-jnp.asarray(y))


def run_composite(name_or_path, sink, inner_cls, lam=10.0, tol=1e-5, maxit=5000,
                  vmap_sweep=False, live=False):
    import jax
    import jax.numpy as jnp

    import adaprox_tpu as ap

    x_np, y_np, source = _load(name_or_path)
    m, n = x_np.shape

    f = ap.ZeroSmooth()
    g = ap.L1Norm(lam=float(lam))
    h = make_h(inner_cls, y_np)
    a_mat = jnp.asarray(np.hstack([x_np, np.ones((m, 1))]))
    a_op = ap.DenseOperator(a=a_mat)
    norm_a = float(np.linalg.norm(np.asarray(a_mat)))

    x0 = jnp.zeros(n + 1)
    y0 = jnp.zeros(m)
    times = {}

    if live and vmap_sweep:
        # precedence: the batched path wins (consistent across drivers) —
        # live chunking is a per-solve mode
        print("  [live] --live applies to the sequential engine path; "
              "running the requested fast path without in-flight echo")
    if live and not vmap_sweep:
        # reference-style in-flight echo (PD schema): CV + both t-sweeps as
        # early-exit solves; gamma/sigma coupled via t where the carry
        # lacks one (MP carries sigma, AdaPDM+ carries gamma)
        def obj(x):
            return g(x) + h(a_op.matvec(x))

        live_menu(sink, times, [
            ("Condat-Vu", maxit, lambda **o: ap.condat_vu(
                x0, y0, f=f, g=g, h=h, A=a_op, Lf=0.0, norm_A=norm_a,
                tol=tol, name="Condat-Vu", **o)),
        ] + [
            (f"Malitsky-Pock (t={t})", maxit,
             lambda t=t, **o: ap.malitsky_pock(
                 x0, y0, f=f, g=g, h=h, A=a_op, sigma=1.0, t=t, tol=tol,
                 name=f"Malitsky-Pock (t={t})", **o),
             lambda row, res, t=t: {**row, "gamma": t * t * row["sigma"]})
            for t in T_VALUES
        ] + [
            (f"AdaPDM+ (t={t})", maxit,
             lambda t=t, **o: ap.adaptive_linesearch_primal_dual(
                 x0, y0, f=f, g=g, h=h, A=a_op, eta=norm_a, t=t, tol=tol,
                 name=f"AdaPDM+ (t={t})", **o),
             lambda row, res, t=t: {**row, "sigma": t * t * row["gamma"]})
            for t in T_VALUES
        ], objective=obj, primal_dual=True)
        sink.emit_meta(wall_s=times, fast_path="live", fast_methods=[])
        return source

    sink.add(run_timed(times, "Condat-Vu", lambda: ap.condat_vu(
        x0, y0, f=f, g=g, h=h, A=a_op, Lf=0.0, norm_A=norm_a,
        tol=tol, maxit=maxit, history=True, name="Condat-Vu",
    )), primal_dual=True)

    import time as _time

    def add_sweep(fam, solve_t):
        """Run the t grid either sequentially (reference structure,
        square_root_lasso/runme.jl:48,80-95) or as ONE vmapped program over
        the coupling t — nested linesearch while_loop and all."""
        t0 = _time.perf_counter()
        if vmap_sweep:
            batched = jax.vmap(solve_t)(jnp.asarray(T_VALUES))
            for i, t in enumerate(T_VALUES):
                one = jax.tree_util.tree_map(lambda arr: arr[i], batched)
                sink.add(one.with_name(f"{fam} (t={t})"), primal_dual=True)
        else:
            for t in T_VALUES:
                res = solve_t(float(t))
                sink.add(res.with_name(f"{fam} (t={t})"), primal_dual=True)
        times[f"{fam} t-sweep"] = round(_time.perf_counter() - t0, 4)

    def solve_mp(t):
        res = ap.malitsky_pock(
            x0, y0, f=f, g=g, h=h, A=a_op, sigma=1.0, t=t,
            tol=tol, maxit=maxit, history=True,
        )
        return res._replace(name=None, extra=None, diag=None)

    def solve_pdmp(t):
        res = ap.adaptive_linesearch_primal_dual(
            x0, y0, f=f, g=g, h=h, A=a_op, eta=norm_a, t=t,
            tol=tol, maxit=maxit, history=True,
        )
        return res._replace(name=None, extra=None, diag=None)

    add_sweep("Malitsky-Pock", solve_mp)
    add_sweep("AdaPDM+", solve_pdmp)
    sink.emit_meta(
        wall_s=times, fast_path="vmap" if vmap_sweep else "default",
        fast_methods=(["Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
                      if vmap_sweep else []))
    return source


def plot_residual(path, title_prefix="Square root lasso"):
    from ..utils.logging import find_best, read_jsonl

    rows = read_jsonl(path)
    groups = group_rows(rows)
    names_to_plot = []
    for fam in ["Condat-Vu", "Malitsky-Pock", "AdaPDM+"]:
        matching = [k for k in groups if k.startswith(fam)]
        if matching:
            names_to_plot.append(find_best(
                groups, matching, "norm_res", 1e-5,
                lambda row: row["A_evals"] + row["At_evals"],
            ))
    series = [
        (name, [r["A_evals"] + r["At_evals"] for r in groups[name]],
         [r["norm_res"] for r in groups[name]])
        for name in names_to_plot
    ]
    return plot_lines(path, series, f"{title_prefix} ({os.path.basename(path)})",
                      "#calls to A, A'", "||v||")


def main(argv=None, inner="l2", default_outdir="results/square_root_lasso"):
    import adaprox_tpu as ap

    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default=default_outdir)
    p.add_argument("--maxit", type=int, default=5000)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--lam", type=float, default=10.0)
    p.add_argument("--datasets", default="cpusmall_scale,abalone,housing_scale")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--vmap-sweep", action="store_true")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)

    inner_cls = ap.L2Norm if inner == "l2" else ap.L1Norm
    title = "Square root lasso" if inner == "l2" else "Least absolute deviation"
    for ds in args.datasets.split(","):
        path = os.path.join(args.outdir, f"{os.path.basename(ds)}.jsonl")
        sink = Sink(path, keys=KEYS)
        src = run_composite(ds, sink, inner_cls, lam=args.lam, tol=args.tol,
                            maxit=args.maxit, vmap_sweep=args.vmap_sweep,
                            live=args.live)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_residual(path, title)


if __name__ == "__main__":
    main()
