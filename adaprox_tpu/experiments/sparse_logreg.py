"""Sparse logistic regression experiment (experiments/sparse_logreg/runme.jl).

f = mean logistic loss with bias folded in, g = 0.01 * ||.||_1;
Lf = ||X1 X1'|| / (4 m) with X1 = [X 1] (runme.jl:58-59); ground truth via a
high-accuracy AdaPGM pre-run at tol/10, maxit*10 (runme.jl:64-73); datasets
mushrooms / a5a / phishing, maxit 2000, tol 1e-7 (backtracking/Nesterov get
maxit/2, runme.jl:94,105). Plot: F - F* vs (grad_f_evals + f_evals).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import Sink, group_rows, pick_platform, plot_lines, run_menu, run_timed


def run_logreg_l1_data(name_or_path, sink, lam=0.01, tol=1e-7, maxit=2000, dtype=None, live=False,
                       spectral_lf=False):
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import LogisticLoss
    from adaprox_tpu.utils.datasets import load_or_synthesize
    from adaprox_tpu.utils.libsvm import load_libsvm_dataset

    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path, labels=(0.0, 1.0))
        source = "libsvm"
    else:
        x_np, y_np, source = load_or_synthesize(str(name_or_path), labels=(0.0, 1.0))
    m, n_feat = x_np.shape
    n = n_feat + 1

    x_mat = jnp.asarray(x_np, dtype) if dtype else jnp.asarray(x_np)
    y = jnp.asarray(y_np, x_mat.dtype)
    f = LogisticLoss(x=x_mat, y=y)
    g = ap.L1Norm(lam=jnp.asarray(lam, x_mat.dtype))

    # Lf = norm(X1*X1') / 4m (runme.jl:58-59) where Julia's matrix `norm` is
    # the FROBENIUS norm of the Gram — computed gram-free via the n x n
    # Gram: ||X1 X1'||_F = ||X1' X1||_F (both are sqrt(sum sigma_i^4)), so
    # one (n, m) @ (m, n) product instead of the m x m Gram. This is a loose
    # upper bound on the spectral Lipschitz constant, but it is what the
    # reference seeds every solver with — gamma_init parity requires it.
    # ``spectral_lf=True`` keeps the tighter ||X1||_2^2 / 4m variant.
    x1 = np.hstack([x_np, np.ones((m, 1))])
    if spectral_lf:
        lf = float(np.linalg.norm(x1, 2) ** 2 / (4 * m))
    else:
        lf = float(np.linalg.norm(x1.T @ x1) / (4 * m))
    gam = 1.0 / lf
    x0 = jnp.zeros(n, x_mat.dtype)
    times = {}

    def add(name, fn):
        sink.add(run_timed(times, name or "(ground truth)", fn))

    # high-accuracy ground-truth run (tol/10, history mode), logged with
    # method=None so plotting uses it only through the min-objective
    # (runme.jl:64-73)
    add(None, lambda: ap.adaptive_proxgrad(
        x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=gam), tol=tol / 10,
        maxit=maxit * 10, history=True, name=None))
    base = dict(f=f, g=g, tol=tol)
    menu = [
        ("PGM (1/Lf)", maxit, lambda **o: ap.fixed_proxgrad(
            x0, gamma=gam, name="PGM (1/Lf)", **base, **o)),
    ] + [
        (f"PGM (backtracking)-(xi={xi})", maxit // 2,
         lambda xi=xi, **o: ap.backtracking_proxgrad(
             x0, gamma0=gam, xi=xi,
             name=f"PGM (backtracking)-(xi={xi})", **base, **o))
        for xi in (1.0, 1.5, 2.0)
    ] + [
        ("Nesterov (backtracking)", maxit // 2,
         lambda **o: ap.backtracking_nesterov(
             x0, gamma0=gam, name="Nesterov (backtracking)", **base,
             **o)),
        ("Nesterov (fixed)", maxit // 2, lambda **o: ap.fixed_nesterov(
            x0, gamma=gam, name="Nesterov (fixed)", **base, **o)),
        ("AdaPGM (MM)", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.MalitskyMishchenkoRule(gamma=gam),
            name="AdaPGM (MM)", **base, **o)),
        ("AdaPGM (Ours)", maxit, lambda **o: ap.adaptive_proxgrad(
            x0, rule=ap.AdaPGMRule(gamma=gam), name="AdaPGM (Ours)",
            **base, **o)),
        ("aGRAAL", maxit, lambda **o: ap.agraal(
            x0, gamma0=gam, name="aGRAAL", **base, **o)),
    ]
    menu_path = run_menu(sink, times, menu, live=live,
                         objective=lambda x: f.value(x) + g(x))
    sink.emit_meta(wall_s=times, fast_path=menu_path, fast_methods=[])
    return source


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
    return plot_lines(path, series, f"Logistic regression ({os.path.basename(path)})",
                      "calls to A, A'", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/sparse_logreg")
    p.add_argument("--maxit", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--lam", type=float, default=0.01)
    p.add_argument("--datasets", default="mushrooms,a5a,phishing")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--spectral-lf", action="store_true",
                   help="tighter ||X1||_2^2/4m instead of the reference's "
                        "Frobenius norm(X1*X1')/4m (runme.jl:58-59)")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)

    for ds in args.datasets.split(","):
        path = os.path.join(args.outdir, f"{os.path.basename(ds)}.jsonl")
        sink = Sink(path)
        src = run_logreg_l1_data(ds, sink, lam=args.lam, tol=args.tol, maxit=args.maxit, live=args.live,
                                 spectral_lf=args.spectral_lf)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
