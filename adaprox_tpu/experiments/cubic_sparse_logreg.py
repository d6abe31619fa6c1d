"""Cubic-regularized logistic-regression subproblem
(experiments/cubic_sparse_logreg/runme.jl).

Builds the exact logistic Hessian H and gradient q at x0 = 0
(logistic_loss_grad_Hessian, runme.jl:34-45), solves the cubic model
f = 0.5 x'Qx + q'x + (c/6)||x||^3 with g = 0; gamma0 from a random
perturbation secant estimate (runme.jl:72-76); maxit 100, tol 1e-7.
Cost metric: f_evals (1 f-eval = 1 Q-mul).
"""

from __future__ import annotations

import argparse
import os
import numpy as np

from .common import Sink, group_rows, pick_platform, plot_lines, run_menu, run_timed


def logistic_loss_grad_hessian(x_np, y_np, w):
    """Reference runme.jl:34-45 with the bias column folded in last."""
    m = y_np.shape[0]
    logits = x_np @ w[:-1] + w[-1]
    probs = 1.0 / (1.0 + np.exp(-logits))
    g = x_np.T @ (probs - y_np) / m
    g = np.concatenate([g, [np.mean(probs - y_np)]])
    sb = probs * (1 - probs) / m
    xr = x_np.T @ sb  # X' R 1
    h = np.block([
        [x_np.T @ (sb[:, None] * x_np), xr[:, None]],
        [xr[None, :], np.array([[sb.sum()]])],
    ])
    return h, g


def run_cubic_logreg_data(name_or_path, sink, lam=1.0, tol=1e-7, maxit=100, live=False,
                          seed=0):
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import Cubic
    from adaprox_tpu.utils.datasets import load_or_synthesize
    from adaprox_tpu.utils.libsvm import load_libsvm_dataset

    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path, labels=(0.0, 1.0))
        source = "libsvm"
    else:
        x_np, y_np, source = load_or_synthesize(str(name_or_path), labels=(0.0, 1.0))
    n = x_np.shape[1] + 1

    rng = np.random.default_rng(seed)
    x0_np = np.zeros(n)
    q_mat, q_vec = logistic_loss_grad_hessian(x_np, y_np, x0_np)
    f = Cubic(q_mat=jnp.asarray(q_mat), q_vec=jnp.asarray(q_vec), c=jnp.asarray(float(lam)))
    g = ap.Zero()

    # secant gamma0 from a random perturbation (runme.jl:72-76)
    x_pert = x0_np + rng.standard_normal(n)
    _, g0 = f.value_and_grad(jnp.asarray(x0_np))
    _, gp = f.value_and_grad(jnp.asarray(x_pert))
    dx = x0_np - x_pert
    gam = float(dx @ dx / (np.asarray(g0 - gp) @ dx))

    x0 = jnp.zeros(n)

    times = {}

    def add(name, fn):
        sink.add(run_timed(times, name or "(ground truth)", fn))

    # ground-truth prerun (tol/10): feeds the optimum pseudo-record
    add(None, lambda: ap.adaptive_proxgrad(
        x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=gam), tol=tol / 10,
        maxit=maxit * 10, history=True, name=None))
    base = dict(f=f, g=g, tol=tol)
    menu = [
        (f"PGM (backtracking)-(xi={xi})", maxit,
         lambda xi=xi, **o: ap.backtracking_proxgrad(
             x0, gamma0=gam, xi=xi,
             name=f"PGM (backtracking)-(xi={xi})", **base, **o))
        for xi in (1.0, 1.5, 2.0)
    ] + [
        ("Nesterov (backtracking)", maxit,
         lambda **o: ap.backtracking_nesterov(
             x0, gamma0=gam, name="Nesterov (backtracking)", **base, **o)),
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
        (name, [r["f_evals"] for r in rs], [r["objective"] - optimum for r in rs])
        for name, rs in groups.items()
    ]
    return plot_lines(path, series, f"Cubic regularization ({os.path.basename(path)})",
                      "# of calls to Q", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/cubic_sparse_logreg")
    p.add_argument("--maxit", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--datasets", default="mushrooms,a5a,phishing")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)

    for ds in args.datasets.split(","):
        path = os.path.join(args.outdir, f"{os.path.basename(ds)}.jsonl")
        sink = Sink(path)
        src = run_cubic_logreg_data(ds, sink, lam=args.lam, tol=args.tol, live=args.live,
                                    maxit=args.maxit)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
