"""Dual SVM experiment (experiments/dual_svm/runme.jl).

Box-constrained QP with one equality via the composite term:
f = 0.5 x'Qx + q'x with Q = D_y X X' D_y, q = -1 (runme.jl:47-50);
g = IndBox(0, C); h = IndZero; A = y' (1 x N). Sweeps the coupling t over 12
values for AdaPDM and Malitsky-Pock, plus Condat-Vu; datasets svmguide3 /
mushrooms / heart_scale x C in {0.1, 1}; maxit 10_000, tol 1e-5; logs only
[method, it, f_evals, norm_res] (runme.jl:141).

Addition over the reference: the AdaPDM and Malitsky-Pock t-sweeps also
run as ONE vmapped compiled program over the rule's t leaf (--vmap-sweep),
replacing the reference's sequential loop (runme.jl:63-76).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import Sink, group_rows, pick_platform, plot_lines, run_timed

T_VALUES = [0.01, 0.15, 0.02, 0.025, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10]
KEYS = ["method", "it", "f_evals", "norm_res"]


def _load(name_or_path):
    from adaprox_tpu.utils.datasets import load_or_synthesize
    from adaprox_tpu.utils.libsvm import load_libsvm_dataset

    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path, labels=(-1.0, 1.0))
        return x_np, y_np, "libsvm"
    return load_or_synthesize(str(name_or_path), labels=(-1.0, 1.0))


def run_dsvm(name_or_path, sink, big_c=0.1, tol=1e-5, maxit=10_000, vmap_sweep=False,
             exact_bregman=None, live=False):
    import jax
    import jax.numpy as jnp

    import adaprox_tpu as ap
    from adaprox_tpu.models.objectives import FactoredQuadratic

    x_np, y_np, source = _load(name_or_path)
    n_pts = y_np.shape[0]

    # factored objective: f = 0.5 x'(B B')x - 1'x with B = D_y X — never
    # materializes the (N, N) Gram the reference builds host-side
    # (runme.jl:47-48): 2*N*d instead of N^2 of traffic per product, and
    # the largest array stays N x d.
    dyx = jnp.asarray(y_np)[:, None] * jnp.asarray(x_np)
    q_vec = -jnp.ones(n_pts, dyx.dtype)
    f = FactoredQuadratic(b_mat=dyx, q_vec=q_vec)
    g = ap.IndBox(lo=0.0, hi=float(big_c))
    h = ap.IndZero()
    a_op = ap.DenseOperator(a=jnp.asarray(y_np[None, :]))
    lf = float(f.norm_q())  # Julia norm(Q) = Frobenius (runme.jl:56), gram-free
    norm_a = float(np.linalg.norm(y_np))

    x0 = jnp.zeros(n_pts)
    y0 = jnp.zeros(1)
    times = {}
    # MP linesearch acceptance: below f64 the reference's raw objective
    # difference carries eps*|f| noise that stalls every MP row at this
    # problem scale (residual ~2e+01 vs the f64 plateau 5e-05 — mirror-
    # adjudicated in tools/adjudicate_dsvm.py); auto-enable the oracle's
    # cancellation-resistant Bregman form for any narrower dtype (f32,
    # bf16, f16 — the cancellation is worse the fewer mantissa bits).
    # f64 keeps reference-exact trajectories by default.
    if exact_bregman is None:
        exact_bregman = jnp.finfo(dyx.dtype).bits < 64

    import time as _time

    if live and vmap_sweep:
        print("  [live] --live applies to the sequential engine path; "
              "running the requested fast path without in-flight echo")
    if live and not vmap_sweep:
        # reference-style in-flight echo (PD schema): both t-sweeps + CV
        # as early-exit solves (common.live_menu); sigma = t^2 * gamma for
        # the AdaPDM rows (the engine carry holds both, no fixup needed)
        from .common import live_menu

        # objective=None: the row objective would be h(Ax) = IndZero's inf
        # on every pre-convergence iterate (the history-mode rows print
        # Infinity for the same reason), the driver's KEYS projection drops
        # the column from the JSONL anyway, and computing it costs two
        # matvecs of device work per echoed row — skip it (NaN column)
        live_menu(sink, times, [
            (f"AdaPDM (t={t})", maxit,
             lambda t=t, **o: ap.adaptive_primal_dual(
                 x0, y0, f=f, g=g, h=h, A=a_op,
                 rule=ap.AdaPGMRule.make(t=float(t), norm_a=norm_a),
                 tol=tol, name=f"AdaPDM (t={t})", **o))
            for t in T_VALUES
        ] + [
            (f"Malitsky-Pock (t={t})", maxit,
             lambda t=t, **o: ap.malitsky_pock(
                 x0, y0, f=f, g=g, h=h, A=a_op, t=float(t),
                 sigma=1.0 / norm_a, tol=tol,
                 name=f"Malitsky-Pock (t={t})",
                 exact_bregman=bool(exact_bregman), **o),
             lambda row, res, t=t: {**row, "gamma": t * t * row["sigma"]})
            for t in T_VALUES
        ] + [
            ("Condat-Vu", maxit, lambda **o: ap.condat_vu(
                x0, y0, f=f, g=g, h=h, A=a_op, Lf=lf, tol=tol,
                name="Condat-Vu", **o)),
        ], objective=None, primal_dual=True)
        sink.emit_meta(wall_s=times, fast_path="live", fast_methods=[])
        return source

    if vmap_sweep:
        # one compiled program for the whole t grid
        def solve_t(t):
            res = ap.adaptive_primal_dual(
                x0, y0, f=f, g=g, h=h, A=a_op,
                rule=ap.AdaPGMRule.make(gamma=1.0 / (2 * 1.2 * t * norm_a), t=t,
                                        norm_a=norm_a),
                tol=tol, maxit=maxit, history=True,
            )
            return res._replace(name=None)  # strings can't ride through vmap

        t0 = _time.perf_counter()
        batched = jax.vmap(solve_t)(jnp.asarray(T_VALUES))
        for i, t in enumerate(T_VALUES):
            one = jax.tree_util.tree_map(lambda arr: arr[i], batched)
            sink.add(one.with_name(f"AdaPDM (t={t})"), primal_dual=True)
        times["AdaPDM t-sweep (vmap)"] = round(_time.perf_counter() - t0, 4)
    else:
        t0 = _time.perf_counter()
        for t in T_VALUES:
            sink.add(ap.adaptive_primal_dual(
                x0, y0, f=f, g=g, h=h, A=a_op,
                rule=ap.AdaPGMRule.make(t=float(t), norm_a=norm_a),
                tol=tol, maxit=maxit, history=True, name=f"AdaPDM (t={t})",
            ), primal_dual=True)
        times["AdaPDM t-sweep"] = round(_time.perf_counter() - t0, 4)

    if vmap_sweep:
        # nested while (linesearch) inside scan inside vmap — one program
        def solve_mp(t):
            res = ap.malitsky_pock(
                x0, y0, f=f, g=g, h=h, A=a_op, t=t, sigma=1.0 / norm_a,
                tol=tol, maxit=maxit, history=True,
                exact_bregman=bool(exact_bregman),
            )
            return res._replace(name=None, extra=None)

        t0 = _time.perf_counter()
        batched = jax.vmap(solve_mp)(jnp.asarray(T_VALUES))
        for i, t in enumerate(T_VALUES):
            one = jax.tree_util.tree_map(lambda arr: arr[i], batched)
            sink.add(one.with_name(f"Malitsky-Pock (t={t})"), primal_dual=True)
        times["MP t-sweep (vmap)"] = round(_time.perf_counter() - t0, 4)
    else:
        t0 = _time.perf_counter()
        for t in T_VALUES:
            sink.add(ap.malitsky_pock(
                x0, y0, f=f, g=g, h=h, A=a_op, t=float(t), sigma=1.0 / norm_a,
                tol=tol, maxit=maxit, history=True, name=f"Malitsky-Pock (t={t})",
                exact_bregman=bool(exact_bregman),
            ), primal_dual=True)
        times["MP t-sweep"] = round(_time.perf_counter() - t0, 4)

    sink.add(run_timed(times, "Condat-Vu", lambda: ap.condat_vu(
        x0, y0, f=f, g=g, h=h, A=a_op, Lf=lf, tol=tol, maxit=maxit,
        history=True, name="Condat-Vu",
    )), primal_dual=True)
    sink.emit_meta(
        wall_s=times, fast_path="vmap" if vmap_sweep else "default",
        fast_methods=["AdaPDM t-sweep (vmap)"] if vmap_sweep else [])
    return source


def plot_residual(path):
    from ..utils.logging import find_best, read_jsonl

    rows = read_jsonl(path)
    groups = group_rows(rows)
    names_to_plot = []
    for fam in ["Condat-Vu", "Malitsky-Pock", "AdaPDM"]:
        matching = [k for k in groups if k.startswith(fam)]
        if matching:
            names_to_plot.append(find_best(groups, matching, "norm_res", 1e-5, "f_evals"))
    series = [
        (name, [r["f_evals"] for r in groups[name]],
         [r["norm_res"] for r in groups[name]])
        for name in names_to_plot
    ]
    return plot_lines(path, series, f"Dual SVM ({os.path.basename(path)})",
                      "#passes through data", "||v||")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/dual_svm")
    p.add_argument("--maxit", type=int, default=10_000)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--datasets", default="svmguide3,mushrooms,heart_scale")
    p.add_argument("--C", default="0.1,1")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="f64 on the accelerator (reference-regime parity)")
    p.add_argument("--vmap-sweep", action="store_true")
    p.add_argument("--live", action="store_true",
                   help="early-exit solves with in-flight log-spaced echo")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--exact-bregman", choices=("auto", "on", "off"),
                   default="auto",
                   help="MP linesearch Bregman term: 'auto' uses the "
                        "cancellation-resistant quadratic form in f32 "
                        "(where the reference's raw difference stalls at "
                        "eps*|f| noise) and the reference-exact difference "
                        "in f64")
    args = p.parse_args(argv)
    pick_platform(args.cpu, x64=args.f64)
    exact_breg = {"auto": None, "on": True, "off": False}[args.exact_bregman]

    for big_c in (float(v) for v in args.C.split(",")):
        for ds in args.datasets.split(","):
            path = os.path.join(args.outdir, f"{os.path.basename(ds)}_C_{big_c}.jsonl")
            sink = Sink(path, keys=KEYS)
            src = run_dsvm(ds, sink, big_c=big_c, tol=args.tol, maxit=args.maxit,
                           vmap_sweep=args.vmap_sweep,
                           exact_bregman=exact_breg, live=args.live)
            sink.emit_meta(data_source=src)
            print(f"{path}: data={src}")
            if not args.no_plot:
                plot_residual(path)


if __name__ == "__main__":
    main()
