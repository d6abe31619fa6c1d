"""Run the complete reference experiment grid end to end.

``python -m adaprox_tpu.experiments.run_all [--fast] [--cpu] [--outdir results]``

--fast shrinks budgets for smoke runs; default budgets are the reference's
(SURVEY §6 table). Prints one summary line per output file.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--fast-paths", action="store_true",
                   help="run the t-sweeps as vmapped programs and, on the "
                        "GPU, the lasso on the one-pass oracle")
    args = p.parse_args(argv)

    from . import (
        cubic_sparse_logreg,
        dual_svm,
        lasso,
        least_absolute_deviation,
        nesterov_worst_case,
        sparse_logreg,
        square_root_lasso,
    )

    plot = ["--no-plot"] if args.no_plot else []
    cpu = ["--cpu"] if args.cpu else []
    if args.f64:
        cpu = cpu + ["--f64"]

    def budget(full, fast):
        return str(fast if args.fast else full)

    jobs = [
        ("lasso", lasso.main, [
            "--outdir", f"{args.outdir}/lasso", "--maxit", budget(2000, 200),
            "--sizes", "100x300x10,500x1000x10" + ("" if args.fast else ",4000x1000x10"),
        ]),
        ("sparse_logreg", sparse_logreg.main, [
            "--outdir", f"{args.outdir}/sparse_logreg", "--maxit", budget(2000, 100),
        ]),
        ("cubic_sparse_logreg", cubic_sparse_logreg.main, [
            "--outdir", f"{args.outdir}/cubic_sparse_logreg", "--maxit", budget(100, 40),
        ]),
        ("dual_svm", dual_svm.main, [
            "--outdir", f"{args.outdir}/dual_svm", "--maxit", budget(10_000, 200),
        ]),
        ("square_root_lasso", square_root_lasso.main, [
            "--outdir", f"{args.outdir}/square_root_lasso", "--maxit", budget(5000, 100),
        ]),
        ("least_absolute_deviation", least_absolute_deviation.main, [
            "--outdir", f"{args.outdir}/least_absolute_deviation", "--maxit", budget(5000, 100),
        ]),
        ("nesterov_worst_case", nesterov_worst_case.main, [
            "--outdir", f"{args.outdir}/nesterov_worst_case", "--maxit", budget(10_000, 1000),
        ]),
    ]
    fast_flags = {
        "dual_svm": ["--vmap-sweep"],
        "square_root_lasso": ["--vmap-sweep"],
        "least_absolute_deviation": ["--vmap-sweep"],
    }
    if not args.cpu:  # the one-pass oracle is a GPU kernel
        fast_flags["lasso"] = ["--fused"]
    for name, fn, extra in jobs:
        t0 = time.time()
        if args.fast_paths:
            extra = extra + fast_flags.get(name, [])
        fn(extra + plot + cpu)
        print(f"== {name} done in {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
