"""Shared experiment harness.

Each experiment driver mirrors its reference `runme.jl`: build the problem,
run every applicable solver with history=True, write the reference-schema
JSONL (utils.logging), echo log-spaced rows to the console, and plot
convergence from the JSONL. Solvers run as compiled scan-mode programs; the
JSONL is written post-hoc from the stacked records.
"""

from __future__ import annotations

import os
from collections import defaultdict
import numpy as np

from ..platform import pick_platform
from ..utils import logging as tlog

__all__ = ["Sink", "group_rows", "plot_lines", "pick_platform", "run_timed"]


def run_timed(times, name, fn):
    """Run ``fn`` and record its wall time under ``name``, ended by
    ``jax.block_until_ready`` on every array of the result. Includes one
    compile — experiment rows are each compiled once anyway, so the wall
    column reflects what a user waits for; per-iteration rates belong to
    bench.py."""
    import time as _time

    import jax

    t0 = _time.perf_counter()
    res = jax.block_until_ready(fn())
    times[name] = round(_time.perf_counter() - t0, 4)
    return res


def live_menu(sink, times, menu, objective=None, primal_dual=False,
              fixup=None, pipeline=1):
    """Run a method menu with live telemetry (the drivers' --live mode):
    each entry is (name, maxit, make) — or (name, maxit, make, fixup) for
    a per-entry row fixup overriding the menu-wide one — where
    ``make(**overrides)`` accepts maxit=, resume_state=, it_cap=,
    history= and returns a SolveResult.
    Early-exit history=False solves, reference-format rows echoed while
    solving (utils.live.live_solve with the scan-prefix for the early
    decades); the JSONL gets the log-spaced rows. ``pipeline`` defaults to
    1 here (not live_solve's 4): menu solves are tol-based early exits,
    and every chunk enqueued past convergence runs to its boundary before
    being discarded."""
    from ..utils.live import live_solve

    for entry in menu:
        name, mx, make = entry[:3]
        efix = entry[3] if len(entry) > 3 else fixup
        def do(name=name, mx=mx, make=make, efix=efix):
            res, rows = live_solve(
                lambda maxit, resume_state, it_cap: make(
                    maxit=maxit, resume_state=resume_state, it_cap=it_cap),
                mx, method=name, objective=objective,
                primal_dual=primal_dual, fixup=efix, pipeline=pipeline,
                # first two echo decades as one scan chunk: their
                # boundaries are 1-10 iterations apart, less device work
                # than one dispatch each
                hist_solve_fn=lambda maxit, make=make: make(
                    maxit=maxit, history=True))
            tlog.write_jsonl(sink.path, rows, keys=sink.keys)
            return res
        run_timed(times, name, do)


def run_menu(sink, times, menu, *, live, objective=None, primal_dual=False,
             fixup=None, pipeline=1):
    """Run a method menu either as history=True record solves (default) or
    with live telemetry (--live) — the shared driver wiring, so the
    fast_path label and the live/else split cannot drift per driver.
    Returns the fast_path label for the driver's meta row."""
    if live:
        live_menu(sink, times, menu, objective=objective,
                  primal_dual=primal_dual, fixup=fixup, pipeline=pipeline)
        return "live"
    for entry in menu:
        name, mx, make = entry[:3]
        sink.add(run_timed(times, name, lambda mx=mx, make=make: make(
            maxit=mx, history=True)), primal_dual=primal_dual or None)
    return "default"


class Sink:
    """JSONL sink + console echo for one experiment output file."""

    def __init__(self, path, keys=None, echo=True, base=10):
        self.path = str(path)
        self.keys = keys
        self.echo = echo
        self.base = base
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        open(self.path, "w").close()  # truncate

    def emit_pseudo(self, row: dict):
        """A non-solver record (e.g. the known optimum, lasso runme.jl:79)."""
        tlog.write_jsonl(self.path, [row], keys=self.keys)

    def emit_meta(self, **meta):
        """An unprojected metadata row (e.g. data_source) — bypasses the key
        projection so labels like synthetic-vs-libsvm survive into the file
        (summaries must say which tables ran on fallback data)."""
        tlog.write_jsonl(self.path, [dict(meta)], keys=None)

    def add(self, result, primal_dual=None):
        n, last = tlog.write_records_jsonl(
            self.path, result.records, result.name,
            primal_dual=primal_dual, keys=self.keys)
        if self.echo and last is not None:
            tlog.echo_logstep_rows([last], self.base)
        return n


def group_rows(rows):
    by = defaultdict(list)
    for r in rows:
        if r.get("method") is None:
            continue
        by[r["method"]].append(r)
    return by


def plot_lines(path, series, title, xlabel, ylabel, out_path=None):
    """Convergence plot: log-y lines per method (the reference's
    plot_convergence/plot_residual shape). ``series`` is a list of
    (label, xs, ys)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, ax = plt.subplots(figsize=(7, 5))
    for label, xs, ys in series:
        ys = np.maximum(np.asarray(ys, float), 1e-14)
        ax.semilogy(xs, ys, label=label, linewidth=1.2)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=7)
    fig.tight_layout()
    out = out_path or (str(path) + ".pdf")
    fig.savefig(out)
    plt.close(fig)
    return out
