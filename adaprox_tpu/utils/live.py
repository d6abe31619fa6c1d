"""Live log-spaced telemetry for early-exit (``history=False``) solves.

The reference echoes one record row per log-spaced iteration WHILE the
solve runs (emission inside every loop at src/AdaProx.jl:351, decimated by
the console logger at experiments/logging.jl:13-17,29-41). The framework's
``history=False`` path is a single ``lax.while_loop`` dispatch — silent
until it returns, which for a long solve is minutes of no observability.

``live_solve`` restores the reference behavior WITHOUT a host callback in
the hot loop (which would serialize every iteration against the device
queue) and WITHOUT recompiling: every solver's while_loop takes an
optional TRACED cumulative bound ``it_cap`` (solvers/common.run_loop), so
the host re-dispatches ONE compiled executable with caps at the log-spaced
boundaries, echoing a reference-format row between chunks from the carry's
at-check scalars. Chunking does not touch the loop body, so the live solve
is bit-identical to an uninterrupted one (tested).

Host round-trips are hidden where they can be: the next chunk is dispatched BEFORE syncing on the previous chunk's scalars (the
device streams straight into chunk k+1 while the host formats row k), and
each row costs exactly ONE ``jax.device_get`` batch transfer, not one per
scalar. If the chunk that was already in flight turns out to have started
past convergence, its result is simply discarded (functional solves — the
returned result is the converged one, bit-identical to uninterrupted).
"""

from __future__ import annotations

import json
import time

from .logging import PD_KEYS, PG_KEYS, is_logstep

__all__ = ["logstep_boundaries", "live_solve"]


def logstep_boundaries(maxit: int, base: int = 10):
    """All iterations in [1, maxit] the reference console echo would print
    (is_logstep, experiments/logging.jl:13-17), closed with maxit itself."""
    if maxit < 1:
        return []
    bounds = []
    step = 1
    it = 1
    while it <= maxit:
        bounds.append(it)
        it += step
        if it >= step * base:
            step *= base
    if bounds[-1] != maxit:
        bounds.append(maxit)
    return bounds


def _echo(row, out):
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    out(f"[{stamp}] " + json.dumps(row))


def _gather(res, objective):
    """Collect the device-side leaves one echo row needs WITHOUT syncing
    (the caller batches them into one jax.device_get round-trip)."""
    ex = res.extra
    ck = getattr(ex, "ck_counters", None)
    leaves = {
        "it": res.numit,
        "norm_res": res.norm_res,
        "done": ex.done,
        "counters": ck if ck is not None else res.counters,
    }
    for k in ("gamma", "sigma"):
        v = getattr(ex, k, None)
        if v is not None:
            leaves[k] = v
    if objective is not None:
        point = getattr(ex, "ck_x", None)
        leaves["objective"] = objective(point if point is not None else res.x)
    return leaves


def live_solve(solve_fn, maxit: int, *, method: str = "", objective=None,
               primal_dual: bool = False, base: int = 10, out=print,
               min_it: int = 1, fixup=None, pipeline: int = 4,
               hist_solve_fn=None, scan_prefix: int = 0):
    """Run an early-exit solve in log-spaced chunks, echoing one
    reference-format row per boundary while it runs.

    ``solve_fn(maxit=, resume_state=, it_cap=) -> SolveResult`` — a closure
    over any solver entry point with ``history=False`` (all solver families
    accept ``it_cap``). ``objective``: optional callable on the at-check
    iterate for the row's objective column (device-side, read in the row's
    batch transfer, uncounted — exactly the reference's
    ``without_counting`` record objective at src/AdaProx.jl:350-352);
    omitted, the column reads NaN. ``primal_dual`` selects the PD row
    schema (sigma + dual counters). ``min_it``: skip boundaries below this
    (cuts the tiny early dispatches when echo density matters less than
    throughput). ``fixup``: optional ``(row, result) -> row`` applied
    before echo — fills solver-specific columns the carry lacks (e.g.
    Malitsky-Pock's gamma = t^2 * sigma). Derive from ROW values; the
    ``result`` argument is the chunk result for chunked rows and ``None``
    for rows emitted from the scan prefix's records (there is no per-row
    result there — a fixup reading per-row state from ``result.extra``
    would silently get end-of-prefix values, so None fails loud instead).

    ``pipeline``: number of chunks enqueued AHEAD of the row the host is
    reading (resume chains are device-resident, so chunk k+1..k+d can all
    be in the device queue while row k's scalars reach the host). The cost
    of depth: when the
    solve converges mid-chunk, up to ``pipeline`` already-enqueued chunks
    run past convergence before being discarded (the returned result is
    still the converged chunk's, bit-exact) — set pipeline=0/1 for solves
    expected to converge long before maxit. ``True``/``False`` accepted
    as 1/0.

    ``hist_solve_fn(maxit=) -> SolveResult``: optional history=True
    closure over the SAME solver. When given, the first ``scan_prefix``
    iterations (default base^2 = the first two echo decades) run as ONE
    scan chunk whose stacked records yield every early row in a single
    transfer — the early log boundaries are 1-10 iterations apart, far
    less device work than one host round-trip each. Scan and while_loop share the step function and carry,
    so the handoff stays bit-exact.

    Returns ``(result, rows)`` — ``result`` is the final SolveResult,
    bit-identical to ``solve_fn(maxit=maxit)`` run uninterrupted; ``rows``
    are the echoed dicts.
    """
    from collections import deque

    import jax

    depth = int(pipeline)  # True -> 1, False -> 0
    keys = PD_KEYS if primal_dual else PG_KEYS
    bounds = [b for b in logstep_boundaries(maxit, base)
              if b >= min_it or b == maxit]
    rows = []
    if not bounds:
        return solve_fn(maxit=maxit, resume_state=None, it_cap=None), rows

    state = None
    if hist_solve_fn is not None:
        prefix = min(maxit, scan_prefix if scan_prefix > 0 else base * base)
        res0 = hist_solve_fn(maxit=prefix)
        # ONE transfer for every early row (records_to_rows syncs the
        # stacked arrays); emit the log-spaced subset in reference format
        from .logging import records_to_rows

        hist_rows = records_to_rows(res0.records, method,
                                    primal_dual=primal_dual)
        done0 = bool(res0.extra.done)
        it0 = int(res0.numit)
        for hrow, is_last in zip(hist_rows,
                                 [False] * (len(hist_rows) - 1) + [True]):
            hrow = {k: hrow.get(k, float("nan")) for k in keys}
            if fixup is not None:
                # no per-row result exists for prefix rows (the records are
                # stacked arrays); pass None so a fixup that wrongly relies
                # on result.extra fails loud instead of reading
                # end-of-prefix state for every early row
                hrow = fixup(hrow, None)
            if (is_logstep(int(hrow["it"]), base)
                    and int(hrow["it"]) >= min_it) or (
                    is_last and (done0 or it0 >= maxit)):
                _echo(hrow, out)
                rows.append(hrow)
        if done0 or it0 >= maxit or it0 < prefix:
            return res0, rows
        state = res0.extra
        bounds = [b for b in bounds if b > prefix]
        if not bounds:
            return res0, rows

    inflight = deque()
    idx = 0  # next boundary to enqueue

    def enqueue():
        nonlocal state, idx
        r = solve_fn(maxit=maxit, resume_state=state, it_cap=bounds[idx])
        state = r.extra  # device-resident: chains without a host sync
        inflight.append((r, _gather(r, objective)))
        idx += 1

    enqueue()
    while idx < min(1 + depth, len(bounds)):
        enqueue()

    last_it = -1
    while True:
        res, pending = inflight.popleft()
        vals = jax.device_get(pending)  # ONE round-trip per echo row
        it = int(vals["it"])
        done = bool(vals["done"])
        row = {}
        for k in keys:
            if k == "method":
                row[k] = method
            elif k == "it":
                row[k] = it
            elif k == "objective":
                row[k] = (float(vals["objective"])
                          if "objective" in vals else float("nan"))
            elif k in ("gamma", "sigma", "norm_res"):
                row[k] = float(vals[k]) if k in vals else float("nan")
            else:  # counter columns
                row[k] = int(getattr(vals["counters"], k))
        if fixup is not None:
            row = fixup(row, res)
        if is_logstep(it, base) or it >= maxit or done:
            _echo(row, out)
            rows.append(row)
        if done or it >= maxit or it == last_it:
            return res, rows  # in-flight successors discarded (functional)
        last_it = it
        if idx < len(bounds):
            enqueue()
        elif not inflight:
            return res, rows
