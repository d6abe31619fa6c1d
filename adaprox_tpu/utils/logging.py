"""Telemetry: the reference's JSONL record schema, reproduced verbatim.

The reference emits one JSON object per solver iteration on a custom log
level (src/AdaProx.jl:7; experiments/logging.jl:19-42 tees them to a .jsonl
file plus a log-decimated console echo). Logging from inside a compiled device
loop would stall the device pipeline on a host callback every iteration, so
the engine instead returns the stacked per-iteration `Records` arrays and
this module writes the identical JSONL post-hoc.

Schema per row (matching @logmsg Record kwargs at src/AdaProx.jl:56,74,135,
184,351,539,621):

    {"method": name, "it": k, "gamma": ..., ["sigma": ...,] "norm_res": ...,
     "objective": ..., "grad_f_evals": n, "prox_g_evals": n,
     ["prox_h_evals": n, "A_evals": n, "At_evals": n,] "f_evals": n}

`is_logstep` (experiments/logging.jl:13-17) and `find_best`
(experiments/logging.jl:48-67) are ported for the experiment drivers.
"""

from __future__ import annotations

import json
import math
import time
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "records_to_rows",
    "write_records_jsonl",
    "write_jsonl",
    "append_jsonl_row",
    "read_jsonl",
    "is_logstep",
    "find_best",
    "echo_logstep_rows",
]

PG_KEYS = ["method", "it", "gamma", "norm_res", "objective",
           "grad_f_evals", "prox_g_evals", "f_evals"]
PD_KEYS = ["method", "it", "gamma", "sigma", "norm_res", "objective",
           "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
           "At_evals", "f_evals"]

_COUNT_KEYS = ("f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals",
               "A_evals", "At_evals")


def records_to_rows(records, method: Optional[str], *, primal_dual: Optional[bool] = None):
    """Materialize a solver's `Records` pytree into JSONL-ready dict rows.

    Only valid (pre-convergence) rows are emitted. ``primal_dual`` selects
    the PD schema (adds sigma / prox_h / A / At columns); by default it is
    inferred from whether any A_evals were metered.
    """
    r = {k: np.asarray(getattr(records, k)) for k in records._fields}
    valid = r["valid"].astype(bool)
    n = int(valid.sum())
    if primal_dual is None:
        primal_dual = bool(r["A_evals"][valid].max(initial=0) > 0)
    keys = PD_KEYS if primal_dual else PG_KEYS
    rows = []
    for i in np.nonzero(valid)[0][:n]:
        row = {}
        for k in keys:
            if k == "method":
                row[k] = method
            elif k in _COUNT_KEYS or k == "it":
                row[k] = int(r[k][i])
            else:
                row[k] = float(r[k][i])
        rows.append(row)
    return rows


def write_records_jsonl(path, records, method: Optional[str], *,
                        primal_dual: Optional[bool] = None,
                        keys: Optional[Sequence[str]] = None):
    """Write a solver's stacked ``Records`` straight to JSONL.

    Fast path: ONE call into the native C++ sink (native/jsonl_sink.cpp)
    with the column matrix — no per-row dicts, no per-row json.dumps
    (4-6x the Python writer on full experiment sweeps). Falls back to
    ``records_to_rows`` + ``write_jsonl`` when the toolchain is absent.

    Returns ``(n_rows_written, last_row_dict_or_None)`` — the last row
    feeds the log-spaced console echo.
    """
    r = {k: np.asarray(getattr(records, k)) for k in records._fields}
    valid = r["valid"].astype(bool)
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return 0, None
    if primal_dual is None:
        primal_dual = bool(r["A_evals"][valid].max(initial=0) > 0)
    schema = PD_KEYS if primal_dual else PG_KEYS
    # projection preserves the caller's key ORDER (reference logging.jl:24-27)
    cols = [k for k in (keys if keys is not None else schema)
            if k != "method" and k in schema]
    emit_method = method if (keys is None or "method" in keys) else None

    last_i = idx[-1]
    # echo row carries the FULL schema (the console echo needs 'it' for its
    # log-spaced predicate even when the file projection drops it — the
    # pre-native Sink echoed the unprojected row)
    last_row = {}
    for k in schema:
        if k == "method":
            last_row[k] = method
        elif k in _COUNT_KEYS or k == "it":
            last_row[k] = int(r[k][last_i])
        elif k in r:
            last_row[k] = float(r[k][last_i])

    from ..native import write_jsonl_native

    # the C++ sink always writes the method column FIRST; a projection that
    # places "method" elsewhere must take the Python path or the bytes
    # would differ between hosts with/without a toolchain (review r5-7) —
    # every reference schema and driver projection is method-first, so the
    # fast path still covers all real callers
    native_ok = (keys is None or "method" not in keys
                 or list(keys).index("method") == 0)
    values = np.stack([r[k][idx].astype(np.float64) for k in cols], axis=1)
    is_int = [1 if (k in _COUNT_KEYS or k == "it") else 0 for k in cols]
    if native_ok and write_jsonl_native(path, emit_method, cols, values,
                                        is_int):
        return int(idx.size), last_row

    rows = records_to_rows(records, method, primal_dual=primal_dual)
    write_jsonl(path, rows, keys=keys)
    return len(rows), last_row


def write_jsonl(path, rows: Iterable[dict], *, keys: Optional[Sequence[str]] = None,
                mode: str = "a"):
    """Write rows as JSON-lines; optional key projection like the reference's
    ``get_logger(path, keys)`` (experiments/logging.jl:24-27)."""
    with open(path, mode) as fh:
        for row in rows:
            if keys is not None:
                row = {k: row[k] for k in keys if k in row}
            fh.write(json.dumps(row) + "\n")


def append_jsonl_row(path, row: dict):
    write_jsonl(path, [row], mode="a")


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def is_logstep(it: int, base: int = 10) -> bool:
    """True when `it` is a multiple of the current power of `base`
    (experiments/logging.jl:13-17) — used to decimate console echo."""
    if it <= 0:
        return False
    scale = math.floor(math.log(it, base))
    step = base**scale
    return it % step == 0


def echo_logstep_rows(rows, base: int = 10, out=print):
    """Console echo of log-spaced rows with a timestamp, mirroring the
    reference's decimated ConsoleLogger (experiments/logging.jl:29-41)."""
    for row in rows:
        if is_logstep(int(row.get("it", 0)), base):
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            out(f"[{stamp}] " + json.dumps(row))


def find_best(groups: dict, names, objective_key: str, objective_target: float,
              duration_key):
    """Pick the best hyperparameter variant per method family
    (experiments/logging.jl:48-67): among runs whose final ``objective_key``
    reached ``objective_target``, the one with the smallest duration
    (max of ``duration_key`` — a column name or a callable on the rows);
    if none reached target, the one with the best final value.

    ``groups`` maps name -> list of record rows (dicts).
    """
    def duration(rows):
        if callable(duration_key):
            return max(duration_key(row) for row in rows)
        return max(row[duration_key] for row in rows)

    names = list(names)
    best_name, rest = names[0], names[1:]
    best_duration = -1.0
    best_val = groups[best_name][-1][objective_key]
    if best_val <= objective_target:
        best_duration = duration(groups[best_name])
    for name in rest:
        dur = duration(groups[name])
        val = groups[name][-1][objective_key]
        if val <= objective_target and (dur < best_duration or best_duration < 0):
            best_name = name
            best_duration = dur
        elif best_duration < 0 and val < best_val:
            best_name = name
            best_val = val
    return best_name
