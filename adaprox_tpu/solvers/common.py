"""Shared solver types: oracle counters, per-iteration records, results.

The reference meters oracle calls with mutable `Counting` wrappers
(src/counting.jl:16-97) and logs one structured record per iteration on a
custom log level (src/AdaProx.jl:7,351). Under `jit` both become data:

  * ``Counters`` ride the loop carry and are incremented at exactly the call
    sites the reference meters, so the oracle-call x-axis of every reference
    plot is reproduced bit-for-bit.
  * ``Records`` are the scan-stacked history (one row per iteration, masked
    by ``valid``) from which the JSONL telemetry is written post-hoc —
    host callbacks inside the hot loop would serialize every iteration
    against the device queue.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class Counters(NamedTuple):
    """Oracle-call meters (reference src/counting.jl fields)."""

    f_evals: jnp.ndarray = np.int32(0)
    grad_f_evals: jnp.ndarray = np.int32(0)
    prox_g_evals: jnp.ndarray = np.int32(0)
    prox_h_evals: jnp.ndarray = np.int32(0)
    A_evals: jnp.ndarray = np.int32(0)
    At_evals: jnp.ndarray = np.int32(0)

    @staticmethod
    def zeros():
        return Counters(*(jnp.zeros((), jnp.int32) for _ in range(6)))

    def bump(self, **deltas):
        return self._replace(**{k: getattr(self, k) + v for k, v in deltas.items()})


class Records(NamedTuple):
    """Per-iteration history (scan mode). Arrays of shape (maxit,)."""

    it: jnp.ndarray
    gamma: jnp.ndarray
    sigma: jnp.ndarray
    norm_res: jnp.ndarray
    objective: jnp.ndarray
    f_evals: jnp.ndarray
    grad_f_evals: jnp.ndarray
    prox_g_evals: jnp.ndarray
    prox_h_evals: jnp.ndarray
    A_evals: jnp.ndarray
    At_evals: jnp.ndarray
    valid: jnp.ndarray


class SolveResult(NamedTuple):
    """What every solver returns. The reference returns ``(x, numit)`` or
    ``(x, y, numit)``; here counters/records/norm_res come along for free.

    ``extra`` is the solver's final loop carry — pass it back as
    ``resume_state=`` (possibly via utils.checkpoint) to continue the solve
    bit-exactly. ``diag`` holds failure-detection scalars (the reference only
    error-logs these and continues, src/AdaProx.jl:40-42,566-568):

      * ``stepsize_underflow`` — the accepted step fell below 1e-12;
      * ``trials_exhausted`` — a backtracking/linesearch inner loop hit the
        trip-count cap with its acceptance test still failing, so a
        not-sufficiently-decreasing point was accepted (solvers with an
        inner loop only).
    """

    x: jnp.ndarray
    y: Optional[jnp.ndarray]
    numit: jnp.ndarray
    norm_res: jnp.ndarray
    counters: Counters
    records: Optional[Records] = None
    name: Optional[str] = None
    extra: Any = None
    diag: Optional[dict] = None

    def with_name(self, name):
        return self._replace(name=name)


def l2sq(v):
    """||v||^2 for REAL dtypes (the supported domain — for complex this
    would need vdot(v, v).real, cf. Curvature.of's .real)."""
    return jnp.sum(v * v)


def cast_floats(tree, dtype):
    """Cast every floating leaf of a pytree to ``dtype``.

    Solvers call this on rules/scalar parameters so the loop carry has one
    consistent float dtype regardless of how the caller's python floats were
    committed (e.g. f64 under jax_enable_x64 with f32 iterates)."""

    def cast(v):
        v = jnp.asarray(v)
        return v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating) else v

    return jax.tree_util.tree_map(cast, tree)


def reopen(carry, dtype, scalar_dtype=None, scalar_fields=()):
    """Reset a checkpointed loop carry so the solver loop runs again from it:
    un-latch ``done`` (the loop's only gate). Everything else — counters,
    rule state, previous-iterate curvature memory, and the last known
    ``norm_res`` (truthful if the resumed run is granted zero further
    iterations) — is preserved, so a resumed solve continues bit-exactly.

    ``scalar_fields``: the carry fields the solver keeps in the
    ``scalar_dtype`` hybrid precision (step sizes, rule state, residual
    norms). They are cast to ``scalar_dtype`` here so a carry saved under
    one scalar precision can resume under another — otherwise the step
    body's sdt outputs mismatch the reopened carry and ``lax.while_loop``
    rejects the structure."""
    del dtype
    upd = {"done": jnp.zeros((), jnp.bool_)}
    if scalar_dtype is not None:
        sdt = jnp.dtype(scalar_dtype)

        def _cast(v):
            if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
                return v.astype(sdt)
            return v

        for name in scalar_fields:
            upd[name] = jax.tree_util.tree_map(_cast, getattr(carry, name))
    return carry._replace(**upd)


def run_loop(carry0, step, maxit, history, it_cap=None):
    """Drive a solver iteration in one of two execution modes.

    ``step: carry -> (carry, Records-row)`` must maintain ``carry.it``
    (int32, incremented once per iteration) and ``carry.done`` (bool,
    latched when the stop criterion fires).

    * ``history=False``: ``lax.while_loop`` — early exit, no history
      (production solve; minimal memory traffic).
    * ``history=True``: ``lax.scan`` over a fixed ``maxit`` trip count with a
      freeze-on-done mask — fully unrollable/pipelineable by XLA and yields
      the stacked per-iteration records for telemetry (the reference logs
      per-iteration from inside the loop; we log post-hoc from these arrays).

    ``it_cap``: optional TRACED cumulative iteration bound for the
    while_loop path — the hook live telemetry chunks on (utils.live): the
    host re-dispatches ONE compiled executable with growing caps and
    echoes a reference-format row between chunks, instead of recompiling
    per boundary (``maxit`` is a static jit argument; a traced cap is
    not). No effect on the loop body, so a capped run continued via
    ``resume_state`` is bit-identical to an uninterrupted one.

    Returns ``(final_carry, records_or_None)``.
    """
    if history:
        if it_cap is not None:
            raise ValueError("it_cap applies to the while_loop path only "
                             "(history=True already records every row)")

        def scan_body(c, _):
            # ``maxit`` is the CUMULATIVE iteration cap (resume semantics,
            # same as the while_loop cond below): a resumed carry with
            # it0 > 0 gets maxit - it0 live trips, the rest frozen. For a
            # fresh solve c.it < maxit on every trip — no behavior change.
            gate = jnp.logical_or(c.done, c.it >= maxit)
            new, rec = step(c)
            frozen = jax.tree_util.tree_map(
                lambda a, b: jnp.where(gate, a, b), c, new
            )
            rec = rec._replace(valid=jnp.logical_and(rec.valid, c.it < maxit))
            return frozen, rec

        return jax.lax.scan(scan_body, carry0, None, length=maxit)

    def cond(c):
        live = jnp.logical_and(c.it < maxit, jnp.logical_not(c.done))
        if it_cap is not None:
            live = jnp.logical_and(live, c.it < it_cap)
        return live

    def body(c):
        new = step(c)[0]
        # freeze once done: a no-op for a single solve (the loop exits on
        # done), but REQUIRED under vmap, where the batched loop keeps
        # stepping every element until all are done
        return jax.tree_util.tree_map(lambda a, b: jnp.where(c.done, a, b), c, new)

    final = jax.lax.while_loop(cond, body, carry0)
    return final, None
