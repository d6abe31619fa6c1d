"""Eager oracle-call metering — API parity with the reference's `Counting`
wrapper (src/counting.jl:16-97) and `without_counting` (src/counting.jl:8-14).

Inside compiled solver loops, counters are pure data in the carry (see
solvers.common.Counters) — that is what the records/telemetry use. This
module provides the *eager* wrapper for interactive use and for porting the
reference's instrumentation tests (test/runtests.jl:53-90): it wraps a smooth
oracle, a prox operator, and/or a linear operator, and counts

    eval_count   — forward evaluations (value_and_aux / __call__ as oracle)
    grad_count   — pullback completions (grad_from_aux), metered lazily
    prox_count   — prox calls
    mul_count    — A @ x
    amul_count   — A' @ y  (via the .T adjoint view, ref counting.jl:76-82)

`without_counting` suppresses metering inside its context, mirroring the
global toggle at src/counting.jl:4-14 (used by solvers to exclude
logging-only objective evaluations).
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["Counting", "AdjointCounting", "without_counting", "is_counting_enabled"]

_state = threading.local()


def is_counting_enabled() -> bool:
    return getattr(_state, "enabled", True)


@contextlib.contextmanager
def without_counting():
    prev = is_counting_enabled()
    _state.enabled = False
    try:
        yield
    finally:
        _state.enabled = prev


class Counting:
    """Transparent metering wrapper over an oracle / prox op / linear op.

    NOTE: eager-only. Do not pass a `Counting` into a jitted solver — the
    Python-side increments would run once at trace time. Compiled solvers
    meter through their carry counters instead, which reproduce the same
    call-site accounting (verified by tests/test_utils.py::
    test_counting_semantics and the counter tests in tests/test_solvers.py).
    """

    def __init__(self, f):
        self.f = f
        self.eval_count = 0
        self.grad_count = 0
        self.prox_count = 0
        self.mul_count = 0
        self.amul_count = 0

    # -- smooth oracle protocol --------------------------------------------
    def value_and_aux(self, x):
        if is_counting_enabled():
            self.eval_count += 1
        return self.f.value_and_aux(x)

    def grad_from_aux(self, x, aux):
        if is_counting_enabled():
            self.grad_count += 1
        return self.f.grad_from_aux(x, aux)

    def value(self, x):
        # mirror (f::Counting)(args...) = f.f(args...) (counting.jl:34):
        # plain value calls are NOT metered as oracle evals
        return self.f.value(x) if hasattr(self.f, "value") else self.f(x)

    def value_and_grad(self, x):
        f_x, aux = self.value_and_aux(x)
        return f_x, self.grad_from_aux(x, aux)

    def __call__(self, x):
        return self.value(x)

    # -- prox protocol ------------------------------------------------------
    def prox(self, v, gamma):
        if is_counting_enabled():
            self.prox_count += 1
        return self.f.prox(v, gamma)

    # -- linear operator protocol ------------------------------------------
    def matvec(self, x):
        if is_counting_enabled():
            self.mul_count += 1
        return self.f.matvec(x)

    def rmatvec(self, y):
        if is_counting_enabled():
            self.amul_count += 1
        return self.f.rmatvec(y)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def T(self):
        """Adjoint view that meters amul_count (ref counting.jl:66,76-82)."""
        return AdjointCounting(self)

    def norm(self):
        return self.f.norm()

    @property
    def shape(self):
        return self.f.shape


class AdjointCounting:
    def __init__(self, op: Counting):
        self.op = op

    def __matmul__(self, y):
        return self.op.rmatvec(y)

    def matvec(self, y):
        return self.op.rmatvec(y)
