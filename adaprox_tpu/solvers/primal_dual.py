"""The generic adaptive primal-dual engine (AdaPDM) and its proximal-gradient
specializations.

Re-design of ``adaptive_primal_dual`` (reference src/AdaProx.jl:312-364), the
single loop every fixed/adaptive PG and PD method in the reference reduces to
(``adaptive_proxgrad`` is literally this loop with h = Zero, A = 0 at
src/AdaProx.jl:418-421).

Iteration (x: primal, y: dual, v: pre-prox point):

    A_x    = A x
    f_x, grad_x = f(x) with pullback
    p_res  = (v - x)/gamma + grad_x + A' y
    (gamma, sigma) <- rule(state, curvature(x, grad_x, x_prev, grad_prev))
    rho    = gamma / gamma_prev
    w      = y + sigma ((1+rho) A_x - rho A_x_prev)
    y      = prox_{sigma h*}(w)
    d_res  = (w - y)/sigma - A_x
    stop when ||(p_res, d_res)|| <= tol
    A'y; v = x - gamma (grad_x + A'y); x = prox_{gamma g}(v)

Execution on the device:
  * two execution modes — ``lax.while_loop`` (early exit, production solve)
    and ``lax.scan`` (fixed trip count with a ``done`` mask, full
    per-iteration history for telemetry/benchmarks);
  * the A = None case statically eliminates all dual work at trace time
    (the reference's h=Zero/A=0 PG case, where dual_res == 0 identically);
  * the curvature scalars consumed by the rule are three reductions — on a
    sharded problem these plus the residual norms are the only cross-device
    traffic per iteration (psum over the interconnect), so iterations scale with the
    matvec;
  * oracle counters ride the carry (see solvers.common).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import prox as prox_ops
from ..solvers import rules as rules_mod
from .common import Counters, Records, SolveResult, cast_floats, l2sq, reopen, run_loop

__all__ = [
    "adaptive_primal_dual",
    "adaptive_proxgrad",
    "fixed_proxgrad",
    "condat_vu",
]


class _Carry(NamedTuple):
    it: jnp.ndarray
    x: jnp.ndarray
    v: jnp.ndarray
    y: object  # dual iterate or None
    at_y: object  # A'y or None
    x_prev: jnp.ndarray
    a_x_prev: object  # A x_prev or None
    grad_prev: jnp.ndarray
    gamma: jnp.ndarray
    sigma: jnp.ndarray
    rstate: object
    counters: Counters
    norm_res: jnp.ndarray
    ck_x: jnp.ndarray  # x at the convergence check (reference returns this)
    ck_counters: Counters  # counters at the check (log-time snapshot)
    rule_nan: jnp.ndarray  # latched: the rule produced a NaN step size
    done: jnp.ndarray


def _init(f, g, a_op, rule, x0, y0, sdt):
    """Warm-up phase, reference src/AdaProx.jl:324-332. ``sdt`` is the
    scalar dtype for steps/rule state/residual norms (the f64-scalar hybrid
    when wider than the iterate dtype)."""
    (gamma, sigma), rstate = rule.init()
    counters = Counters.zeros()
    dual = a_op is not None
    vdt = jnp.result_type(x0)
    gamma_v = gamma.astype(vdt)  # step for vector arithmetic

    a_x = None
    at_y = None
    if dual:
        a_x = a_op.matvec(x0)
        counters = counters.bump(A_evals=1)
    f_x, aux = f.value_and_aux(x0)
    grad = f.grad_from_aux(x0, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)
    if dual:
        at_y = a_op.rmatvec(y0)
        counters = counters.bump(At_evals=1)
        v = x0 - gamma_v * (grad + at_y)
    else:
        v = x0 - gamma_v * grad
    x1, _ = g.prox(v, gamma_v)
    counters = counters.bump(prox_g_evals=1)

    inf = jnp.asarray(jnp.inf, dtype=sdt)
    return _Carry(
        it=jnp.zeros((), jnp.int32),
        x=x1,
        v=v,
        y=y0 if dual else None,
        at_y=at_y,
        x_prev=x0,
        a_x_prev=a_x,
        grad_prev=grad,
        gamma=gamma,
        sigma=sigma,
        rstate=rstate,
        counters=counters,
        norm_res=inf,
        ck_x=x1,
        ck_counters=counters,
        # a NaN initial step (e.g. a direct rule ctor bypassing .make's
        # validation) is latched here so it surfaces as diag["rule_nan"]
        # instead of a silent garbage trajectory that runs to maxit
        rule_nan=jnp.isnan(gamma),
        done=jnp.zeros((), jnp.bool_),
    )


def _step(c: _Carry, *, f, g, h, h_conj, a_op, rule, tol, with_objective, sdt):
    """One full iteration (reference src/AdaProx.jl:334-362). Returns the new
    carry and the record row for this iteration. Scalar arithmetic (rule
    update, residual norms, step sizes) runs in ``sdt``; vector arithmetic
    stays in the iterate dtype."""
    dual = a_op is not None
    counters = c.counters
    vdt = jnp.result_type(c.x)
    upcast = sdt != vdt

    # -- first half: evaluate, adapt steps, dual update, residuals ----------
    a_x = None
    if dual:
        a_x = a_op.matvec(c.x)
        counters = counters.bump(A_evals=1)
    f_x, aux = f.value_and_aux(c.x)
    grad_x = f.grad_from_aux(c.x, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)

    if upcast:
        # exact f32 differences in f64, then the 1/gamma amplification
        # happens on f64 values (the residual's cancellation-sensitive path)
        primal_res = (c.v.astype(sdt) - c.x.astype(sdt)) / c.gamma + grad_x.astype(sdt)
    else:
        primal_res = (c.v - c.x) / c.gamma + grad_x
    if dual:
        primal_res = primal_res + (c.at_y.astype(sdt) if upcast else c.at_y)

    curv = rules_mod.Curvature.of(
        c.x, grad_x, c.x_prev, c.grad_prev, dtype=sdt if upcast else None)
    (gamma, sigma), rstate = rule.update(c.rstate, curv)
    # failure detection: a NaN step size (invalid parameters through a
    # direct rule ctor, or a poisoned curvature) makes every later test
    # (norm_res <= tol) false, so the solve would run to maxit silently —
    # latch it for diag["rule_nan"] (the reference fails loudly with a
    # DomainError at the analogous point, src/AdaProx.jl:267)
    rule_nan = jnp.logical_or(
        c.rule_nan, jnp.logical_or(jnp.isnan(gamma), jnp.isnan(sigma)))
    rho = gamma / c.gamma
    gamma_nv = gamma.astype(vdt)
    sigma_v = sigma.astype(vdt)

    if dual:
        w = c.y + sigma_v * ((1 + rho).astype(vdt) * a_x - rho.astype(vdt) * c.a_x_prev)
        y, _ = h_conj.prox(w, sigma_v)
        counters = counters.bump(prox_h_evals=1)
        if upcast:
            dual_res = (w.astype(sdt) - y.astype(sdt)) / sigma - a_x.astype(sdt)
        else:
            dual_res = (w - y) / sigma - a_x
        norm_res = jnp.sqrt(l2sq(primal_res) + l2sq(dual_res))
    else:
        y = None
        norm_res = jnp.sqrt(l2sq(primal_res))

    ck_counters = counters
    it = c.it + 1

    # per-iteration record (objective recomputed for logging only, matching
    # the reference's `without_counting` block at src/AdaProx.jl:350-352)
    if with_objective:
        objective = f_x + g(c.x)
        if dual:
            objective = objective + h(a_x)
    else:
        objective = jnp.zeros_like(f_x)
    record = Records(
        it=it,
        gamma=gamma,
        sigma=sigma,
        norm_res=norm_res,
        objective=objective,
        f_evals=ck_counters.f_evals,
        grad_f_evals=ck_counters.grad_f_evals,
        prox_g_evals=ck_counters.prox_g_evals,
        prox_h_evals=ck_counters.prox_h_evals,
        A_evals=ck_counters.A_evals,
        At_evals=ck_counters.At_evals,
        valid=jnp.logical_not(c.done),
    )

    # -- second half: next primal point (skipped by the reference on the
    # converging iteration; we run it and report the at-check snapshot) -----
    if dual:
        at_y = a_op.rmatvec(y)
        counters = counters.bump(At_evals=1)
        v = c.x - gamma_nv * (grad_x + at_y)
    else:
        at_y = None
        v = c.x - gamma_nv * grad_x
    x_new, _ = g.prox(v, gamma_nv)
    counters = counters.bump(prox_g_evals=1)

    new = _Carry(
        it=it,
        x=x_new,
        v=v,
        y=y,
        at_y=at_y,
        x_prev=c.x,
        a_x_prev=a_x,
        grad_prev=grad_x,
        gamma=gamma,
        sigma=sigma,
        rstate=rstate,
        counters=counters,
        norm_res=norm_res,
        ck_x=c.x,
        ck_counters=ck_counters,
        rule_nan=rule_nan,
        done=jnp.logical_or(c.done, norm_res <= tol),
    )
    return new, record


@functools.partial(jax.jit, static_argnames=("maxit", "history", "scalar_dtype"))
def _solve_pd(parts, rule, x0, y0, tol, maxit, history, resume_state=None,
              scalar_dtype=None, it_cap=None):
    f, g, h, a_op = parts
    dt = jnp.result_type(x0)
    sdt = jnp.dtype(scalar_dtype) if scalar_dtype is not None else dt
    rule = cast_floats(rule, sdt)
    tol = jnp.asarray(tol, sdt)
    h_conj = prox_ops.conjugate(h) if h is not None else None
    if resume_state is not None:
        carry0 = reopen(resume_state, dt, scalar_dtype=sdt,
                        scalar_fields=("gamma", "sigma", "rstate",
                                       "norm_res"))
    else:
        carry0 = _init(f, g, a_op, rule, x0, y0, sdt)
    step = functools.partial(
        _step,
        f=f,
        g=g,
        h=h,
        h_conj=h_conj,
        a_op=a_op,
        rule=rule,
        tol=tol,
        with_objective=history,
        sdt=sdt,
    )

    final, recs = run_loop(carry0, step, maxit, history, it_cap=it_cap)

    converged = final.norm_res <= tol
    x_out = jnp.where(converged, final.ck_x, final.x)
    counters = jax.tree_util.tree_map(
        lambda a, b: jnp.where(converged, a, b), final.ck_counters, final.counters
    )
    return SolveResult(
        x=x_out,
        y=final.y,
        numit=final.it,
        norm_res=final.norm_res,
        counters=counters,
        records=recs,
        extra=final,  # full loop carry: checkpoint with utils.checkpoint
        # failure detection (the reference raises a DomainError from the
        # rule update, src/AdaProx.jl:267; under jit the poisoning is data,
        # so it is latched and surfaced here)
        diag={"gamma": final.gamma, "rule_nan": final.rule_nan},
    )


def adaptive_primal_dual(
    x0,
    y0=None,
    *,
    f,
    g,
    h=None,
    A=None,
    rule,
    tol=1e-5,
    maxit=10_000,
    name="AdaPDM",
    history=False,
    resume_state=None,
    scalar_dtype=None,
    it_cap=None,
):
    """Adaptive primal-dual (AdaPDM) for min_x f(x) + g(x) + h(Ax).

    Reference: ``adaptive_primal_dual`` at src/AdaProx.jl:312-364. With
    ``A=None`` this is exactly the proximal-gradient family (dual residual is
    identically zero), with all dual computation removed at trace time.

    ``resume_state``: a previous result's ``.extra`` carry (possibly loaded
    via utils.checkpoint) — continues that solve; ``maxit`` is the cumulative
    iteration cap.

    ``scalar_dtype``: run the stepsize rule, curvature reductions, and
    residual norms in this (wider) dtype while matvecs/iterates stay in the
    x0 dtype — the f64-over-f32 hybrid (needs jax_enable_x64). The
    f32->f64 upcasts happen BEFORE the cross-iterate subtractions, so the
    rule sees exact differences; the remaining precision floor is the f32
    matvec itself.

    ``it_cap``: traced cumulative iteration bound (history=False only) —
    the live-telemetry chunking hook; see utils.live.live_solve. A capped
    solve continued via ``resume_state`` is bit-identical to an
    uninterrupted one.
    """
    if A is not None and y0 is None:
        raise ValueError("y0 is required when A is given")
    if A is None:
        # the dual term is h(Ax): silently dropping a user-supplied h/y0
        # would solve a different problem with no diagnostic
        if h is not None and not isinstance(h, prox_ops.Zero):
            raise ValueError(
                "h was given without A; pass A (use ScaledIdentity for "
                "h(x)) or drop h")
        if y0 is not None:
            raise ValueError("y0 was given without A")
        h = None
    elif h is None:
        h = prox_ops.Zero()  # h omitted with a real A: h(Ax) = 0
    x0 = jnp.asarray(x0)
    # tol is cast ONCE in _solve_pd (to the scalar dtype): a pre-cast to the
    # iterate dtype would f32-quantize the stopping threshold in hybrid mode
    res = _solve_pd(
        (f, g, h, A), rule, x0, y0, tol, int(maxit), bool(history),
        resume_state=resume_state, scalar_dtype=scalar_dtype,
        it_cap=None if it_cap is None else jnp.asarray(it_cap, jnp.int32),
    )
    return res.with_name(name)


def adaptive_proxgrad(x0, *, f, g, rule, tol=1e-5, maxit=100_000, name="AdaPGM",
                      history=False, resume_state=None, scalar_dtype=None,
                      it_cap=None):
    """Adaptive proximal gradient: the PD engine with h=Zero, A=0
    (reference src/AdaProx.jl:418-421)."""
    return adaptive_primal_dual(
        x0, f=f, g=g, rule=rule, tol=tol, maxit=maxit, name=name,
        history=history, resume_state=resume_state, scalar_dtype=scalar_dtype,
        it_cap=it_cap,
    )


def fixed_proxgrad(x0, *, f, g, gamma, tol=1e-5, maxit=100_000, name="Fixed stepsize PGM", history=False, resume_state=None, scalar_dtype=None, it_cap=None):
    """Fixed-stepsize PGM (reference src/AdaProx.jl:457-459)."""
    rule = rules_mod.FixedStepsize(gamma=gamma, t=1.0)
    return adaptive_proxgrad(
        x0, f=f, g=g, rule=rule, tol=tol, maxit=maxit, name=name, history=history,
        resume_state=resume_state, scalar_dtype=scalar_dtype, it_cap=it_cap,
    )


def condat_vu_steps(lf, norm_a):
    """(gamma, sigma) from the reference's scaling heuristics
    (src/AdaProx.jl:396-412, par=5, par2=100) — shared by ``condat_vu``
    and ``pd_fused.fused_condat_vu``. jnp.where keeps lf == 0 (the f = 0
    experiments) finite: alpha = 1 whenever norm_a > par*lf."""
    par, par2 = 5.0, 100.0
    alpha = jnp.where(norm_a > par * lf, 1.0, par2 * norm_a / lf)
    gamma = 1.0 / (lf / 2 + norm_a / alpha)
    sigma = 0.99 / (norm_a * alpha)
    return gamma, sigma


def condat_vu(
    x0,
    y0,
    *,
    f,
    g,
    h,
    A,
    Lf,
    gamma=None,
    sigma=None,
    norm_A=None,
    tol=1e-5,
    maxit=10_000,
    name="Condat-Vu",
    history=False,
    resume_state=None,
    scalar_dtype=None,
    it_cap=None,
):
    """Condat-Vu fixed-step primal-dual: derives (gamma, sigma) from Lf and
    ||A|| with the reference's scaling heuristics (src/AdaProx.jl:367-416,
    par=5, par2=100), then runs the generic engine with a FixedStepsize rule.
    """
    if gamma is None and sigma is None:
        if norm_A is None:
            norm_A = A.norm()
        norm_A = jnp.asarray(norm_A, dtype=jnp.result_type(jnp.asarray(x0)))
        gamma, sigma = condat_vu_steps(
            jnp.asarray(Lf, dtype=norm_A.dtype), norm_A)
    if gamma is None or sigma is None:
        raise ValueError("provide both gamma and sigma, or neither")
    rule = rules_mod.FixedStepsize(gamma=gamma, t=jnp.sqrt(sigma / gamma))
    return adaptive_primal_dual(
        x0, y0, f=f, g=g, h=h, A=A, rule=rule, tol=tol, maxit=maxit, name=name,
        history=history, resume_state=resume_state, scalar_dtype=scalar_dtype,
        it_cap=it_cap,
    )
