"""Quickstart: the AdaPGM/AdaPDM family on three problem shapes.

    python examples/quickstart.py [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

p = argparse.ArgumentParser()
p.add_argument("--cpu", action="store_true")
args = p.parse_args()
import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares, Quadratic
from adaprox_tpu.models.synthetic import random_lasso

# ---- 1. lasso via adaptive proximal gradient (no Lipschitz constant needed)
prob = random_lasso(m=500, n=1000, pfactor=10, seed=0)
f = LeastSquares(a=jnp.asarray(prob.a), b=jnp.asarray(prob.b))
g = ap.L1Norm(lam=prob.lam)
res = ap.auto_adaptive_proxgrad(jnp.zeros(1000), f=f, g=g, tol=1e-6, maxit=2000)
print(f"lasso: {int(res.numit)} iters, objective gap "
      f"{float(f.value(res.x) + g(res.x)) - prob.optimum:.2e}, "
      f"oracle calls: {int(res.counters.grad_f_evals)} grads")

# ---- 2. box-QP with an equality constraint via the primal-dual engine
rng = np.random.default_rng(0)
n = 40
labels = np.sign(rng.standard_normal(n))
feats = rng.standard_normal((n, 6))
q = (labels[:, None] * feats) @ (labels[:, None] * feats).T
fq = Quadratic(q_mat=jnp.asarray(q), q_vec=jnp.asarray(-np.ones(n)))
res = ap.adaptive_primal_dual(
    jnp.zeros(n), jnp.zeros(1),
    f=fq, g=ap.IndBox(lo=0.0, hi=0.5), h=ap.IndZero(),
    A=ap.DenseOperator(a=jnp.asarray(labels[None, :])),
    rule=ap.AdaPGMRule.make(t=1.0, norm_a=float(np.linalg.norm(labels))),
    tol=1e-5, maxit=20_000,
)
print(f"dual SVM: {int(res.numit)} iters, residual {float(res.norm_res):.1e}, "
      f"|y'x| = {abs(float(labels @ np.asarray(res.x))):.1e}")

# ---- 3. total-variation denoising: matrix-free h(Dx), fully adaptive
sig = np.repeat([0.0, 1.0, -0.5], 100)
noisy = jnp.asarray(sig + 0.1 * rng.standard_normal(300))
d = ap.DifferenceOperator(n=300)
res = ap.adaptive_linesearch_primal_dual(
    jnp.zeros(300), jnp.zeros(299),
    f=Quadratic(q_mat=jnp.eye(300), q_vec=-noisy), g=ap.Zero(),
    h=ap.L1Norm(lam=1.0), A=d, eta=2.0, tol=1e-5, maxit=20_000,
)
err_before = float(np.linalg.norm(np.asarray(noisy) - sig))
err_after = float(np.linalg.norm(np.asarray(res.x) - sig))
print(f"TV denoise: {int(res.numit)} iters, error {err_before:.2f} -> {err_after:.2f}")

# ---- 4. fully nonsmooth sqrt-lasso: a Condat-Vu solve and the AdaPDM+
# coupling sweep over t as ONE vmapped program
m2, n2 = 64, 256
a2 = jnp.asarray(rng.standard_normal((m2, n2)))
y2 = jnp.asarray(rng.standard_normal(m2))
parts = dict(f=ap.ZeroSmooth(), g=ap.L1Norm(lam=5.0),
             h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-y2),
             A=ap.DenseOperator(a=a2))
res = ap.condat_vu(jnp.zeros(n2), jnp.zeros(m2), Lf=0.0, tol=1e-6,
                   maxit=10_000, **parts)
print(f"sqrt-lasso (Condat-Vu): {int(res.numit)} iters, "
      f"residual {float(res.norm_res):.1e}")
ts = jnp.asarray([0.1, 1.0, 10.0])
sweep = jax.vmap(lambda t: ap.adaptive_linesearch_primal_dual(
    jnp.zeros(n2), jnp.zeros(m2), eta=float(jnp.linalg.norm(a2)), t=t,
    tol=1e-6, maxit=10_000, **parts).numit)(ts)
print(f"sqrt-lasso AdaPDM+ t-sweep (one program): iters {[int(v) for v in sweep]}")

# ---- 5. block-sparse data: only the nonzero tiles are stored and read
mask = rng.random((8, 4)) < 0.3  # 30% of (8x128)-tiles nonzero
dense = rng.standard_normal((64, 512)) * np.kron(mask, np.ones((8, 128)))
op = ap.BCSROperator.from_dense(dense, block=(8, 128))
res = ap.adaptive_primal_dual(
    jnp.zeros(512), jnp.zeros(64),
    f=ap.ZeroSmooth(), g=ap.L1Norm(lam=1.0),
    h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(rng.standard_normal(64))),
    A=op, rule=ap.AdaPGMRule.make(t=1.0, norm_a=float(op.norm())),
    tol=1e-4, maxit=20_000,  # f32 default: residual floors near 1e-5
)
print(f"block-sparse PD: {int(res.numit)} iters, residual "
      f"{float(res.norm_res):.1e}, block density {op.block_density:.2f}")

# ---- 6. backtracking PG from a step 10x too large: the linesearch shrinks
# it, and the trial loop runs inside the compiled solve
m3, n3 = 64, 256
a3 = jnp.asarray(rng.standard_normal((m3, n3)))
b3 = jnp.asarray(rng.standard_normal(m3))
lf3 = float(np.linalg.norm(np.asarray(a3), 2) ** 2)
res = ap.backtracking_proxgrad(
    jnp.zeros(n3), f=LeastSquares(a=a3, b=b3), g=ap.L1Norm(lam=1.0),
    gamma0=10.0 / lf3, xi=1.5, tol=1e-5, maxit=5000)
print(f"backtracking PG: {int(res.numit)} iters, residual "
      f"{float(res.norm_res):.1e}, {int(res.counters.f_evals)} f-evals")
