"""Smooth objectives used by the benchmark problems.

JAX re-implementations of the hand-written pullback structs in the
reference experiments:

  * LeastSquares      — experiments/lasso/runme.jl:16-27
  * LogisticLoss      — experiments/sparse_logreg/runme.jl:18-39
  * Quadratic         — experiments/dual_svm/runme.jl:19-28
  * Cubic             — experiments/cubic_sparse_logreg/runme.jl:20-32
  * WorstQuadratic    — experiments/nesterov_worst_case/runme.jl:14-40

Each stores its data as (possibly mesh-sharded) jnp arrays; the matvecs
inside value/grad are the hot ops. Every f32 product passes an explicit
``precision`` ("highest" by default): with the backend default a GPU may
run it in TF32, whose three digits spoil the curvature estimates. ``aux``
carries the forward residual so the gradient finishes with a single
transposed matvec, mirroring the reference's lazy pullbacks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass
from ..ops.oracles import SmoothOracle

__all__ = ["LeastSquares", "GramLeastSquares", "LogisticLoss", "Quadratic",
           "FactoredQuadratic", "Cubic", "WorstQuadratic"]


from ..ops.linops import acc_dtype as _acc_dtype  # single-sourced policy


def _mv(a, v, precision):
    """a @ v with explicit precision and f32 accumulation for bf16 data.
    ``a`` may also be any LinearOperator (e.g. ops.sparse.ELLOperator) —
    the sparse data path plugs into every oracle through here."""
    if hasattr(a, "matvec"):
        return a.matvec(v)
    return jax.lax.dot_general(
        a, v, (((1,), (0,)), ((), ())),
        precision=precision, preferred_element_type=_acc_dtype(a, v),
    )


def _vm(v, a, precision):
    """v @ a (the transposed matvec, contraction-local for row-sharded a)."""
    if hasattr(a, "rmatvec"):
        return a.rmatvec(v)
    return jax.lax.dot_general(
        v, a, (((0,), (0,)), ((), ())),
        precision=precision, preferred_element_type=_acc_dtype(a, v),
    )


@pytree_dataclass(meta=("precision", "fused", "interpret"))
class LeastSquares(SmoothOracle):
    """f(w) = 0.5 * ||A w - b||^2. aux = residual; grad = A' res.

    ``precision`` is the products' algorithm ("highest" = full f32 — the
    correctness default for the curvature-sensitive adaptive rules; None =
    the backend default, which may be TF32 on a GPU). ``a`` may be stored
    bf16 to halve the bytes read; results accumulate in the iterate dtype.

    ``fused=True`` computes value and gradient with the one-pass GPU kernel
    (ops.kernels.fused_ls_value_grad), which reads ``a`` once per call
    instead of twice. It takes any unsharded dense f32/bf16 ``a``; other
    operators keep the two-product path. ``interpret=True`` runs the kernel
    in the Pallas interpreter (the CPU tests); without it the kernel needs
    a GPU (platform.kernel_interpret).
    """

    a: jnp.ndarray
    b: jnp.ndarray
    precision: str | None = "highest"
    fused: bool = False
    interpret: bool = False

    def _use_fused(self):
        from ..ops import kernels

        return self.fused and kernels.ls_supported(self.a)

    def value_and_aux(self, w):
        if self._use_fused():
            from ..ops import kernels
            from ..platform import kernel_interpret

            return kernels.fused_ls_value_grad(
                self.a, self.b, w, interpret=kernel_interpret(self.interpret))
        res = _mv(self.a, w, self.precision) - self.b
        return 0.5 * jnp.sum(res * res), res

    def grad_from_aux(self, w, aux):
        del w
        if self._use_fused():
            return aux  # the fused kernel already produced the gradient
        # (res @ a) keeps a row-sharded `a` contraction-local (psum of partials)
        return _vm(aux, self.a, self.precision)

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5||A dx||^2. Non-fused aux is the residual: ||res - res_prev||^2
        # is a sum of squares — noise enters at second order, never the
        # eps*|f| catastrophe of the difference form. Fused aux is the
        # gradient: 0.5 dx'A'A dx = 0.5 <dx, dgrad>, clamped at the exact
        # lower bound 0 (the dot's noise can round a tiny term negative).
        if self._use_fused():
            return jnp.maximum(0.5 * jnp.vdot(dx, aux - aux_prev).real, 0.0)
        dres = aux - aux_prev
        return 0.5 * jnp.sum(dres * dres)


@pytree_dataclass(meta=("precision",))
class GramLeastSquares(SmoothOracle):
    """0.5||Ax-b||^2 in normal-equations form: value/grad from the Gram
    matrix G = A'A and c = A'b,

        f(x) = 0.5 x'Gx - c'x + 0.5 b'b,   grad = Gx - c.

    Identical math to LeastSquares, but each iteration reads G (n x n)
    instead of A (m x n) twice: for tall problems (m >> n) this cuts the
    bytes read by 2m/n (8x at the reference's 4000x1000 lasso), and a small
    G can stay in the GPU's L2. The one-off G = A'A build costs one m*n^2
    matmul (compute-bound, amortized over the solve).

    Precision note: rounding in Gx is governed by kappa(G) = kappa(A)^2; for
    very ill-conditioned problems at f32, prefer LeastSquares.
    """

    g_mat: jnp.ndarray
    c_vec: jnp.ndarray
    btb: jnp.ndarray
    precision: str | None = "highest"

    @classmethod
    def from_data(cls, a, b, precision="highest"):
        g_mat = jax.lax.dot_general(
            a, a, (((0,), (0,)), ((), ())), precision=precision,
            preferred_element_type=_acc_dtype(a, b),
        )
        c_vec = _vm(b, a, precision)
        return cls(g_mat=g_mat, c_vec=c_vec, btb=jnp.vdot(b, b).real)

    def value_and_aux(self, x):
        gx = _mv(self.g_mat, x, self.precision)
        val = 0.5 * jnp.vdot(x, gx).real - jnp.vdot(self.c_vec, x).real + 0.5 * self.btb
        return val, gx

    def grad_from_aux(self, x, gx):
        del x
        return gx - self.c_vec

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5 dx'G dx = 0.5 <dx, gx - gx_prev>, clamped at the exact lower
        # bound 0 (G is PSD); see SmoothOracle.bregman_from_aux
        return jnp.maximum(0.5 * jnp.vdot(dx, aux - aux_prev).real, 0.0)


@pytree_dataclass(meta=("precision",))
class LogisticLoss(SmoothOracle):
    """Mean logistic loss with the bias folded into the last coordinate of w
    (reference experiments/sparse_logreg/runme.jl:23-39):

        logits = X @ w[:-1] + w[-1]
        f(w) = -mean((y - 1) * logits - log(1 + exp(-logits)))

    aux = sigmoid(logits); grad = [X'(probs - y)/N, mean(probs - y)].
    """

    x: jnp.ndarray
    y: jnp.ndarray
    precision: str | None = "highest"

    def value_and_aux(self, w):
        logits = _mv(self.x, w[:-1], self.precision) + w[-1]
        # log(1 + exp(-z)) = softplus(-z), computed stably
        softplus_neg = jnp.logaddexp(0.0, -logits)
        val = -jnp.mean((self.y - 1.0) * logits - softplus_neg)
        probs = 1.0 / (1.0 + jnp.exp(-logits))
        return val, probs

    def grad_from_aux(self, w, aux):
        n = self.y.shape[0]
        diff = aux - self.y
        gw = _vm(diff, self.x, self.precision) / n
        gb = jnp.mean(diff)
        return jnp.concatenate([gw, gb[None]]).astype(w.dtype)


@pytree_dataclass(meta=("precision",))
class Quadratic(SmoothOracle):
    """f(x) = 0.5 x'Qx + q'x. aux = Qx; grad = Qx + q."""

    q_mat: jnp.ndarray
    q_vec: jnp.ndarray
    precision: str | None = "highest"

    def value_and_aux(self, x):
        qx = _mv(self.q_mat, x, self.precision)
        return 0.5 * jnp.vdot(x, qx) + jnp.vdot(x, self.q_vec), qx

    def grad_from_aux(self, x, qx):
        del x
        return qx + self.q_vec

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5 dx'Q dx = 0.5 <dx, qx - qx_prev>, clamped at 0 (Q PSD in every
        # use here); see SmoothOracle.bregman_from_aux
        return jnp.maximum(0.5 * jnp.vdot(dx, aux - aux_prev).real, 0.0)


@pytree_dataclass(meta=("precision",))
class FactoredQuadratic(SmoothOracle):
    """f(x) = 0.5 x'(B B')x + q'x WITHOUT materializing the Gram: aux is
    computed as B (B' x) — two skinny matvecs (2*m*d elements of traffic
    instead of m^2).

    This is the safe-at-scale form of the dual-SVM objective
    (B = D_y X, reference dual_svm/runme.jl:47-50 builds the m x m Gram):
    at mushrooms size in f64 the 8124^2 Gram is 528 MB, while the factored
    form keeps the largest array at m x d (7 MB) and is also faster
    whenever d < m/2. ``norm_q()`` gives the Frobenius norm of the implied
    Q gram-free (||B B'||_F = ||B' B||_F, a d x d pass) — the reference's
    Lf seed (runme.jl:56)."""

    b_mat: jnp.ndarray
    q_vec: jnp.ndarray
    precision: str | None = "highest"

    def value_and_aux(self, x):
        btx = _vm(x, self.b_mat, self.precision)     # (d,)
        qx = _mv(self.b_mat, btx, self.precision)    # (m,)
        return 0.5 * jnp.vdot(x, qx) + jnp.vdot(x, self.q_vec), qx

    def grad_from_aux(self, x, qx):
        del x
        return qx + self.q_vec

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5 dx'BB'dx = 0.5 <dx, qx - qx_prev>, clamped at 0 (BB' PSD);
        # see SmoothOracle.bregman_from_aux
        return jnp.maximum(0.5 * jnp.vdot(dx, aux - aux_prev).real, 0.0)

    def norm_q(self):
        from ..ops.linops import frobenius_norm

        # accumulate the (d, d) Gram in the policy dtype (f32 for bf16
        # storage — a bf16 sum over m~8k terms is percent-level wrong and
        # this seeds every solver's Lf)
        acc = _acc_dtype(self.b_mat, self.b_mat)
        if acc == jnp.bfloat16:
            acc = jnp.float32
        bt_b = jax.lax.dot_general(
            self.b_mat, self.b_mat, (((0,), (0,)), ((), ())),
            precision=self.precision,
            preferred_element_type=acc)
        return frobenius_norm(bt_b)


@pytree_dataclass(meta=("precision",))
class Cubic(SmoothOracle):
    """Cubic-regularized quadratic model (cubic_sparse_logreg/runme.jl:26-32):

        grad = Qx + q + (c*||x||/2) x
        f(x) = (<x, grad> + <q, x>)/2 - c*||x||^3/12

    aux = grad (the reference's pullback returns the precomputed grad).
    """

    q_mat: jnp.ndarray
    q_vec: jnp.ndarray
    c: jnp.ndarray
    precision: str | None = "highest"

    def value_and_aux(self, x):
        nx = jnp.sqrt(jnp.sum(x * x))
        grad = _mv(self.q_mat, x, self.precision) + self.q_vec + (nx * self.c / 2) * x
        val = (jnp.vdot(x, grad) + jnp.vdot(self.q_vec, x)) / 2 - nx**3 * self.c / 12
        return val, grad

    def grad_from_aux(self, x, grad):
        del x
        return grad


@pytree_dataclass(meta=("k",))
class WorstQuadratic(SmoothOracle):
    """Nesterov's worst-case tridiagonal quadratic on the first k coordinates
    (nesterov_worst_case/runme.jl:14-40):

        f(x) = (L/4) * ( (x_1^2 + x_k^2 + sum_{i<k}(x_i - x_{i+1})^2)/2 - x_1 )

    Vectorized gradient: (L/4) * (T x - e_1) with T the tridiag(−1, 2, −1)
    stencil on x[:k], zero beyond.
    """

    k: int
    lip: jnp.ndarray

    def value_and_aux(self, x):
        xk = x[: self.k]
        s = xk[0] ** 2 + xk[-1] ** 2 + jnp.sum(jnp.diff(xk) ** 2)
        val = (self.lip / 4) * (s / 2 - xk[0])
        return val, None

    def grad_from_aux(self, x, aux):
        del aux
        xk = x[: self.k]
        left = jnp.concatenate([jnp.zeros((1,), xk.dtype), xk[:-1]])
        right = jnp.concatenate([xk[1:], jnp.zeros((1,), xk.dtype)])
        tx = 2 * xk - left - right
        e1 = jnp.zeros_like(xk).at[0].set(1.0)
        gk = (self.lip / 4) * (tx - e1)
        return jnp.concatenate([gk, jnp.zeros((x.shape[0] - self.k,), x.dtype)])
