"""Linear operators (the `A` in min f(x) + g(x) + h(Ax)).

The reference accepts anything supporting ``A * x``, ``A' * y`` and
``norm(A)`` (src/AdaProx.jl:327,329,403). Here a LinearOperator is a pytree
dataclass with ``matvec``/``rmatvec``/``norm``; ``DenseOperator`` wraps a
(possibly sharded) ``jnp`` matrix so that under ``jit`` over a
``jax.sharding.Mesh`` the matvec partials and psum collectives are inserted
by XLA/GSPMD automatically — the replacement for Julia's BLAS calls.

``opnorm`` (largest singular value) is computed by power iteration on A'A,
replacing the reference's dense ``opnorm(A)`` precompute
(experiments/lasso/runme.jl:81) which does not scale to sharded matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass

__all__ = ["DenseOperator", "SparseOperator", "DifferenceOperator",
           "ScaledIdentity", "StackedOperator", "opnorm2", "frobenius_norm"]


@pytree_dataclass(meta=("precision",))
class DenseOperator:
    """A dense (possibly device-sharded) matrix as a linear operator.

    ``precision``: the products' algorithm ("highest" = full f32; None =
    backend default, which may be TF32 on a GPU). bf16 storage accumulates
    into the vector dtype.
    """

    a: jnp.ndarray
    precision: str | None = "highest"

    @property
    def shape(self):
        return self.a.shape

    def _acc(self, v):
        return acc_dtype(self.a, v)

    def matvec(self, x):
        return jax.lax.dot_general(
            self.a, x, (((1,), (0,)), ((), ())),
            precision=self.precision, preferred_element_type=self._acc(x),
        )

    def rmatvec(self, y):
        # A.T @ y as (y @ A) to keep the row-sharded layout contraction-local;
        # XLA emits the psum of partials when `a` is row-sharded.
        return jax.lax.dot_general(
            y, self.a, (((0,), (0,)), ((), ())),
            precision=self.precision, preferred_element_type=self._acc(y),
        )

    def norm(self):
        """Frobenius norm — matches Julia's ``norm(A)`` on a matrix, which the
        reference uses for ``norm_A`` (experiments/dual_svm/runme.jl:59,
        square_root_lasso/runme.jl:46)."""
        return frobenius_norm(self.a)

    def opnorm(self, iters: int = 100, key=None):
        return opnorm2(self, iters=iters, key=key)


@pytree_dataclass
class SparseOperator:
    """A BCOO sparse matrix as a linear operator.

    The reference stores LIBSVM data as SparseMatrixCSC (experiments/
    libsvm.jl:34); at the reference's densities the dense path is usually
    faster, so this exists for parity and for genuinely huge, very sparse
    problems. Construct via
    ``SparseOperator.from_dense`` or from a ``jax.experimental.sparse.BCOO``.

    For the padded-row ELL path (gather-only matvecs in both directions) see ``ops.sparse.ELLOperator``.
    """

    a: object  # jax.experimental.sparse.BCOO

    @classmethod
    def from_dense(cls, dense):
        from jax.experimental import sparse as jsparse

        return cls(a=jsparse.BCOO.fromdense(jnp.asarray(dense)))

    @property
    def shape(self):
        return self.a.shape

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, y):
        return self.a.T @ y

    def norm(self):
        return frobenius_norm(self.a.data)

    def opnorm(self, iters: int = 100, key=None):
        return opnorm2(self, iters=iters, key=key, n=self.shape[1])


@pytree_dataclass(meta=("n",))
class DifferenceOperator:
    """Matrix-free 1-D forward-difference operator D: (Dx)_i = x_{i+1} - x_i,
    mapping R^n -> R^{n-1}. With h = lam*||.||_1 this is total-variation
    denoising min 0.5||x-b||^2 + lam*||Dx||_1 — a structured h(Ax) showcase
    beyond the reference's dense matrices. ||D||_2 <= 2 (exactly
    2*sin(pi*(n-1)/(2n)))."""

    n: int

    @property
    def shape(self):
        return (self.n - 1, self.n)

    def matvec(self, x):
        return x[1:] - x[:-1]

    def rmatvec(self, y):
        # D' y = [-y_0, y_0 - y_1, ..., y_{m-2} - y_{m-1}... ] i.e. -div
        z = jnp.zeros((self.n,), y.dtype)
        z = z.at[:-1].add(-y)
        z = z.at[1:].add(y)
        return z

    def norm(self):
        import numpy as _np

        return jnp.asarray(2.0 * _np.sin(_np.pi * (self.n - 1) / (2.0 * self.n)))


@pytree_dataclass
class ScaledIdentity:
    """alpha * I; handy for tests and simple couplings."""

    alpha: jnp.ndarray = 1.0

    def matvec(self, x):
        return self.alpha * x

    def rmatvec(self, y):
        return self.alpha * y

    def norm(self):
        return jnp.abs(self.alpha)


@pytree_dataclass(meta=("sizes",))
class StackedOperator:
    """Vertical stack A = [A1; A2; ...]: one coupling for problems with
    several nonsmooth terms, h(Ax) = sum_i h_i(A_i x) — pair with
    ``prox.SeparableSum`` for the h side. matvec concatenates the block
    outputs; rmatvec sums the adjoint pieces. ``sizes`` holds the static
    output dim of each block (inferred from ``.shape`` by ``make``).
    """

    ops: tuple
    sizes: tuple

    @classmethod
    def make(cls, *ops, sizes=None):
        if sizes is None:
            sizes = tuple(int(op.shape[0]) for op in ops)
        if len(sizes) != len(ops):
            raise ValueError("sizes must match ops")
        return cls(ops=tuple(ops), sizes=tuple(int(s) for s in sizes))

    @property
    def shape(self):
        in_dims = [op.shape[1] for op in self.ops if hasattr(op, "shape")]
        if not in_dims:
            raise AttributeError("no block exposes a shape")
        return (sum(self.sizes), in_dims[0])

    def matvec(self, x):
        return jnp.concatenate([op.matvec(x) for op in self.ops])

    def rmatvec(self, y):
        out, off = None, 0
        for op, s in zip(self.ops, self.sizes):
            piece = op.rmatvec(y[off:off + s])
            out = piece if out is None else out + piece
            off += s
        return out

    def norm(self):
        """sqrt(sum_i norm_i^2): an upper bound on ||A||_2 whatever mix of
        Frobenius/spectral estimates the blocks return (upper bounds are the
        safe direction for the 1/(2*Theta*t*||A||) stepsize caps)."""
        sq = None
        for op in self.ops:
            n2 = op.norm() ** 2
            sq = n2 if sq is None else sq + n2
        return jnp.sqrt(sq)

    def opnorm(self, iters: int = 100, key=None):
        return opnorm2(self, iters=iters, key=key, n=self.shape[1])

    @property
    def dtype(self):
        """Iteration dtype for opnorm2: the promotion of the blocks' storage
        dtypes (bf16 widened to f32), f32 when every block is matrix-free."""
        dts = [op.a.dtype for op in self.ops if hasattr(op, "a")]
        dt = jnp.result_type(*dts) if dts else jnp.float32
        return jnp.float32 if dt == jnp.bfloat16 else dt


def acc_dtype(a, v):
    """The accumulation-dtype policy, single-sourced: accumulate in the
    iterate/vector dtype when storage is bf16 (f32 accumulation for bf16
    matrices), otherwise the promoted type. Shared by DenseOperator and
    models.objectives."""
    return v.dtype if a.dtype == jnp.bfloat16 else jnp.result_type(a, v)


def frobenius_norm(a):
    """sqrt(sum(a^2)) accumulated in >= f32 (bf16 storage upcasts: an
    8-mantissa-bit sum over millions of squares is meaningless)."""
    a = a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
    return jnp.sqrt(jnp.sum(a * a))


def opnorm2(op, iters: int = 100, key=None, n: int | None = None,
            dtype=None):
    """Largest singular value of a linear operator via power iteration on A'A.

    Sharding-friendly replacement for the reference's exact ``opnorm(A)``
    (experiments/lasso/runme.jl:81): each step is one matvec + one rmatvec,
    both of which ride whatever sharding the operator's storage has.

    The iteration dtype defaults to the storage dtype widened to at least
    f32 — a bf16 power iteration would hand the stepsize bounds a
    ~0.5-1% wrong sigma_max with zero safety margin.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if n is None:
        n = op.shape[1] if hasattr(op, "shape") else None
    if n is None:
        raise ValueError("pass n= for operators without a .shape")
    if dtype is None:
        if hasattr(op, "a"):
            dtype = op.a.dtype
        elif hasattr(op, "dtype"):
            dtype = op.dtype
        else:
            dtype = jnp.float32
        if dtype == jnp.bfloat16:
            dtype = jnp.float32
    v = jax.random.normal(key, (n,), dtype=dtype)
    v = v / jnp.sqrt(jnp.sum(v * v))

    def body(_, v):
        w = op.rmatvec(op.matvec(v))
        nrm = jnp.sqrt(jnp.sum(w * w))
        # zero (or numerically null) operator: keep v instead of 0/0 NaN;
        # the final norm then reports 0 correctly
        return jnp.where(nrm > 0, w / jnp.where(nrm > 0, nrm, 1.0), v)

    v = jax.lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.sum(op.matvec(v) ** 2))
