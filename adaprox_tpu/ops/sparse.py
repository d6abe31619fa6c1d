"""Sparse data-matrix path: padded-row (ELL) format with gather matvecs.

The reference stores LIBSVM data sparse (experiments/libsvm.jl:34,
SparseMatrixCSC, 70-97% sparse) and its matvecs go through Julia's generic
sparse BLAS. Here the sparse matvec is two XLA gathers:

  * ELL (padded-row) layout: ``vals``/``cols`` of shape (m, k) with k =
    max-nnz-per-row rounded up to a multiple of 128 — every row the same
    length, fully static shapes;
  * ``A @ x``  = sum(vals * x[cols], axis=1)    — row-parallel gather;
  * ``A' @ y`` uses a second ELL structure built from A' (same layout), so
    BOTH matvecs are gathers — no scatter anywhere (scatter-add is the slow
    path on every backend);
  * per-iteration traffic ~ m*k*(4+4) bytes vs dense m*n*4: the sparse
    path can only win when the padded density k/n < 1/2. LIBSVM-shaped
    data (n <= 123, k ~ n/4 but padded to 128) does not clear that bar;
    this operator is for genuinely large sparse problems.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from .linops import opnorm2

__all__ = ["ELLOperator", "ell_from_dense_arrays", "ell_matvec_xla"]

_LANE = 128
_SUBLANE = 8


def _pad_up(v, mult):
    return ((v + mult - 1) // mult) * mult


def _ell_arrays(dense_np, pad_rows_to=_SUBLANE, pad_k_to=_LANE):
    """(vals, cols) padded-row arrays from a dense numpy matrix. Padding
    entries have val 0.0 / col 0 (contribute nothing to the row sum)."""
    m, n = dense_np.shape
    nnz_per_row = (dense_np != 0).sum(axis=1)
    k = int(nnz_per_row.max()) if m else 0
    k = max(_pad_up(max(k, 1), pad_k_to), pad_k_to)
    mp = _pad_up(max(m, 1), pad_rows_to)
    vals = np.zeros((mp, k), dense_np.dtype)
    cols = np.zeros((mp, k), np.int32)
    for i in range(m):
        idx = np.nonzero(dense_np[i])[0]
        vals[i, : idx.size] = dense_np[i, idx]
        cols[i, : idx.size] = idx
    return vals, cols, mp, k


def ell_from_dense_arrays(dense):
    """Build both ELL structures (A and A') from a dense matrix."""
    d = np.asarray(dense)
    vals, cols, mp, k = _ell_arrays(d)
    vals_t, rows_t, np_, kt = _ell_arrays(d.T)
    return vals, cols, vals_t, rows_t


def ell_matvec_xla(vals, cols, x, out_rows):
    """sum(vals * x[cols], axis=1) — works on every backend."""
    acc = x.dtype
    gathered = jnp.take(x, cols, axis=0)
    return jnp.sum(vals.astype(acc) * gathered, axis=1)[:out_rows]


@pytree_dataclass(meta=("shape",))
class ELLOperator:
    """Linear operator over the padded-row sparse format (both layouts).

    Matvecs run through the XLA gather. Construct via ``from_dense`` (or
    from scipy via ``.toarray()``).
    """

    vals: jnp.ndarray  # (m_pad, k)
    cols: jnp.ndarray  # (m_pad, k) int32
    vals_t: jnp.ndarray  # (n_pad, kt)
    rows_t: jnp.ndarray  # (n_pad, kt) int32
    shape: tuple

    @classmethod
    def from_dense(cls, dense):
        d = np.asarray(dense)
        vals, cols, vals_t, rows_t = ell_from_dense_arrays(d)
        return cls(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                   vals_t=jnp.asarray(vals_t), rows_t=jnp.asarray(rows_t),
                   shape=d.shape)

    @property
    def density(self):
        """Padded density k/n — the sparse path beats dense when < 1/2."""
        return self.vals.shape[1] / self.shape[1]

    def matvec(self, x):
        return ell_matvec_xla(self.vals, self.cols, x, self.shape[0])

    def rmatvec(self, y):
        return ell_matvec_xla(self.vals_t, self.rows_t, y, self.shape[1])

    def norm(self):
        """Frobenius norm (Julia ``norm(A)`` parity; padding vals are 0)."""
        return jnp.sqrt(jnp.sum(self.vals * self.vals))

    def opnorm(self, iters: int = 100, key=None):
        # pass the data dtype: opnorm2's default sniffs .a, which this
        # operator lacks, and would silently run the power iteration in f32
        return opnorm2(self, iters=iters, key=key, n=self.shape[1],
                       dtype=self.vals.dtype)
