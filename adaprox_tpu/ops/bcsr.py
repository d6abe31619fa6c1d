"""Block-sparse (BCSR) linear operator.

Store only the nonzero (bm, bn) tiles of A and multiply exactly those: the
matvec touches nnzb * bm*bn*itemsize bytes instead of the dense m*n*itemsize
— a traffic saving proportional to block occupancy at the chosen
granularity, with every FLOP a dense tile operation.

Format (built host-side, ``bcsr_from_dense``):

  * ``vals``   (nnzb, bm, bn) — the nonzero tiles, block-row-major;
  * ``cols``   (nnzb,) int32  — block-column index of each tile;
  * ``rowptr`` (n_block_rows + 1,) int32 — CSR-style extents.

``A @ x`` is an XLA gather of the x blocks, one einsum over the stored
tiles and a segment-sum into the block rows. ``A'y`` uses a second BCSR
structure built from A' (same layout), so both directions are gather-only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from .linops import opnorm2
from .sparse import _pad_up

__all__ = ["BCSROperator", "bcsr_from_dense", "bcsr_matvec_xla", "bcsr_matvec_ref"]

_BM = 64
_BN = 512


def bcsr_from_dense(dense_np, bm=_BM, bn=_BN):
    """(vals, cols, rowptr, padded_shape) for the (bm, bn) blocking of a
    dense numpy matrix. A tile is stored iff it has any nonzero."""
    d = np.asarray(dense_np)
    m, n = d.shape
    mp, np_ = _pad_up(max(m, 1), bm), _pad_up(max(n, 1), bn)
    dp = np.zeros((mp, np_), d.dtype)
    dp[:m, :n] = d
    nbr, nbc = mp // bm, np_ // bn
    tiles = dp.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
    mask = (tiles != 0).any(axis=(2, 3))  # (nbr, nbc)
    vals, cols, rowptr = [], [], [0]
    for i in range(nbr):
        for c in np.nonzero(mask[i])[0]:
            vals.append(tiles[i, c])
            cols.append(c)
        rowptr.append(len(cols))
    if not vals:  # all-zero matrix: keep one zero tile so shapes are valid
        vals, cols, rowptr = [np.zeros((bm, bn), d.dtype)], [0], [0] + [1] * nbr
    return (np.stack(vals), np.asarray(cols, np.int32),
            np.asarray(rowptr, np.int32), (mp, np_))


def bcsr_matvec_xla(vals, cols, rows, x, nbr):
    """y = A @ x over the stored tiles (gather + einsum + segment-sum);
    ``rows``: (nnzb,) per-tile block-row ids; ``x``: (n_padded,)."""
    bn = vals.shape[2]
    xblk = jnp.take(x.reshape(-1, bn), cols, axis=0)         # (nnzb, bn)
    contrib = jnp.einsum("fij,fj->fi", vals.astype(x.dtype), xblk,
                         precision="highest")
    y = jax.ops.segment_sum(contrib, rows, num_segments=nbr)
    return y.reshape(-1)


def bcsr_matvec_ref(vals, cols, rowptr, x):
    """Pure-numpy reference (validation)."""
    nbr = rowptr.shape[0] - 1
    bm, bn = vals.shape[1], vals.shape[2]
    y = np.zeros(nbr * bm, np.asarray(x).dtype)
    xv = np.asarray(x)
    v = np.asarray(vals)
    c = np.asarray(cols)
    rp = np.asarray(rowptr)
    for i in range(nbr):
        for f in range(rp[i], rp[i + 1]):
            y[i * bm:(i + 1) * bm] += v[f] @ xv[c[f] * bn:(c[f] + 1) * bn]
    return jnp.asarray(y)


@pytree_dataclass(meta=("shape", "padded_shape"))
class BCSROperator:
    """Linear operator over (bm, bn) block-sparse storage, both directions
    (default 64x512 tiles; pass ``block=`` to change — finer tiles capture
    more sparsity at more index traffic). Construct with ``from_dense``.
    ``block_density`` (stored tiles / total tiles at the chosen
    granularity) is the traffic ratio vs dense.
    """

    vals: jnp.ndarray
    cols: jnp.ndarray
    rowptr: jnp.ndarray
    rows: jnp.ndarray  # (nnzb,) per-tile block-row id
    vals_t: jnp.ndarray
    cols_t: jnp.ndarray
    rowptr_t: jnp.ndarray
    rows_t: jnp.ndarray
    shape: tuple
    padded_shape: tuple

    @classmethod
    def from_dense(cls, dense, block=(_BM, _BN)):
        d = np.asarray(dense)
        bm, bn = block
        vals, cols, rowptr, pshape = bcsr_from_dense(d, bm, bn)
        vals_t, cols_t, rowptr_t, _ = bcsr_from_dense(d.T, bm, bn)
        rows = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr)).astype(np.int32)
        rows_t = np.repeat(np.arange(len(rowptr_t) - 1), np.diff(rowptr_t)).astype(np.int32)
        return cls(
            vals=jnp.asarray(vals), cols=jnp.asarray(cols),
            rowptr=jnp.asarray(rowptr), rows=jnp.asarray(rows),
            vals_t=jnp.asarray(vals_t), cols_t=jnp.asarray(cols_t),
            rowptr_t=jnp.asarray(rowptr_t), rows_t=jnp.asarray(rows_t),
            shape=d.shape, padded_shape=pshape,
        )

    @property
    def block_density(self):
        bm, bn = self.vals.shape[1], self.vals.shape[2]
        nbr = self.padded_shape[0] // bm
        nbc = self.padded_shape[1] // bn
        return self.vals.shape[0] / max(1, nbr * nbc)

    def _mv(self, vals, cols, rowptr, rows, v, in_dim, out_dim):
        vp = jnp.zeros(_pad_up(in_dim, vals.shape[2]), v.dtype).at[:in_dim].set(v)
        y = bcsr_matvec_xla(vals, cols, rows, vp, rowptr.shape[0] - 1)
        return y[:out_dim]

    def matvec(self, x):
        return self._mv(self.vals, self.cols, self.rowptr, self.rows,
                        x, self.shape[1], self.shape[0])

    def rmatvec(self, y):
        return self._mv(self.vals_t, self.cols_t, self.rowptr_t, self.rows_t,
                        y, self.shape[0], self.shape[1])

    def norm(self):
        return jnp.sqrt(jnp.sum(self.vals * self.vals))

    def opnorm(self, iters: int = 100, key=None):
        return opnorm2(self, iters=iters, key=key, n=self.shape[1],
                       dtype=self.vals.dtype)
