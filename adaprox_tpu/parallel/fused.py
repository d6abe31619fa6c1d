"""Sharded fused oracle: the one-pass GPU kernel under shard_map.

``pallas_call`` has no SPMD partitioning rule, so using the fused oracle on
a mesh-sharded matrix must go through ``shard_map``: every device runs the
fused kernel on its local row block and the (f, grad) partials are psum-ed
over the rows axis — the same two collectives GSPMD inserts for the XLA
two-pass, but with the single-pass kernel doing the local work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .._pytree import pytree_dataclass
from ..ops.oracles import SmoothOracle
from .mesh import ROWS

__all__ = ["RowShardedFusedLS", "row_sharded_fused_ls"]


@pytree_dataclass(meta=("mesh", "interpret"))
class RowShardedFusedLS(SmoothOracle):
    """0.5||Ax-b||^2 with row-sharded A/b and the fused one-pass kernel
    running per shard. ``x`` is replicated. See ops.kernels;
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests)."""

    a: jnp.ndarray
    b: jnp.ndarray
    mesh: object
    interpret: bool = False

    def value_and_aux(self, x):
        from ..ops import kernels
        from ..platform import kernel_interpret

        interp = kernel_interpret(self.interpret)

        def local(a_blk, b_blk, x_rep):
            f_part, grad_part = kernels.fused_ls_value_grad(
                a_blk, b_blk, x_rep, interpret=interp
            )
            f_tot = jax.lax.psum(f_part, ROWS)
            grad_tot = jax.lax.psum(grad_part, ROWS)
            return f_tot, grad_tot

        f_x, grad = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(ROWS, None), P(ROWS), P()),
            out_specs=(P(), P()),
            # pallas_call outputs carry no varying-mesh-axes metadata
            check_vma=False,
        )(self.a, self.b, x)
        return f_x, grad

    def grad_from_aux(self, x, aux):
        del x
        return aux

    def bregman_from_aux(self, dx, aux, aux_prev):
        # aux IS the (replicated) gradient: 0.5 dx'A'A dx = 0.5 <dx, dgrad>,
        # clamped at the exact lower bound 0 — same cancellation-resistant
        # form as LeastSquares' fused path. Without this override the base
        # class returns None and exact_bregman= silently falls back to the
        # raw eps*|f| difference, re-opening the measured f32 linesearch
        # stall for sharded solves (review r5-5).
        return jnp.maximum(0.5 * jnp.vdot(dx, aux - aux_prev).real, 0.0)


def row_sharded_fused_ls(a, b, mesh, interpret=False):
    """Place (a, b) row-sharded on ``mesh`` and return the fused oracle."""
    a = jax.device_put(a, NamedSharding(mesh, P(ROWS, None)))
    b = jax.device_put(b, NamedSharding(mesh, P(ROWS)))
    return RowShardedFusedLS(a=a, b=b, mesh=mesh, interpret=interpret)
