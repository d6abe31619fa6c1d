"""One-pass least-squares oracle for the GPU (Pallas through Triton).

The dominant cost of every proximal-gradient iteration on a large dense
least-squares problem is the pair of matrix-vector products inside the
smooth oracle (reference hot loop, SURVEY §3.1):

    res  = A @ x - b          # reads A        (forward / f-eval)
    grad = A' @ res           # reads A again  (pullback)

XLA runs them as two products, so A crosses device memory twice per
iteration. XLA cannot fuse them itself: the second product needs each
row's residual, which only exists once the first has finished that row.
``fused_ls_value_grad`` reads each row of A once from device memory:

    for each panel of ``block_rows`` rows (parallel blocks, no order):
        res_i   = A_i x - b_i
        part_p += A_i' res_i          # same panel, still in registers

Rows up to 16384 wide fit one register tile (16384 elements over 8 warps),
so a panel is loaded once and both products use it from registers; each of
the ``programs`` blocks (one per SM) carries its gradient partial in
registers across its panels and writes it once. Wider rows are streamed in
column chunks twice per panel — the first read marked ``evict_last``, the
second ``evict_first``, so that as much of the second read as possible
comes from the 50 MB L2. The tile shapes were chosen by measurement on an H100 (PERF.md). A
small XLA sum over the (programs, n) partials finishes the gradient. No
atomics: the summation order is fixed, so solves stay bit-reproducible run
to run (checkpoint/resume relies on it).

The arithmetic is an elementwise multiply and reduce in float32, never a
TF32 dot: the adaptive rules difference gradients, and TF32's three
digits poison the curvature estimates.

``ls_value_grad_xla`` is the plain two-pass version, the reference the
kernel is tested against (interpret mode on the CPU, compiled on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["fused_ls_value_grad", "ls_value_grad_xla", "pick_block_shape",
           "ls_supported"]

# Blocks in flight: one per streaming multiprocessor of an H100 SXM. Block
# p walks row panels p, p + programs, ... so neighbouring blocks read
# neighbouring rows at any moment.
_PROGRAMS = 132
_TILE_ELEMS = 16384   # one register tile: 16384 elements over 8 warps
_NUM_WARPS = 8
_CHUNK = (4, 8192)    # (rows, columns) of the tile for rows wider than a tile


def pick_block_shape(n: int) -> tuple[int, int]:
    """(rows, columns) of one block's tile. Rows up to 16384 wide fit one
    tile: the next power of two above ``n`` columns and as many rows as
    keep the tile at 16384 elements (at most 64). Wider rows take 4 x 8192
    chunks. Triton tiles are powers of two; masks cover the ragged edges."""
    cols = pl.next_power_of_2(max(n, 16))
    if cols > _TILE_ELEMS:
        return _CHUNK
    return min(64, _TILE_ELEMS // cols), cols


def ls_supported(a) -> bool:
    """The kernel takes any dense 2-D float32 or bfloat16 matrix: masks,
    not padding, handle ragged edges."""
    return (not hasattr(a, "matvec") and getattr(a, "ndim", 0) == 2
            and a.dtype in (jnp.float32, jnp.bfloat16))


def _ls_kernel(a_ref, x_ref, b_ref, res_ref, part_ref, *, m, n, tm, tn,
               programs):
    pid = pl.program_id(0)
    n_panels = pl.cdiv(m, tm)
    # int32 loop indices, also where float64 (and so int64) is enabled
    zero, n_chunks = jnp.int32(0), jnp.int32(pl.cdiv(n, tn))
    rows_in = jnp.arange(tm)
    cols_in = jnp.arange(tn)
    trips = (n_panels - 1 - pid) // programs + 1

    if tn >= n:
        # whole rows fit one tile: each panel is read once, both products
        # use it from registers, and the gradient partial stays in
        # registers across the block's panels
        cmask = cols_in < n
        xc = plgpu.load(x_ref.at[pl.ds(zero, tn)], mask=cmask, other=0.0)

        def row_panel(k, grad):
            r0 = (pid + k * programs) * tm
            rmask = (r0 + rows_in) < m
            a = plgpu.load(a_ref.at[pl.ds(r0, tm), pl.ds(zero, tn)],
                           mask=rmask[:, None] & cmask[None, :], other=0.0,
                           eviction_policy="evict_first").astype(jnp.float32)
            bi = plgpu.load(b_ref.at[pl.ds(r0, tm)], mask=rmask, other=0.0)
            res = jnp.where(rmask, jnp.sum(a * xc[None, :], axis=1) - bi, 0.0)
            plgpu.store(res_ref.at[pl.ds(r0, tm)], res, mask=rmask)
            return grad + jnp.sum(a * res[:, None], axis=0)

        grad = jax.lax.fori_loop(zero, trips, row_panel,
                                 jnp.zeros((tn,), jnp.float32))
        plgpu.store(part_ref.at[pid, pl.ds(zero, tn)], grad, mask=cmask)
        return

    def panel(k, carry):
        r0 = (pid + k * programs) * tm
        rmask = (r0 + rows_in) < m

        def forward(j, acc):
            c0 = j * tn
            cmask = (c0 + cols_in) < n
            a = plgpu.load(a_ref.at[pl.ds(r0, tm), pl.ds(c0, tn)],
                           mask=rmask[:, None] & cmask[None, :], other=0.0,
                           eviction_policy="evict_last").astype(jnp.float32)
            xc = plgpu.load(x_ref.at[pl.ds(c0, tn)], mask=cmask, other=0.0)
            return acc + a * xc[None, :]

        acc = jax.lax.fori_loop(zero, n_chunks, forward,
                                jnp.zeros((tm, tn), jnp.float32))
        bi = plgpu.load(b_ref.at[pl.ds(r0, tm)], mask=rmask, other=0.0)
        res = jnp.where(rmask, jnp.sum(acc, axis=1) - bi, 0.0)
        plgpu.store(res_ref.at[pl.ds(r0, tm)], res, mask=rmask)

        def pullback(j, c):
            c0 = j * tn
            cmask = (c0 + cols_in) < n
            a = plgpu.load(a_ref.at[pl.ds(r0, tm), pl.ds(c0, tn)],
                           mask=rmask[:, None] & cmask[None, :], other=0.0,
                           eviction_policy="evict_first").astype(jnp.float32)
            # the first panel of each block initialises its partial row
            prev = plgpu.load(part_ref.at[pid, pl.ds(c0, tn)],
                              mask=cmask & (k > 0), other=0.0)
            plgpu.store(part_ref.at[pid, pl.ds(c0, tn)],
                        prev + jnp.sum(a * res[:, None], axis=0), mask=cmask)
            return c

        jax.lax.fori_loop(zero, n_chunks, pullback, 0)
        return carry

    # panels pid, pid + programs, ... below n_panels (programs <= n_panels)
    jax.lax.fori_loop(zero, trips, panel, 0)


@functools.partial(jax.jit, static_argnames=("interpret", "block_rows",
                                             "block_cols", "programs"))
def fused_ls_value_grad(a, b, x, interpret=False, block_rows=None,
                        block_cols=None, programs=None):
    """(f, grad) of 0.5||Ax-b||^2, reading ``a`` once from device memory.

    ``a``: (m, n) float32 or bfloat16, any shape; ``b``: (m,); ``x``: (n,).
    Returns ``(f, grad)``, f in float32 and grad in ``x.dtype``, both
    accumulated in float32. ``block_rows``, ``block_cols`` and ``programs``
    override the tile (``pick_block_shape``) and the number of blocks (one
    per SM); the tests use them to cover ragged edges at small sizes.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU).
    """
    m, n = a.shape
    tm, tn = pick_block_shape(n)
    tm, tn = block_rows or tm, block_cols or tn
    g = min(programs or _PROGRAMS, pl.cdiv(m, tm))
    res, part = pl.pallas_call(
        functools.partial(_ls_kernel, m=m, n=n, tm=tm, tn=tn, programs=g),
        grid=(g,),
        out_shape=(jax.ShapeDtypeStruct((m,), jnp.float32),
                   jax.ShapeDtypeStruct((g, n), jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="fused_ls_value_grad",
        cost_estimate=pl.CostEstimate(
            flops=4 * m * n, bytes_accessed=m * n * a.dtype.itemsize,
            transcendentals=0),
    )(a, x.astype(jnp.float32), b.astype(jnp.float32))
    return 0.5 * jnp.sum(res * res), jnp.sum(part, axis=0).astype(x.dtype)


def ls_value_grad_xla(a, b, x, precision="highest"):
    """Two-pass XLA version: the reference for the kernel."""
    acc = x.dtype
    res = jax.lax.dot_general(
        a, x, (((1,), (0,)), ((), ())), precision=precision,
        preferred_element_type=acc,
    ) - b.astype(acc)
    grad = jax.lax.dot_general(
        res, a, (((0,), (0,)), ((), ())), precision=precision,
        preferred_element_type=acc,
    )
    return 0.5 * jnp.sum(res * res), grad
