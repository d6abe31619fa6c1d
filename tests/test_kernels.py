"""The one-pass least-squares kernel (Pallas through Triton) against its XLA
two-pass reference: in interpret mode on the CPU, compiled on the card
(``chip``-marked tests, also covered by chip_smoke.py phase 3)."""

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares
from adaprox_tpu.ops import kernels

# tall, wide, square; aligned and ragged; a single row and a single column
SHAPES = [(64, 128), (128, 256), (8, 128), (37, 200), (100, 33), (5, 300),
          (300, 5), (1, 64), (257, 129)]
# (block_rows, block_cols, programs): default tiles, and small tiles over
# few programs so every shape spans several panels, chunks and walks
BLOCKS = [(None, None, None), (2, 64, 3), (8, 16, 5)]


def _problem(rng, m, n, dtype):
    a = jnp.asarray(rng.standard_normal((m, n)), dtype)
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    return a, b, x


@pytest.mark.parametrize("block", BLOCKS, ids=["default", "2x64x3", "8x16x5"])
@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_fused_ls_matches_xla(rng, dtype, m, n, block):
    """(f, grad) against ls_value_grad_xla(precision="highest") on the same
    (possibly bf16) matrix: both accumulate in f32, in different orders."""
    a, b, x = _problem(rng, m, n, dtype)
    tm, tn, g = block
    f_ref, g_ref = kernels.ls_value_grad_xla(a, b, x)
    f_k, g_k = kernels.fused_ls_value_grad(a, b, x, interpret=True,
                                           block_rows=tm, block_cols=tn,
                                           programs=g)
    assert f_k.dtype == jnp.float32 and g_k.dtype == jnp.float32
    assert g_k.shape == (n,)
    np.testing.assert_allclose(float(f_k), float(f_ref), rtol=1e-5)
    scale = float(jnp.max(jnp.abs(g_ref)))
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5 * scale)


def test_fused_ls_bf16_storage(rng):
    """bf16 storage agrees with the f32 matrix to bf16 resolution, and the
    accumulation stays f32."""
    m, n = 64, 128
    a = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    f_k, g_k = kernels.fused_ls_value_grad(a, b, x, interpret=True)
    f_ref, g_ref = kernels.ls_value_grad_xla(a.astype(jnp.float32), b, x)
    np.testing.assert_allclose(float(f_k), float(f_ref), rtol=3e-2)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_ref), rtol=5e-2, atol=0.3)
    assert g_k.dtype == jnp.float32


def test_fused_ls_is_deterministic(rng):
    """No atomics: two calls give bit-identical results (the solvers'
    bit-exact resume relies on a fixed summation order)."""
    a, b, x = _problem(rng, 97, 70, jnp.float32)
    kw = dict(interpret=True, block_rows=2, block_cols=32, programs=4)
    f1, g1 = kernels.fused_ls_value_grad(a, b, x, **kw)
    f2, g2 = kernels.fused_ls_value_grad(a, b, x, **kw)
    assert float(f1) == float(f2)
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))


def test_fused_objective_solves_lasso(rng):
    """AdaPGM with the fused oracle reaches the same solution as unfused."""
    m, n = 64, 128
    a = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    g = ap.L1Norm(lam=jnp.float32(0.5))
    kw = dict(g=g, rule=ap.AdaPGMRule(gamma=jnp.float32(1e-3)), tol=1e-5, maxit=500)
    r_plain = ap.adaptive_proxgrad(jnp.zeros(n, jnp.float32),
                                   f=LeastSquares(a=a, b=b), **kw)
    r_fused = ap.adaptive_proxgrad(
        jnp.zeros(n, jnp.float32),
        f=LeastSquares(a=a, b=b, fused=True, interpret=True), **kw)
    f_eval = LeastSquares(a=a, b=b)
    obj = lambda r: float(f_eval.value(r.x) + g(r.x))
    assert obj(r_fused) == pytest.approx(obj(r_plain), rel=1e-4, abs=1e-5)


def _operand(kind, rng):
    from adaprox_tpu.ops.sparse import ELLOperator

    dense = rng.standard_normal((30, 50))
    return {
        "f32": jnp.asarray(dense, jnp.float32),
        "bf16": jnp.asarray(dense, jnp.bfloat16),
        "f64": jnp.asarray(dense, jnp.float64),
        "ell": ELLOperator.from_dense(dense),
        "dense_op": ap.DenseOperator(a=jnp.asarray(dense)),
    }[kind]


@pytest.mark.parametrize("kind,uses_kernel", [
    ("f32", True), ("bf16", True), ("f64", False), ("ell", False),
    ("dense_op", False)])
def test_kernel_choice(rng, kind, uses_kernel):
    """fused=True takes the kernel for any dense f32/bf16 matrix, ragged
    shapes included (30x50 here); other operands keep the XLA path and
    still give the right value."""
    a = _operand(kind, rng)
    b = jnp.asarray(rng.standard_normal(30), jnp.float32)
    f = LeastSquares(a=a, b=b, fused=True, interpret=True)
    assert f._use_fused() is uses_kernel
    x = jnp.ones(50, jnp.float32)
    v, _ = f.value_and_grad(x)
    dense = jnp.asarray(_operand("f64", np.random.default_rng(0)))
    v_ref, _ = kernels.ls_value_grad_xla(dense, b.astype(jnp.float64),
                                         x.astype(jnp.float64))
    tol = 3e-2 if kind == "bf16" else 1e-5
    np.testing.assert_allclose(float(v), float(v_ref), rtol=tol)


def test_fused_without_interpret_needs_gpu(rng):
    """On the CPU the kernel never falls back to the interpreter by itself:
    fused=True without interpret=True is an error that says what to do."""
    a, b, x = _problem(rng, 16, 32, jnp.float32)
    f = LeastSquares(a=a, b=b, fused=True)
    with pytest.raises(RuntimeError, match="interpret=True"):
        f.value_and_grad(x)


@pytest.mark.parametrize("n,shape", [(1, (64, 16)), (16, (64, 16)), (100, (64, 128)),
                                     (1000, (16, 1024)), (4096, (4, 4096)),
                                     (16384, (1, 16384)), (16385, (4, 8192)),
                                     (100000, (4, 8192))])
def test_pick_block_shape(n, shape):
    """Rows up to 16384 wide: one tile of 16384 elements (at most 64 rows);
    wider rows: 4 x 8192 chunks. Powers of two throughout."""
    rows, tn = kernels.pick_block_shape(n)
    assert (rows, tn) == shape
    assert tn & (tn - 1) == 0 and rows & (rows - 1) == 0
    assert rows * tn <= 32768


def test_ls_supported():
    assert kernels.ls_supported(jnp.zeros((3, 4), jnp.float32))
    assert kernels.ls_supported(jnp.zeros((3, 4), jnp.bfloat16))
    assert not kernels.ls_supported(jnp.zeros((3, 4), jnp.float64))
    assert not kernels.ls_supported(jnp.zeros((4,), jnp.float32))


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_fused_ls_compiled_on_gpu(gpu, dtype):
    """The kernel as compiled for the card against the XLA reference, at a
    width that spans several column chunks and a ragged row count."""
    rng = np.random.default_rng(0)
    a, b, x = _problem(rng, 4099, 16384 + 17, dtype)
    f_ref, g_ref = kernels.ls_value_grad_xla(a, b, x)
    f_k, g_k = kernels.fused_ls_value_grad(a, b, x)
    np.testing.assert_allclose(float(f_k), float(f_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(g_ref))))
