"""Device-parallel sweep sharding (parallel/sweep.py): the solver engine
vmapped over a sweep axis, sharded over the virtual 8-device mesh, must
reproduce the single-device vmapped program — every sweep cell is an
independent solve, so sharding only moves cells between devices.

Covers the t-coupling sweeps (f=0 Malitsky-Pock/AdaPDM+, dual-SVM AdaPDM),
method-menu sweeps over a rule parameter, (dataset x t) grids with the t
axis sharded, dataset-axis Condat-Vu grids, the non-divisible padding
path, and the composed (sweep x rows) mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.experiments.scaling import mp_t_sweep
from adaprox_tpu.models.objectives import FactoredQuadratic, LeastSquares
from adaprox_tpu.parallel.sweep import (SWEEP, maybe_sharded_sweep,
                                        sharded_sweep, sweep_mesh)


@pytest.fixture(scope="module")
def mesh():
    return sweep_mesh()


@pytest.fixture(scope="module")
def f0_problem():
    rng = np.random.default_rng(3)
    m, n = 64, 32
    return (jnp.asarray(rng.standard_normal((m, n))),
            jnp.asarray(rng.standard_normal(m)))


def _assert_tree_close(ref, out):
    """Sharding changes the batch each device sees, which may reorder f64
    sums in the batched products, and the adaptive rules amplify that
    through their ratios of differences: agreement to 1e-8 relative."""
    rl, ol = jax.tree.leaves(ref), jax.tree.leaves(out)
    assert len(rl) == len(ol)
    for r, o in zip(rl, ol):
        assert r.shape == o.shape
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-8,
                                   atol=1e-12)


def pdp_t_sweep(a, bv, ts, *, maxit, lam=0.1):
    """AdaPDM+ t-sweep on the square-root-lasso shape (cf. mp_t_sweep)."""
    m, n = a.shape
    h = ap.Translate(inner=ap.L2Norm(lam=1.0), b=-bv)
    na = jnp.sqrt(jnp.sum(a * a))

    def one(t):
        return ap.adaptive_linesearch_primal_dual(
            jnp.zeros(n), jnp.zeros(m), f=ap.ZeroSmooth(),
            g=ap.L1Norm(lam=lam), h=h, A=ap.DenseOperator(a=a), eta=na, t=t,
            tol=0.0, maxit=maxit).x

    return jax.vmap(one)(ts)


@pytest.mark.parametrize("tcount", [8, 11])  # 11 exercises the pad path
@pytest.mark.parametrize("sweep_fn", [mp_t_sweep, pdp_t_sweep],
                         ids=["mp", "adapdm_plus"])
def test_f0_sweep_sharded_matches_single(f0_problem, mesh, sweep_fn, tcount):
    a, bv = f0_problem
    ts = jnp.asarray(np.geomspace(0.1, 10.0, tcount))
    fn = functools.partial(sweep_fn, maxit=30)
    ref = fn(a=a, bv=bv, ts=ts)
    out = sharded_sweep(fn, mesh, {"a": a, "bv": bv, "ts": ts}, {"ts"})
    assert out.shape == (tcount, a.shape[1])
    _assert_tree_close(ref, out)


def _dsvm_sweep(b_mat, labels, ts, *, maxit):
    n = labels.shape[0]
    na = jnp.sqrt(jnp.sum(labels * labels))
    f = FactoredQuadratic(b_mat=b_mat, q_vec=-jnp.ones(n))

    def one(t):
        res = ap.adaptive_primal_dual(
            jnp.zeros(n), jnp.zeros(1), f=f, g=ap.IndBox(lo=0.0, hi=1.0),
            h=ap.IndZero(), A=ap.DenseOperator(a=labels[None, :]),
            rule=ap.AdaPGMRule.make(t=t, norm_a=na), tol=1e-9, maxit=maxit)
        return res.x, res.numit

    return jax.vmap(one)(ts)


def test_dsvm_sweep_sharded_matches_single(mesh):
    """The dual-SVM AdaPDM t-grid (dual_svm/runme.jl:61), gram-free."""
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((40, 6))
    labels = np.sign(rng.standard_normal(40))
    labels[labels == 0] = 1
    arrays = {"b_mat": jnp.asarray(labels[:, None] * feats),
              "labels": jnp.asarray(labels),
              "ts": jnp.asarray([0.01, 0.15, 0.02, 0.025, 0.05, 0.1, 0.2,
                                 0.5, 1, 2, 5, 10])}
    fn = functools.partial(_dsvm_sweep, maxit=50)
    _assert_tree_close(fn(**arrays),
                       sharded_sweep(fn, mesh, arrays, {"ts"}))


def _menu(a, b, g0, gammas, xis, *, maxit):
    """A method menu as two vmapped programs: AdaPGM over its initial
    step, backtracking PG over its inflation factor xi."""
    f = LeastSquares(a=a, b=b)
    g = ap.L1Norm(lam=0.1)
    x0 = jnp.zeros(a.shape[1])
    ada = jax.vmap(lambda gam: ap.adaptive_proxgrad(
        x0, f=f, g=g, rule=ap.AdaPGMRule(gamma=gam), tol=0.0,
        maxit=maxit).x)(gammas)
    bt = jax.vmap(lambda xi: ap.backtracking_proxgrad(
        x0, f=f, g=g, gamma0=g0, xi=xi, tol=0.0, maxit=maxit).x)(xis)
    return ada, bt


def test_method_menu_sweeps_sharded(f0_problem, mesh):
    a, bv = f0_problem
    lf = float(jnp.linalg.norm(a, 2)) ** 2
    arrays = {"a": a, "b": bv, "g0": jnp.asarray(1.0 / lf),
              "gammas": jnp.asarray(np.geomspace(0.1, 2.0, 8) / lf),
              "xis": jnp.asarray(np.linspace(1.0, 2.0, 8))}
    fn = functools.partial(_menu, maxit=40)
    _assert_tree_close(fn(**arrays),
                       sharded_sweep(fn, mesh, arrays, {"gammas", "xis"}))


def test_sharded_sweep_validates(f0_problem, mesh):
    a, bv = f0_problem
    ts = jnp.asarray(np.geomspace(0.1, 10.0, 8))
    fn = functools.partial(mp_t_sweep, maxit=10)
    with pytest.raises(ValueError, match="not in arrays"):
        sharded_sweep(fn, mesh, {"a": a, "bv": bv, "ts": ts}, {"nope"})
    with pytest.raises(ValueError, match="sweep length"):
        sharded_sweep(fn, mesh, {"a": a, "bv": bv, "ts": ts},
                      {"ts", "bv"})


def _grid(a_stack, bv_stack, ts, *, maxit, inner):
    """(dataset x t) grid: outputs (D, T, n), the t axis sharded."""
    def per_dataset(a, bv):
        m, n = a.shape
        h = ap.Translate(inner=inner(lam=1.0), b=-bv)
        return jax.vmap(lambda t: ap.malitsky_pock(
            jnp.zeros(n), jnp.zeros(m), f=ap.ZeroSmooth(),
            g=ap.L1Norm(lam=0.1), h=h, A=ap.DenseOperator(a=a), sigma=1.0,
            t=t, tol=0.0, maxit=maxit).x)(ts)

    return jax.vmap(per_dataset)(a_stack, bv_stack)


@pytest.mark.parametrize("inner", [ap.L2Norm, ap.L1Norm], ids=["l2", "l1"])
def test_f0_grid_t_axis_sharded_matches_single(mesh, inner):
    """sqrt-lasso / LAD families: datasets stacked, t sharded (out_axis=1)."""
    rng = np.random.default_rng(4)
    arrays = {"a_stack": jnp.asarray(rng.standard_normal((3, 32, 16))),
              "bv_stack": jnp.asarray(rng.standard_normal((3, 32))),
              "ts": jnp.asarray(np.geomspace(0.1, 10.0, 11))}
    fn = functools.partial(_grid, maxit=25, inner=inner)
    ref = fn(**arrays)
    out = sharded_sweep(fn, mesh, arrays, {"ts"}, out_axis=1)
    assert out.shape == (3, 11, 16)
    _assert_tree_close(ref, out)


def _cv_grid(a_stack, bv_stack, norms, *, maxit):
    def one(a, bv, na):
        m, n = a.shape
        return ap.condat_vu(
            jnp.zeros(n), jnp.zeros(m), f=ap.ZeroSmooth(),
            g=ap.L1Norm(lam=0.1),
            h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-bv),
            A=ap.DenseOperator(a=a), Lf=0.0, norm_A=na, tol=0.0,
            maxit=maxit).x

    return jax.vmap(one)(a_stack, bv_stack, norms)


def test_cv_grid_dataset_axis_sharded_matches_single(mesh):
    rng = np.random.default_rng(5)
    a_stack = rng.standard_normal((8, 32, 16))
    arrays = {"a_stack": jnp.asarray(a_stack),
              "bv_stack": jnp.asarray(rng.standard_normal((8, 32))),
              "norms": jnp.asarray(np.linalg.norm(a_stack, axis=(1, 2)))}
    fn = functools.partial(_cv_grid, maxit=30)
    _assert_tree_close(fn(**arrays),
                       sharded_sweep(fn, mesh, arrays, set(arrays)))


def test_maybe_sharded_sweep_single_device_is_direct(f0_problem):
    """On one device maybe_sharded_sweep is the direct call (bit-equal);
    over all eight it shards and agrees."""
    a, bv = f0_problem
    arrays = {"a": a, "bv": bv, "ts": jnp.asarray(np.geomspace(0.1, 10.0, 8))}
    fn = functools.partial(mp_t_sweep, maxit=20)
    ref = fn(**arrays)
    one = maybe_sharded_sweep(fn, arrays, {"ts"}, devices=jax.devices()[:1])
    np.testing.assert_array_equal(np.asarray(one), np.asarray(ref))
    _assert_tree_close(ref, maybe_sharded_sweep(fn, arrays, {"ts"}))


def test_sweep_mesh_rejects_too_many_devices():
    with pytest.raises(ValueError, match="need"):
        sweep_mesh(n_devices=len(jax.devices()) + 1)
    assert sweep_mesh(n_devices=2).devices.size == 2


def test_composed_sweep_rows_regpath(f0_problem):
    """Composed 2-D (sweep x rows) parallelism: a vmapped regularization
    path with the lambda/batch axis placed on "sweep" and the data matrix
    row-sharded on "rows" (GSPMD keeps the row psums within each sweep
    group). Must match the unsharded vmapped solve to reduction-
    reassociation noise."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from adaprox_tpu.models.objectives import LeastSquares
    from adaprox_tpu.parallel.mesh import ROWS
    from adaprox_tpu.parallel.sweep import composed_mesh
    from adaprox_tpu.solvers.batch import regularization_path

    a, bv = f0_problem
    n = a.shape[1]
    x0 = jnp.zeros(n)
    lams = jnp.asarray(np.geomspace(0.05, 1.0, 8))
    gamma = 1.0 / float(jnp.linalg.norm(a, 2)) ** 2

    ref = regularization_path(x0, f=LeastSquares(a=a, b=bv), lams=lams,
                              gamma=gamma, tol=0.0, maxit=60)

    cmesh = composed_mesh(2, 4)
    sh = lambda v, spec: jax.device_put(v, NamedSharding(cmesh, spec))
    res = regularization_path(
        sh(x0, P()), f=LeastSquares(a=sh(a, P(ROWS)), b=sh(bv, P(ROWS))),
        lams=sh(lams, P(SWEEP)), gamma=gamma, tol=0.0, maxit=60)
    assert np.array_equal(np.asarray(res.numit), np.asarray(ref.numit))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-12)


def test_output_shards_live_on_the_mesh(f0_problem, mesh):
    """The outputs must actually be sweep-sharded device arrays (each
    device held its own cells), not a host-side concat."""
    a, bv = f0_problem
    ts = jnp.asarray(np.geomspace(0.1, 10.0, 8))
    fn = functools.partial(mp_t_sweep, maxit=20)
    x = sharded_sweep(fn, mesh, {"a": a, "bv": bv, "ts": ts}, {"ts"})
    assert len(x.sharding.device_set) == mesh.devices.size
    assert x.sharding.spec[0] == SWEEP
