"""Device-parallel sweeps: shard the SWEEP axis over a mesh.

A sweep launcher runs an entire experiment grid — the reference's coupling
sweeps (dual_svm/runme.jl:61, square_root_lasso/runme.jl:80-95), method
menus, regularization paths — as ONE program: the solver engine vmapped
over the sweep index (e.g. experiments.scaling.mp_t_sweep). Every sweep
cell is an independent solve, so the natural multi-device layout is *work*
parallelism:

  * sweep table (``ts`` / ``rows``, shape (T, ...))  -> P("sweep")
  * problem operands (Q / A / b, identical per cell) -> P()  (replicated)
  * every output (x, numit, ... all (T, ...))        -> P("sweep")

Each device runs the SAME program on its T/N slice of the sweep — zero
cross-device communication inside the solve; the outputs come back as
sweep-sharded device arrays on the mesh (read them whole from a
single-process mesh, or re-shard to replicated for multi-process reads —
see parallel/launch.py::_worker_sweep), so strong scaling is linear until
T/N < 1. This composes with the operand-sharded paths (parallel/mesh.py,
parallel/fused.py) which split a single LARGE problem instead: shard the
sweep when the grid is wide, shard the operand when the matrix is the
thing that doesn't fit — or both at once over a 2-D mesh
(``composed_mesh``).

``sharded_sweep`` takes host-local arrays and is meant for SINGLE-PROCESS
meshes (one host's devices, or the virtual CPU mesh). On a multi-process
mesh, build global arrays with ``jax.make_array_from_callback`` and keep T
divisible by the global device count (the edge-repeat pad path
concatenates eagerly, which requires fully-addressable arrays) —
``parallel/launch.py --mode sweep`` is the worked multi-process example.

No counterpart in the single-process reference (SURVEY.md §2.4 net-new).
"""

from __future__ import annotations

import functools as _functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["SWEEP", "sweep_mesh", "sharded_sweep", "maybe_sharded_sweep",
           "composed_mesh"]

SWEEP = "sweep"


def sweep_mesh(n_devices=None, devices=None) -> Mesh:
    """A 1-D ("sweep",) mesh over ``n_devices`` (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # silent truncation would mislabel scaling rows (a "16-device"
            # measurement that actually ran on 8)
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SWEEP,))


def _pad_dim0(x, pad):
    """Edge-repeat ``pad`` rows so dim0 divides the mesh; padded cells
    recompute the last sweep entry and are sliced away from every
    output."""
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)


@_functools.lru_cache(maxsize=32)
def _shmap_callable(fn, mesh, names, shard_keys, out_axis):
    """The shard-mapped sweep wrapper, cached on (fn identity, mesh, arg
    names, shard set, out_axis): jax's trace cache keys on the callable's
    identity, so rebuilding the closure per sharded_sweep call would
    re-trace the whole sweep every invocation — repeated launches (timed
    loops, drivers re-running a grid) would pay tracing + lowering inside
    what looks like pure execution."""
    in_specs = tuple(P(SWEEP) if k in shard_keys else P() for k in names)

    def call(*chunked):
        return fn(**dict(zip(names, chunked)))

    out_spec = P(*((None,) * out_axis), SWEEP)
    return jax.shard_map(call, mesh=mesh, in_specs=in_specs,
                         out_specs=out_spec, check_vma=False)


def sharded_sweep(fn, mesh, arrays, shard_keys, out_axis=0):
    """Run sweep launcher ``fn`` with its sweep axis sharded over ``mesh``.

    ``fn``         — a sweep launcher (e.g. experiments.scaling.mp_t_sweep)
                     with every NON-array parameter (maxit, tol, ...)
                     already bound via functools.partial: inside shard_map
                     they must stay compile-time constants (maxit sizes
                     history buffers).
    ``arrays``     — dict name -> array: ALL array arguments, passed to
                     ``fn`` by keyword. Never close over a large operand
                     inside ``fn`` — a closure capture becomes a compile-
                     time constant embedded in the program.
    ``shard_keys`` — the names whose dim 0 is the sweep axis (the ts /
                     rows table). Everything else is replicated.
    ``out_axis``   — which axis of every OUTPUT leaf carries the sweep
                     dim. 0 for the plain sweeps; 1 for (dataset x t) grid
                     launchers whose outputs are (D, T, ...) with the t axis
                     sharded.

    The sweep length T is padded (edge-repeat) to a multiple of the mesh
    size; every output leaf stays SHARDED along "sweep" at ``out_axis``
    (no gather — see the module docstring) and is sliced back to T.
    The pad path requires a single-process mesh (eager concatenate).
    """
    shard_keys = set(shard_keys)
    unknown = shard_keys - set(arrays)
    if unknown:
        raise ValueError(f"shard_keys {sorted(unknown)} not in arrays")
    nd = mesh.devices.size
    tdims = {arrays[k].shape[0] for k in shard_keys}
    if len(tdims) != 1:
        raise ValueError(f"sharded arrays disagree on sweep length: {tdims}")
    (t,) = tdims
    pad = (-t) % nd
    if pad and jax.process_count() > 1:
        raise ValueError(
            f"sweep length {t} must divide the mesh size {nd} on a "
            "multi-process mesh (the edge-repeat pad concatenates eagerly, "
            "which needs fully-addressable arrays)")
    names = list(arrays)
    vals = [
        _pad_dim0(jnp.asarray(arrays[k]), pad) if k in shard_keys
        else jnp.asarray(arrays[k])
        for k in names
    ]
    out = _shmap_callable(fn, mesh, tuple(names), frozenset(shard_keys),
                          out_axis)(*vals)
    if pad:
        out = jax.tree.map(
            lambda o: jax.lax.slice_in_dim(o, 0, t, axis=out_axis), out)
    return out


def composed_mesh(n_sweep, n_rows, devices=None) -> Mesh:
    """2-D ("sweep", "rows") mesh composing the two parallel axes: the
    batch dimension of a vmapped grid over "sweep" and the data-matrix
    rows over "rows". This is the layout for grids whose single instance
    is too large to replicate per device but that still sweep many cells: place the batched rule
    params with P(SWEEP), the operands with P(ROWS, ...) as in
    parallel/mesh.py, jit the vmapped solve, and GSPMD partitions both
    axes — the row-reduction psums stay within each sweep group. See
    tests/test_sweep_sharding.py::test_composed_sweep_rows_regpath."""
    if devices is None:
        devices = jax.devices()
    need = n_sweep * n_rows
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    from .mesh import ROWS  # the operand axis name shared with mesh.py

    return Mesh(np.asarray(devices[:need]).reshape(n_sweep, n_rows),
                (SWEEP, ROWS))


def maybe_sharded_sweep(fn, arrays, shard_keys, devices=None, out_axis=0):
    """``sharded_sweep`` over all local devices when more than one is
    available; on a single device calls ``fn(**arrays)`` directly, zero
    overhead — bit-equal to the single-device launch
    (tests/test_sweep_sharding.py)."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < 2:
        return fn(**arrays)
    return sharded_sweep(fn, sweep_mesh(devices=devices), arrays, shard_keys,
                         out_axis=out_axis)
