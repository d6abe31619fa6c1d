"""Wall-clock timing, device profiling and the card's published peaks
(SURVEY §5: the reference's cost model is oracle calls only; this build
adds throughput instrumentation).

* ``timed(run)`` — best-of-n wall time of a jitted solve, each repetition
  ended by ``jax.block_until_ready`` on its whole output.
* ``trace(logdir)`` — context manager around ``jax.profiler`` for Perfetto/
  TensorBoard device traces of the solver loop.
* ``PEAKS`` / ``device_peaks(device)`` — the one table of published peak
  rates, keyed by the ``device_kind`` string the card reports. A device
  that is not in the table is an error, never a default.
* ``throughput_report(...)`` — iterations/s and achieved bandwidth against
  the device's published memory bandwidth, for matvec-bound solvers.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import jax

__all__ = ["timed", "trace", "throughput_report", "Peak", "PEAKS",
           "device_peaks"]


class Peak(NamedTuple):
    hbm_gbps: float       # device memory bandwidth, GB/s
    bf16_tflops: float    # tensor cores, dense
    f32_tflops: float     # CUDA cores, outside the tensor cores
    f64_tflops: float     # CUDA cores, outside the tensor cores
    source: str


_H100_SHEET = "NVIDIA H100 Tensor Core GPU data sheet, dense rates"

# key: jax.devices()[i].device_kind, exactly as the card reports it
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(3350.0, 989.0, 67.0, 34.0,
                                  _H100_SHEET + ", SXM5 column"),
    "NVIDIA H100 PCIe": Peak(2000.0, 756.0, 51.0, 26.0,
                             _H100_SHEET + ", PCIe column"),
}


def device_peaks(device=None) -> Peak:
    """Published peaks of ``device`` (default: the first JAX device).
    Raises ``KeyError`` for a device kind the table does not know."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a row with "
            "its source to adaprox_tpu.utils.profiling.PEAKS") from None


def timed(run, reps: int = 3):
    """Best-of-``reps`` wall time of ``run()``, each call ended by
    ``jax.block_until_ready``. Returns (seconds, last_output); the first
    (compile) call is excluded."""
    out = jax.block_until_ready(run())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(logdir: str):
    """Device trace of the enclosed block (view in TensorBoard/Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput_report(seconds: float, iters: int, bytes_per_iter: float,
                      device=None) -> dict:
    peak = device_peaks(device).hbm_gbps
    ips = iters / seconds
    gbps = bytes_per_iter * ips / 1e9
    return {
        "iters_per_sec": ips,
        "achieved_gbps": gbps,
        "peak_gbps": peak,
        "frac_peak": gbps / peak,
    }
