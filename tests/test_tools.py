"""Tests for the tools/ measurement + reporting layer (CPU-runnable parts).

Timings need the card, but the parts that rot silently are testable
locally: summarize_results (generates the RESULTS.md tables), the
multi-process launcher's per-process environment, the sweep launcher the
scaling modes shard, and bench.py's timing helper and peak lookup.

A full parity_report smoke run is gated behind ADAPROX_SLOW_TESTS=1 (it is
minutes of f64 CPU solves).
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_jsonl(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_summarize_results_tables(tmp_path, monkeypatch):
    """Family grouping, best-variant selection, pseudo-record optimum, data
    source label, and the fast-tree wall-clock pairing (exact-name and the
    resident-sweep prefix-pairing branch)."""
    from tools import summarize_results

    eng = tmp_path / "results"
    fast = tmp_path / "results_fast"
    rows = [
        {"data_source": "synthetic"},
        # pseudo-record with the known optimum (method-less row)
        {"objective": 1.0},
        {"method": "AdaPGM (Ours)", "it": 5, "norm_res": 1e-4, "objective": 1.6},
        {"method": "AdaPGM (Ours)", "it": 10, "norm_res": 1e-8, "objective": 1.5},
        {"method": "AdaPGM (MM)", "it": 10, "norm_res": 1e-6, "objective": 1.7},
        {"method": "aGRAAL", "it": 10, "norm_res": 3e-3, "objective": 2.0},
        {"wall_s": {"AdaPGM (Ours)": 2.0, "AdaPGM (MM)": 3.0,
                    "AdaPDM t-sweep (engine)": 4.0},
         "fast_path": "default", "fast_methods": []},
    ]
    _write_jsonl(str(eng / "lasso" / "lasso_100x300.jsonl"), rows)
    fast_rows = [
        {"data_source": "synthetic"},
        {"method": "AdaPGM (Ours)", "it": 10, "norm_res": 1e-8, "objective": 1.5},
        {"wall_s": {"AdaPGM (Ours)": 0.5,
                    "AdaPDM t-sweep (resident)": 0.25},
         "fast_path": "resident",
         "fast_methods": ["AdaPGM (Ours)", "AdaPDM t-sweep (resident)"]},
    ]
    _write_jsonl(str(fast / "lasso" / "lasso_100x300.jsonl"), fast_rows)

    out = tmp_path / "RESULTS.md"
    _run_main(summarize_results,
              ["--results", str(eng), "--fast", str(fast), "--out", str(out)],
              monkeypatch)
    text = out.read_text()

    assert "SYNTHETIC fallback data" in text
    # best variant within the AdaPGM family = smallest final residual
    assert "| AdaPGM | AdaPGM (Ours) | 10 | 1.00e-08 | 5.00e-01 |" in text
    # gap uses the pseudo-record optimum (1.5 - 1.0), not the family min
    assert "| aGRAAL | aGRAAL | 10 | 3.00e-03 | 1.00e+00 |" in text
    # exact-name wall-clock pairing
    assert "| AdaPGM (Ours) | 2.00 | 0.50 | 4.00x | resident |" in text
    # resident sweeps rename the method row -> prefix pairing
    assert ("| AdaPGM t-sweep" not in text)
    assert ("AdaPDM t-sweep (resident) vs AdaPDM t-sweep (engine) | 4.00 | "
            "0.25 | 16.00x" in text)


def test_summarize_results_optimum_fallback(tmp_path, monkeypatch):
    """With no pseudo-record row the optimum falls back to the best finite
    objective seen across methods (reference find_best semantics)."""
    from tools import summarize_results

    eng = tmp_path / "results"
    rows = [
        {"method": "PGM", "it": 3, "norm_res": 1e-2, "objective": 5.0},
        {"method": "AdaPGM (Ours)", "it": 3, "norm_res": 1e-3,
         "objective": 4.0},
    ]
    _write_jsonl(str(eng / "nwc" / "nwc.jsonl"), rows)
    out = tmp_path / "R.md"
    _run_main(summarize_results, ["--results", str(eng), "--out", str(out)],
              monkeypatch)
    text = out.read_text()
    # gap vs the 4.0 fallback optimum: PGM 1.0, best row 0.0
    assert "| PGM | PGM | 3 | 1.00e-02 | 1.00e+00 |" in text
    assert "| AdaPGM | AdaPGM (Ours) | 3 | 1.00e-03 | 0.00e+00 |" in text


class _FakeProc:
    def wait(self):
        return 0


def _spawned_envs(monkeypatch, argv):
    from adaprox_tpu.parallel import launch

    envs = []
    monkeypatch.setattr(launch.subprocess, "Popen",
                        lambda cmd, env: envs.append((cmd, env)) or _FakeProc())
    assert launch.main(argv) == 0
    return envs


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_launch_spawn_gives_each_gpu_process_one_card(nproc, monkeypatch):
    """--backend gpu: one card per process through CUDA_VISIBLE_DEVICES (a
    JAX process reserves most of a card's memory), no virtual CPU devices
    added."""
    envs = _spawned_envs(monkeypatch, ["--spawn", str(nproc), "--backend", "gpu"])
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in envs] == [
        str(i) for i in range(nproc)]
    for cmd, env in envs:
        assert env.get("XLA_FLAGS") == os.environ.get("XLA_FLAGS")
        assert cmd[cmd.index("--backend") + 1] == "gpu"


def test_launch_spawn_cpu_uses_virtual_devices(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    envs = _spawned_envs(monkeypatch, ["--spawn", "2", "--backend", "cpu",
                                       "--devices-per-process", "3"])
    for _, env in envs:
        assert "--xla_force_host_platform_device_count=3" in env["XLA_FLAGS"]
        assert "CUDA_VISIBLE_DEVICES" not in env


def test_launch_backend_choices():
    from adaprox_tpu.parallel import launch

    with pytest.raises(SystemExit):
        launch.main(["--backend", "xpu"])


def test_mp_t_sweep_matches_loop():
    """scaling.mp_t_sweep (the engine vmapped over t, the sweep launcher the
    sweep-scaling modes shard) equals the per-t sequential solves."""
    import jax.numpy as jnp
    import numpy as np

    import adaprox_tpu as ap
    from adaprox_tpu.experiments.scaling import mp_t_sweep

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((24, 12)))
    bv = jnp.asarray(rng.standard_normal(24))
    ts = jnp.asarray([0.3, 1.0, 3.0])
    xs = mp_t_sweep(a, bv, ts, maxit=25)
    for i, t in enumerate(np.asarray(ts)):
        ref = ap.malitsky_pock(
            jnp.zeros(12), jnp.zeros(24), f=ap.ZeroSmooth(),
            g=ap.L1Norm(lam=0.1),
            h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-bv),
            A=ap.DenseOperator(a=a), t=float(t), sigma=1.0, tol=0.0, maxit=25)
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(ref.x),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.skipif(not os.environ.get("ADAPROX_SLOW_TESTS"),
                    reason="minutes of f64 CPU solves; set ADAPROX_SLOW_TESTS=1")
def test_parity_report_fast_smoke(tmp_path):
    """parity_report --fast end-to-end on CPU: writes a report containing
    every section and no unmet residual criterion rows."""
    out = tmp_path / "PARITY_SMOKE.md"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "parity_report.py"),
         "--fast", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-2000:]
    text = out.read_text()
    for section in ("## Lasso", "## Sparse logistic regression",
                    "## Cubic-regularized subproblem",
                    "## Nesterov worst case", "## Primal-dual residual"):
        assert section in text


def test_bench_timing_helpers():
    """bench.py's timing helper off-chip: interleaved best/median per
    runner; and the device -> published-peak lookup it divides by."""
    import time as _time

    import bench
    from adaprox_tpu.utils.profiling import PEAKS, device_peaks

    calls = []

    def make(delay):
        def fn():
            calls.append(delay)
            _time.sleep(delay)
            return 0.0
        return fn

    timed = bench.time_interleaved(
        {"fast": make(0.001), "slow": make(0.004)}, rounds=3)
    (fb, fm), (sb, sm) = timed["fast"], timed["slow"]
    assert fb < sb           # ordering preserved
    assert fm >= fb and sm >= sb  # median >= best
    # 3 rounds x 2 runners (+1 compile pass each)
    assert len(calls) == 8

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    assert device_peaks(Dev()).hbm_gbps == 3350.0
    assert device_peaks(Dev()) is PEAKS["NVIDIA H100 80GB HBM3"]
    Dev.device_kind = "Other Accelerator v5"
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(Dev())
