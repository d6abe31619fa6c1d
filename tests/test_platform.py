"""The platform decision, the compile-cache helper, the peak table, and
chip_smoke.py's pure-Python parts and phases at small sizes on the CPU
(the script itself needs a GPU; here its phases are rehearsed)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from adaprox_tpu import platform
from adaprox_tpu.utils.profiling import PEAKS, device_peaks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


# --- platform ---------------------------------------------------------------


def test_on_gpu_false_on_cpu():
    assert platform.on_gpu() is False


def test_kernel_interpret_passthrough():
    assert platform.kernel_interpret(True) is True


def test_kernel_interpret_refuses_cpu():
    """Never a silent interpreter run: without interpret=True the CPU is an
    error that names the way out."""
    with pytest.raises(RuntimeError, match="interpret=True"):
        platform.kernel_interpret(False)


@pytest.fixture
def no_cache(monkeypatch):
    monkeypatch.setattr(platform, "enable_compile_cache", lambda: "")


def test_pick_platform_cpu_sets_f64(no_cache):
    platform.pick_platform(force_cpu=True)
    assert jax.config.jax_enable_x64
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("x64", [False, True])
def test_pick_platform_without_gpu_names_cpu(no_cache, x64):
    with pytest.raises(SystemExit, match="--cpu"):
        platform.pick_platform(force_cpu=False, x64=x64)


def test_enable_compile_cache_honours_env(monkeypatch, tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set it is the only cache: the
    helper returns it and sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = platform.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gpu_name_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert platform.gpu_name_and_power_limit() == ""


def test_gpu_name_reads_nvidia_smi(monkeypatch, tmp_path):
    """The name and power limit come from nvidia-smi in a child process."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert platform.gpu_name_and_power_limit() == "NVIDIA H100 80GB HBM3, 700.00 W"


# --- the peak table ---------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(PEAKS))
def test_peak_table_rows(kind):
    class Dev:
        device_kind = kind

    peak = device_peaks(Dev())
    assert peak.hbm_gbps > 0 and peak.bf16_tflops > peak.f32_tflops > peak.f64_tflops > 0
    assert "NVIDIA" in peak.source and "data sheet" in peak.source


@pytest.mark.parametrize("kind", ["cpu", "Other Accelerator v5", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    class Dev:
        device_kind = kind

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(Dev())


def test_peak_table_default_device_on_cpu_raises():
    with pytest.raises(KeyError):
        device_peaks()


# --- chip_smoke.py: pure parts ------------------------------------------------


def test_chip_smoke_result_line_format():
    line = json.loads(cs.device_line())
    assert line == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}}


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    """No GPU: non-zero exit and no result line, with or without --four."""
    assert cs.main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


def test_chip_smoke_phase1_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.phase1_device()


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    """Copied alone into an empty directory the script cannot import the
    package: it fails and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("value,limit,ok", [(1e-6, 1e-5, True), (1e-4, 1e-5, False),
                                            (float("nan"), 1.0, False)])
def test_chip_smoke_check(value, limit, ok, capsys):
    if ok:
        cs.check("t", "x", value, limit)
    else:
        with pytest.raises(AssertionError, match="phase t"):
            cs.check("t", "x", value, limit)
    assert ("PASS" if ok else "FAIL") in capsys.readouterr().out


def test_chip_smoke_rel():
    assert cs.rel(np.ones(4), np.ones(4)) == 0.0
    assert cs.rel([2.0, 0.0], [1.0, 0.0]) == pytest.approx(1.0)


def test_chip_smoke_x64_context_restores():
    jax.config.update("jax_enable_x64", False)
    try:
        with cs.x64():
            assert jax.config.jax_enable_x64
        assert not jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", True)


# --- chip_smoke.py: phases rehearsed at small sizes -------------------------


def test_chip_smoke_phase3_small():
    rates = cs.phase3_least_squares(n=64, iters=20, small=(50, 30),
                                    wide=(6, 16500), interpret=True)
    assert set(rates) == {("f32", "xla"), ("f32", "kernel"),
                          ("bf16", "xla"), ("bf16", "kernel")}


def test_chip_smoke_phase4_small():
    cs.phase4_primal_dual(n=64, iters=50)


def test_chip_smoke_phase5_small():
    cs.phase5_logistic(m=2000, n=20, iters=50)


def test_chip_smoke_phase6_small():
    cs.phase6_regpath(m=200, n=50, k=4, maxit=2000)


def test_chip_smoke_four_sharded_lasso_small():
    """The --four row-sharded check on four of the virtual CPU devices."""
    cs.four_sharded_lasso(m=256, n=64, iters=30)


def test_chip_smoke_four_sweep_regpath_small():
    cs.four_sweep_regpath(m=200, n=50, k=4, maxit=2000)
