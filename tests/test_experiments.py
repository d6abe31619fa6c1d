"""End-to-end experiment-driver smoke tests: each reference runme has a
driver that runs a reduced grid, writes reference-schema JSONL, and plots."""

import json
import os

import pytest

from adaprox_tpu.utils.logging import read_jsonl


def _methods(rows):
    return {r["method"] for r in rows if r.get("method")}


def test_lasso_driver(tmp_path):
    from adaprox_tpu.experiments import lasso

    lasso.main(["--cpu", "--outdir", str(tmp_path), "--sizes", "64x96x8", "--maxit", "150",
                "--no-plot"])
    rows = read_jsonl(tmp_path / "lasso_64_96_8.jsonl")
    assert rows[0]["method"] is None  # analytic-optimum pseudo record
    ms = _methods(rows)
    assert {"PGM (fixed)", "Nesterov (fixed)", "AdaPGM (Ours)", "AdaPGM (MM)",
            "aGRAAL", "Nesterov (backtracking)"} <= ms
    assert sum(1 for m in ms if m.startswith("PGM (backtracking)")) == 3
    # record key schema (PG form)
    keys = set(rows[1].keys())
    assert keys == {"method", "it", "gamma", "norm_res", "objective",
                    "grad_f_evals", "prox_g_evals", "f_evals"}


def test_lasso_driver_live_rows_match_history(tmp_path):
    """Driver-level --live equivalence (review r5-3 finding 6): the live
    JSONL's rows must equal the history-mode JSONL's rows at the same
    iterations, per method, bit-for-bit — catches menu-wiring drift (kwargs,
    fixups, key projection) that unit tests of live_solve cannot see."""
    from adaprox_tpu.experiments import lasso

    lasso.main(["--cpu", "--outdir", str(tmp_path / "hist"), "--sizes", "64x96x8",
                "--maxit", "150", "--no-plot"])
    lasso.main(["--cpu", "--outdir", str(tmp_path / "live"), "--sizes", "64x96x8",
                "--maxit", "150", "--no-plot", "--live"])
    hist = read_jsonl(tmp_path / "hist" / "lasso_64_96_8.jsonl")
    live = read_jsonl(tmp_path / "live" / "lasso_64_96_8.jsonl")
    hist_by = {(r["method"], r["it"]): r for r in hist if r.get("method")}
    live_rows = [r for r in live if r.get("method")]
    assert len(live_rows) > 50  # every method echoed its log boundaries
    meta_live = [r for r in live if r.get("fast_path")]
    assert meta_live and meta_live[-1]["fast_path"] == "live"
    for r in live_rows:
        ref = hist_by.get((r["method"], r["it"]))
        assert ref is not None, (r["method"], r["it"])
        assert r == ref, (r["method"], r["it"])


def test_sparse_logreg_driver(tmp_path):
    from adaprox_tpu.experiments import sparse_logreg

    sparse_logreg.main(["--cpu", "--outdir", str(tmp_path), "--datasets", "heart_scale",
                        "--maxit", "60", "--no-plot"])
    rows = read_jsonl(tmp_path / "heart_scale.jsonl")
    assert "AdaPGM (Ours)" in _methods(rows)
    # the high-accuracy ground-truth run is present with method == None
    assert any(r.get("method") is None for r in rows)


def test_dual_svm_driver(tmp_path):
    from adaprox_tpu.experiments import dual_svm

    dual_svm.main(["--cpu", "--outdir", str(tmp_path), "--datasets", "heart_scale",
                   "--C", "0.1", "--maxit", "80", "--no-plot"])
    rows = read_jsonl(tmp_path / "heart_scale_C_0.1.jsonl")
    # projected keys only (dual_svm/runme.jl:141)
    assert set(rows[0].keys()) == {"method", "it", "f_evals", "norm_res"}
    ms = _methods(rows)
    assert "Condat-Vu" in ms
    assert sum(1 for m in ms if m.startswith("AdaPDM")) == 12
    assert sum(1 for m in ms if m.startswith("Malitsky-Pock")) == 12


def test_dual_svm_vmap_sweep_matches_sequential(tmp_path):
    from adaprox_tpu.experiments import dual_svm

    dual_svm.main(["--cpu", "--outdir", str(tmp_path / "seq"), "--datasets", "heart_scale",
                   "--C", "0.1", "--maxit", "40", "--no-plot"])
    dual_svm.main(["--cpu", "--outdir", str(tmp_path / "vm"), "--datasets", "heart_scale",
                   "--C", "0.1", "--maxit", "40", "--no-plot", "--vmap-sweep"])
    seq = read_jsonl(tmp_path / "seq" / "heart_scale_C_0.1.jsonl")
    vm = read_jsonl(tmp_path / "vm" / "heart_scale_C_0.1.jsonl")

    def final_res(rows, method):
        return [r for r in rows if r.get("method") == method][-1]["norm_res"]

    for t in (0.1, 1, 10):
        a = final_res(seq, f"AdaPDM (t={t})")
        b = final_res(vm, f"AdaPDM (t={t})")
        assert a == pytest.approx(b, rel=1e-6, abs=1e-10)


def test_square_root_lasso_driver(tmp_path):
    from adaprox_tpu.experiments import square_root_lasso

    square_root_lasso.main(["--cpu", "--outdir", str(tmp_path), "--datasets", "housing_scale",
                            "--maxit", "50", "--no-plot"])
    rows = read_jsonl(tmp_path / "housing_scale.jsonl")
    assert set(rows[0].keys()) == {"method", "norm_res", "A_evals", "At_evals"}
    ms = _methods(rows)
    assert "Condat-Vu" in ms
    assert sum(1 for m in ms if m.startswith("AdaPDM+")) == 15
    assert sum(1 for m in ms if m.startswith("Malitsky-Pock")) == 15


def test_sqrt_lasso_vmap_sweep_matches_sequential(tmp_path):
    """The AdaPDM+ t-sweep (nested eta-linesearch while_loop) as ONE vmapped
    kernel must reproduce the sequential sweep (VERDICT r1 item 6)."""
    from adaprox_tpu.experiments import square_root_lasso

    square_root_lasso.main(["--cpu", "--outdir", str(tmp_path / "seq"), "--datasets",
                            "housing_scale", "--maxit", "40", "--no-plot"])
    square_root_lasso.main(["--cpu", "--outdir", str(tmp_path / "vm"), "--datasets",
                            "housing_scale", "--maxit", "40", "--no-plot",
                            "--vmap-sweep"])
    seq = read_jsonl(tmp_path / "seq" / "housing_scale.jsonl")
    vm = read_jsonl(tmp_path / "vm" / "housing_scale.jsonl")

    def final_res(rows, method):
        return [r for r in rows if r.get("method") == method][-1]["norm_res"]

    for fam in ("AdaPDM+", "Malitsky-Pock"):
        for t in (0.1, 1, 100):
            a = final_res(seq, f"{fam} (t={t})")
            b = final_res(vm, f"{fam} (t={t})")
            assert a == pytest.approx(b, rel=1e-6, abs=1e-10), (fam, t)


def test_least_absolute_deviation_driver(tmp_path):
    from adaprox_tpu.experiments import least_absolute_deviation

    least_absolute_deviation.main(["--cpu", "--outdir", str(tmp_path), "--datasets",
                                   "housing_scale", "--maxit", "50", "--no-plot"])
    rows = read_jsonl(tmp_path / "housing_scale.jsonl")
    assert "Condat-Vu" in _methods(rows)


def test_cubic_driver(tmp_path):
    from adaprox_tpu.experiments import cubic_sparse_logreg

    cubic_sparse_logreg.main(["--cpu", "--outdir", str(tmp_path), "--datasets", "heart_scale",
                              "--maxit", "40", "--no-plot"])
    rows = read_jsonl(tmp_path / "heart_scale.jsonl")
    ms = _methods(rows)
    assert {"AdaPGM (Ours)", "AdaPGM (MM)", "aGRAAL", "Nesterov (backtracking)"} <= ms


def test_nesterov_worst_case_driver(tmp_path):
    from adaprox_tpu.experiments import nesterov_worst_case

    nesterov_worst_case.main(["--cpu", "--outdir", str(tmp_path), "--maxit", "500", "--no-plot"])
    rows = read_jsonl(tmp_path / "nesterov_worst_case.jsonl")
    # known-optimum pseudo record and gap sanity: accelerated beats plain PG
    opt = rows[0]["objective"]
    assert rows[0]["method"] is None

    def final_gap(method):
        sel = [r for r in rows if r.get("method") == method]
        return sel[-1]["objective"] - opt

    assert final_gap("Fixed Nesterov") <= final_gap("Fixed stepsize PGM") + 1e-12


def test_plotting(tmp_path):
    pytest.importorskip("matplotlib")
    from adaprox_tpu.experiments import lasso

    lasso.main(["--cpu", "--outdir", str(tmp_path), "--sizes", "32x48x8", "--maxit", "60"])
    assert os.path.exists(tmp_path / "lasso_32_48_8.jsonl.pdf")


DRIVERS = ["lasso", "sparse_logreg", "dual_svm", "square_root_lasso",
           "least_absolute_deviation", "cubic_sparse_logreg",
           "nesterov_worst_case"]


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_without_gpu_names_cpu(name, tmp_path, monkeypatch):
    """Without --cpu a driver must find a GPU; on a CPU-only process it
    exits with an error that names --cpu instead of running silently on
    the CPU."""
    import importlib

    from adaprox_tpu import platform

    monkeypatch.setattr(platform, "enable_compile_cache", lambda: "")
    driver = importlib.import_module(f"adaprox_tpu.experiments.{name}")
    with pytest.raises(SystemExit, match="--cpu"):
        driver.main(["--outdir", str(tmp_path), "--maxit", "5", "--no-plot"])
    assert not list(tmp_path.iterdir())  # nothing ran
