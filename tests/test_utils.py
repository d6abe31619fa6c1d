"""Instrumentation + telemetry + IO utilities.

Ports the reference counting tests (test/runtests.jl:53-90) to the eager
wrapper, checks the JSONL schema against the reference record keys, and
exercises the LIBSVM parser on a hand-written file.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.utils.counting import Counting, without_counting
from adaprox_tpu.utils import logging as tlog
from adaprox_tpu.utils.libsvm import load_libsvm_dataset
from adaprox_tpu.models.objectives import LeastSquares
from tests.test_solvers import Simple2DObjective, Simple2DBox


def test_migration_doc_symbols_exist():
    """Every `ap.X` symbol named in MIGRATION.md must exist on the public
    facade — the migration map is a contract, not prose."""
    import os
    import re

    import adaprox_tpu as ap

    path = os.path.join(os.path.dirname(__file__), "..", "MIGRATION.md")
    names = set(re.findall(r"\bap\.([A-Za-z_][A-Za-z0-9_]*)", open(path).read()))
    assert names, "MIGRATION.md should reference ap.* symbols"
    missing = sorted(n for n in names if not hasattr(ap, n))
    assert not missing, f"MIGRATION.md references absent symbols: {missing}"


def test_api_doc_symbols_exist():
    """docs/API.md is the guard-tested public-surface map (r3 verdict #7):
    every `ap.X` facade symbol AND every dotted module entry it names must
    resolve, so the doc cannot silently rot."""
    import importlib
    import os
    import re

    import adaprox_tpu as ap

    path = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")
    text = open(path).read()

    names = set(re.findall(r"\bap\.([A-Za-z_][A-Za-z0-9_]*)", text))
    assert len(names) > 40, "API.md should enumerate the facade surface"
    missing = sorted(n for n in names if not hasattr(ap, n))
    assert not missing, f"API.md references absent facade symbols: {missing}"

    # dotted entries: `from adaprox_tpu.x.y import a, b  / a(...)` style
    # module paths named in import lines
    for mod_path, syms in re.findall(
            r"from (adaprox_tpu(?:\.[a-z_]+)+) import \(?([^)\n]*)", text):
        mod = importlib.import_module(mod_path)
        for sym in re.split(r"[,\s]+", syms):
            sym = sym.strip().rstrip(",")
            if sym and sym.isidentifier():
                assert hasattr(mod, sym), f"{mod_path}.{sym} absent (API.md)"

    # removed modules must not be documented as API
    for gone in ("ops.resident", "pd_kernels", "pd_fused", "bcsr_matvec(",
                 "ell_matvec_pallas", "fused_logistic"):
        assert gone not in text, f"API.md documents removed {gone}"

    # objectives named in the models section
    from adaprox_tpu.models import objectives as ob

    for nm in ("LeastSquares", "GramLeastSquares", "FactoredQuadratic",
               "Quadratic", "LogisticLoss", "Cubic", "WorstQuadratic"):
        assert nm in text and hasattr(ob, nm)


def test_counting_semantics():
    """Mirror of test/runtests.jl:53-90: evals metered eagerly, pullback
    metered lazily, adjoint metered separately, without_counting suppresses."""
    f = Counting(Simple2DObjective())
    g = Counting(Simple2DBox())
    a = Counting(ap.ScaledIdentity(alpha=1.0))

    x = jnp.ones(2)
    _, aux = f.value_and_aux(x)
    g.prox(x, 1.0)
    a.matvec(x)

    assert f.eval_count == 1
    assert f.grad_count == 0  # pullback not yet finished
    assert g.prox_count == 1
    assert a.mul_count == 1
    assert a.amul_count == 0

    f.grad_from_aux(x, aux)
    assert f.grad_count == 1

    a.T @ x
    assert a.amul_count == 1

    with without_counting():
        _, aux = f.value_and_aux(x)
        f.grad_from_aux(x, aux)
        g.prox(x, 1.0)
        a.matvec(x)

    assert f.eval_count == 1
    assert f.grad_count == 1
    assert g.prox_count == 1
    assert a.mul_count == 1
    assert a.amul_count == 1


def test_plain_value_call_not_metered():
    """(f::Counting)(x) forwards without counting (counting.jl:34)."""
    f = Counting(Simple2DObjective())
    f(jnp.ones(2))
    assert f.eval_count == 0


def test_records_to_rows_schema(tmp_path, rng):
    a = jnp.asarray(rng.standard_normal((20, 30)))
    b = jnp.asarray(rng.standard_normal(20))
    f = LeastSquares(a=a, b=b)
    g = ap.L1Norm(lam=0.5)
    res = ap.adaptive_proxgrad(
        jnp.zeros(30), f=f, g=g, rule=ap.AdaPGMRule(gamma=0.01),
        tol=1e-7, maxit=500, history=True, name="AdaPGM (Ours)",
    )
    rows = tlog.records_to_rows(res.records, res.name)
    assert len(rows) == int(res.numit)
    # exact reference PG record keys (src/AdaProx.jl:351 with h=Zero,A=0 path
    # at :56 — method/it/gamma/norm_res/objective/counters)
    assert list(rows[0].keys()) == tlog.PG_KEYS
    assert rows[0]["it"] == 1 and rows[-1]["it"] == int(res.numit)
    assert rows[0]["method"] == "AdaPGM (Ours)"
    # monotone counters
    fe = [r["f_evals"] for r in rows]
    assert all(b >= a for a, b in zip(fe, fe[1:]))

    path = tmp_path / "out.jsonl"
    tlog.write_jsonl(path, rows)
    back = tlog.read_jsonl(path)
    assert back == [json.loads(json.dumps(r)) for r in rows]

    # key projection like dual_svm/runme.jl:141
    path2 = tmp_path / "proj.jsonl"
    tlog.write_jsonl(path2, rows, keys=["method", "it", "f_evals", "norm_res"])
    back2 = tlog.read_jsonl(path2)
    assert list(back2[0].keys()) == ["method", "it", "f_evals", "norm_res"]


def test_is_logstep():
    # multiples of the current power of 10 (experiments/logging.jl:13-17)
    hits = [i for i in range(1, 130) if tlog.is_logstep(i)]
    assert hits == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100]


def test_find_best():
    groups = {
        "A (t=1)": [{"norm_res": 1e-6, "f_evals": 100}],
        "A (t=2)": [{"norm_res": 1e-6, "f_evals": 50}],
        "A (t=3)": [{"norm_res": 1e-2, "f_evals": 10}],
    }
    best = tlog.find_best(groups, list(groups), "norm_res", 1e-5, "f_evals")
    assert best == "A (t=2)"
    # nobody reaches target -> best final value
    groups2 = {
        "B (t=1)": [{"norm_res": 0.5, "f_evals": 10}],
        "B (t=2)": [{"norm_res": 0.1, "f_evals": 99}],
    }
    assert tlog.find_best(groups2, list(groups2), "norm_res", 1e-5, "f_evals") == "B (t=2)"
    # callable duration key (square_root_lasso/runme.jl:105)
    best3 = tlog.find_best(
        groups, list(groups), "norm_res", 1e-5,
        lambda row: row["f_evals"] * 2,
    )
    assert best3 == "A (t=2)"


def test_libsvm_loader(tmp_path):
    p = tmp_path / "toy.libsvm"
    p.write_text("+1 1:0.5 3:2.0\n-1 2:1.5\n+1 1:-1.0 3:0.25\n")
    x, y = load_libsvm_dataset(p)
    np.testing.assert_allclose(x, [[0.5, 0, 2.0], [0, 1.5, 0], [-1.0, 0, 0.25]])
    np.testing.assert_allclose(y, [1, -1, 1])
    # label remap to {0,1} (libsvm.jl:41-56)
    x2, y2 = load_libsvm_dataset(p, labels=(0.0, 1.0))
    np.testing.assert_allclose(y2, [1, 0, 1])
    # zero padding to a block multiple
    x3, y3, m, n = load_libsvm_dataset(p, pad_to=8)
    assert x3.shape == (8, 8) and (m, n) == (3, 3)
    np.testing.assert_allclose(x3[:3, :3], x)
    assert x3[3:].sum() == 0


def test_libsvm_label_validation(tmp_path):
    p = tmp_path / "bad.libsvm"
    p.write_text("1 1:1\n2 1:1\n3 1:1\n")
    with pytest.raises(ValueError):
        load_libsvm_dataset(p, labels=(0.0, 1.0))


def test_load_or_synthesize_offline():
    """Offline environments fall back to shape-matched synthetic data."""
    from adaprox_tpu.utils.datasets import DATASET_SHAPES, load_or_synthesize

    x, y, source = load_or_synthesize("heart_scale", labels=(-1.0, 1.0),
                                      local_dir="/nonexistent_dir_xyz")
    m, n, _ = DATASET_SHAPES["heart_scale"]
    assert x.shape == (m, n)
    assert set(np.unique(y)) <= {-1.0, 1.0}
    assert source == "synthetic"


class TestFindBestReferenceSemantics:
    """find_best must replicate experiments/logging.jl:48-67 exactly: among
    variants whose FINAL objective reached target, pick smallest duration
    (max of the duration column); if none reached, pick best final value
    (VERDICT r1 weak item 7 — a wrong pick silently changes every plot)."""

    def _groups(self, spec):
        # spec: name -> (final_res, duration); builds 2-row record groups
        return {
            name: [{"norm_res": fr * 2, "f_evals": d // 2},
                   {"norm_res": fr, "f_evals": d}]
            for name, (fr, d) in spec.items()
        }

    def test_smallest_duration_among_reached(self):
        from adaprox_tpu.utils.logging import find_best

        g = self._groups({
            "a": (1e-6, 500),   # reached, slow
            "b": (1e-7, 200),   # reached, fastest -> winner
            "c": (1e-2, 10),    # NOT reached (tiny duration is irrelevant)
            "d": (1e-6, 300),   # reached, middle
        })
        assert find_best(g, ["a", "b", "c", "d"], "norm_res", 1e-5, "f_evals") == "b"

    def test_none_reached_best_final_value(self):
        from adaprox_tpu.utils.logging import find_best

        g = self._groups({"a": (0.5, 10), "b": (0.05, 900), "c": (0.2, 20)})
        assert find_best(g, ["a", "b", "c"], "norm_res", 1e-5, "f_evals") == "b"

    def test_reached_beats_better_final_value(self):
        # reference quirk: once any run reached target, a non-reaching run
        # can never win even with a smaller final value column-wise
        from adaprox_tpu.utils.logging import find_best

        g = self._groups({"a": (1e-6, 900), "b": (1e-9, 1000)})
        # both reached: a has the smaller duration
        assert find_best(g, ["a", "b"], "norm_res", 1e-5, "f_evals") == "a"
        g2 = self._groups({"a": (1e-4, 900), "b": (1e-6, 1000)})
        # only b reached: b wins despite larger duration
        assert find_best(g2, ["a", "b"], "norm_res", 1e-5, "f_evals") == "b"

    def test_duration_is_max_of_column_not_last(self):
        from adaprox_tpu.utils.logging import find_best

        # duration = max over rows (reference _duration), so a group whose
        # counter DIPS at the end still counts its max
        g = {
            "a": [{"norm_res": 1e-6, "f_evals": 100}, {"norm_res": 1e-7, "f_evals": 50}],
            "b": [{"norm_res": 1e-6, "f_evals": 60}, {"norm_res": 1e-7, "f_evals": 60}],
        }
        # max durations: a -> 100, b -> 60 => b
        assert find_best(g, ["a", "b"], "norm_res", 1e-5, "f_evals") == "b"

    def test_callable_duration(self):
        from adaprox_tpu.utils.logging import find_best

        g = {
            "a": [{"norm_res": 1e-7, "A_evals": 5, "At_evals": 10}],
            "b": [{"norm_res": 1e-7, "A_evals": 4, "At_evals": 4}],
        }
        got = find_best(g, ["a", "b"], "norm_res", 1e-5,
                        lambda row: row["A_evals"] + row["At_evals"])
        assert got == "b"

    def test_first_name_anchor_when_none_reached(self):
        from adaprox_tpu.utils.logging import find_best

        # the first name is the comparison anchor (reference peel); a later
        # run only replaces it with a strictly better final value
        g = self._groups({"a": (0.3, 10), "b": (0.3, 5)})
        assert find_best(g, ["a", "b"], "norm_res", 1e-5, "f_evals") == "a"


def test_checkpoint_extension_roundtrip(tmp_path):
    """save_pytree/load_pytree must round-trip for any path: np.savez
    silently appends '.npz' which np.load did not (review finding)."""
    from adaprox_tpu.utils.checkpoint import load_pytree, save_pytree

    tree = {"a": np.arange(5), "b": (np.float64(2.5), np.int32(7))}
    written = save_pytree(str(tmp_path / "run1.ckpt"), tree)
    assert written.endswith(".npz")
    out = load_pytree(str(tmp_path / "run1.ckpt"), tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert float(out["b"][0]) == 2.5 and int(out["b"][1]) == 7


def test_libsvm_labels_only_file(tmp_path):
    """A file with labels but zero features must load as an (m, 0)-ish
    matrix, not crash with a float64-index IndexError (review finding)."""
    from adaprox_tpu.utils.libsvm import load_libsvm_dataset

    p = tmp_path / "labels_only.libsvm"
    p.write_text("+1\n-1\n+1\n")
    x, y = load_libsvm_dataset(p, engine="python", n_features=4)
    assert x.shape == (3, 4) and not x.any()
    np.testing.assert_allclose(y, [1.0, -1.0, 1.0])


def test_write_records_jsonl_nonleading_method_key_order(tmp_path):
    """A projection placing "method" after other keys must preserve the
    caller's key ORDER regardless of whether the native sink is present
    (the C++ sink writes method first, so this projection must take the
    Python path — review r5-7)."""
    import json

    import numpy as np

    from adaprox_tpu.solvers.common import Records
    from adaprox_tpu.utils.logging import read_jsonl, write_records_jsonl

    n = 3
    recs = Records(
        it=np.arange(1, n + 1), gamma=np.full(n, 0.5), sigma=np.zeros(n),
        norm_res=np.linspace(1, 0.1, n), objective=np.zeros(n),
        f_evals=np.arange(1, n + 1), grad_f_evals=np.arange(1, n + 1),
        prox_g_evals=np.arange(1, n + 1), prox_h_evals=np.zeros(n, int),
        A_evals=np.zeros(n, int), At_evals=np.zeros(n, int),
        valid=np.ones(n, bool))
    path = tmp_path / "rows.jsonl"
    write_records_jsonl(str(path), recs, "M", keys=["it", "method",
                                                    "norm_res"])
    raw = path.read_text().strip().splitlines()
    first = json.loads(raw[0])
    assert list(first.keys()) == ["it", "method", "norm_res"]
    assert [r["it"] for r in read_jsonl(path)] == [1, 2, 3]
