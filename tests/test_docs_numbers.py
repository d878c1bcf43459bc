"""Docs-vs-artifact consistency gate for the GPU figures.

``docs/PERF.md`` and the README quote numbers measured on an H100 by
``chip_smoke.py`` (``--out``) and ``benchmarks/kkt_methods.py`` (``--out``).
Those runs' JSON files are committed under ``benchmarks/results/``; this test
parses the quoted figures out of the docs and requires each to be the
artifact's value in the docs' display format, so a re-measurement that is
not carried into the docs (or a doc edit without a run) fails here.
"""
import json
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = "benchmarks/results/chip_smoke_h100.json"
FOUR = "benchmarks/results/chip_smoke_four_h100.json"
KKT = "benchmarks/results/kkt_methods_h100.json"


def _artifact(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def _doc(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def sci(v):
    """Display format of errors and deviations."""
    return f"{v:.2e}"


def rate(v):
    """Display format of solves/s."""
    return f"{v:,.0f}"


def _row(doc, first_cell):
    """Cells of the markdown table row whose first cell is ``first_cell``."""
    m = re.search(r"^\| " + re.escape(first_cell) + r" \|(.*)\|\s*$", doc,
                  re.M)
    assert m, f"no table row for {first_cell!r}"
    return [c.strip() for c in m.group(1).split("|")]


@pytest.mark.parametrize("path,count", [(SMOKE, 1), (FOUR, 4), (KKT, 1)])
def test_artifact_names_card_and_power_limit(path, count):
    art = _artifact(path)
    assert re.fullmatch(r"NVIDIA H100[^,]*, [\d.]+ W", art["card"]), art["card"]
    if path != KKT:
        assert art["device_count"] == count and art["failed"] == []
    else:
        assert all(r["device_count"] == count and r["platform"] == "gpu"
                   for r in art["rows"])


@pytest.mark.parametrize("chunk", [128, 4096])
def test_perf_e2e_row(chunk):
    row = next(r for r in _artifact(KKT)["rows"] if r["chunk"] == chunk)
    cells = _row(_doc("docs/PERF.md"), f"{chunk:,} × {row['chunks']}")
    k, s = row["pallas_solves_per_s"], row["schur_solves_per_s"]
    assert cells == [rate(k), rate(s), f"{k / s:.2f}×"]


@pytest.mark.parametrize("mu", [1.0, 1e2, 1e4, 1e7])
def test_perf_kkt_accuracy_row(mu):
    row = next(r for r in _artifact(SMOKE)["kkt"] if r["mu"] == mu)
    cells = _row(_doc("docs/PERF.md"), f"{mu:.0e}")
    assert cells == [sci(row[k]) for k in (
        "rel_err_kernel_f32", "rel_err_schur_f32", "rel_err_kernel_f64",
        "rel_err_schur_f64")]


@pytest.mark.parametrize("fixture", ["bike3_N20", "di2_N10", "quad2_N15",
                                     "round4_N40", "uni3_N20"])
def test_perf_golden_row(fixture):
    rows = {r["method"]: r for r in _artifact(SMOKE)["golden"]
            if r["fixture"] == fixture}
    cells = _row(_doc("docs/PERF.md"), f"`{fixture}`")
    it = rows["schur"]
    assert cells == [sci(rows["schur"]["max_dev_x"]),
                     sci(rows["pallas"]["max_dev_x"]),
                     f"{it['iter']} ({it['gold_iter']})"]


def test_perf_four_gpu_text():
    four = _artifact(FOUR)["four"]
    doc = _doc("docs/PERF.md")
    assert (f"converged fraction {four['converged_frac']:.4f}, largest lane "
            f"deviation {sci(four['max_lane_dev_vs_one_gpu'])}") in doc
    assert (f"{four['four_gpu_s']:.4f} s on four GPUs against "
            f"{four['one_gpu_s']:.4f} s on one") in doc


def test_perf_sweep_text():
    a = _artifact(SMOKE)
    doc = _doc("docs/PERF.md")
    assert (f"converged fraction {a['sweep_converged_frac']:.4f} over "
            f"{a['sweep_scenarios']:,} scenarios") in doc
    assert (f"{sci(a['sweep_dev_f32_at_ref_gates'])} from float64 at the "
            "reference gates") in doc
    assert f"{sci(a['sweep_dev_f32_at_bench_gates'])} at the bench" in doc


def _readme_cell(label):
    return _row(_doc("README.md"), label)[0]


def test_readme_throughput():
    row = next(r for r in _artifact(KKT)["rows"] if r["chunk"] == 128)
    assert _readme_cell("Flagship solves/s, 128 × 256, sweep kernel") == (
        f"{rate(row['pallas_solves_per_s'])} "
        f"(`schur`: {rate(row['schur_solves_per_s'])})")


def test_readme_kkt_accuracy():
    rows = _artifact(SMOKE)["kkt"]
    worst = max(r["rel_err_kernel_f32"] for r in rows)
    assert _readme_cell("Kernel float32 KKT error vs float64, worst μ") == (
        sci(worst))


def test_readme_golden():
    worst = max(r["max_dev_x"] for r in _artifact(SMOKE)["golden"]
                if r["fixture"] != "bike3_N20")
    assert _readme_cell("Golden fixtures in float64 on the card, max "
                        "deviation") == sci(worst)


def test_readme_four_gpu():
    four = _artifact(FOUR)["four"]
    assert _readme_cell("Four GPUs vs one, largest lane deviation") == sci(
        four["max_lane_dev_vs_one_gpu"])
