"""Each template's plain reference against the engine's own CPU run, and
the isolation of what the benchmark runs."""
import ast
import pathlib
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL
from gpubench.harness import compare, params, spec, traffic

BENCH = ROOT / "gpubench"
TEMPLATES = [(p.parent.name, p.stem)
             for p in sorted((BENCH / "queries").glob("*/*.sql"))]
SUITES = sorted({suite for suite, _ in TEMPLATES})
SEEDS = (11, 2_147_483_659, 9_000_000_001)


@pytest.fixture(scope="module")
def runners():
    from presto_tpu_torch.exec.runner import LocalRunner
    return {s: LocalRunner(catalog=s, tpch_sf=SMALL["scale_factor"],
                           device="cpu", rows_per_batch=1 << 16)
            for s in SUITES}


@pytest.fixture(scope="module")
def tables():
    return {s: spec.reference_tables(s).Data(SMALL["scale_factor"], "cpu")
            for s in SUITES}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("suite,name", TEMPLATES)
def test_reference_matches_engine_cpu(suite, name, seed, runners, tables):
    import torch
    sql, rule = spec.template(suite, name)
    ref = spec.reference(suite, name)
    r = traffic.rng(seed, "test", name)
    for p in [params.draw(rule, r) for _ in range(3)]:
        got = runners[suite].execute(params.render(sql, p)).rows
        want = ref.answer(tables[suite], p, torch.float64)
        v = compare.judge(got, want, ref.ORDER_BY)
        assert v.matched, (p, v.why)
        assert v.gap < 1e-12, (p, v.gap)
        assert got, p


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_reference_imports_nothing_of_the_engine():
    for path in (BENCH / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "presto_tpu_torch", (path, mod)


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for mod in _imports(path):
            assert mod.split(".")[0] not in {"jax", "jaxlib", "flax",
                                             "presto_tpu"}, (path, mod)


def test_a_run_leaves_no_jax_module_loaded():
    """Drive a whole run on the CPU in a fresh process and look at
    sys.modules afterwards, by top-level names."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from gpubench.harness import cell, spec
c = spec.load_cell(spec.HERE.parent, "tpch_sf10.agg")
res = cell.run_cell(c, 5, 1.0, False, "cpu", time.perf_counter(),
                    overrides={SMALL!r})
assert res["correct"], res
print("FOUND", cell.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout
