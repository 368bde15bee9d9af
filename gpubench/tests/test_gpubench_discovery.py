"""A configuration, a traffic mix and a metric dropped into a copy of
gpubench/ are found by name, with no code edited, and a whole CPU run of
the new cell reports the new metric."""
import json
import shutil
import subprocess
import sys

from conftest import ROOT


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cfg = json.loads((bench / "configs" / "tpch_sf10.json").read_text())
    cfg.update(name="tpch_tiny", scale_factor=0.01, rows_per_batch=1 << 14)
    (bench / "configs" / "tpch_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "q6only.json").write_text(json.dumps(
        {"why": "test", "source": "test", "loop": "closed", "clients": 2,
         "templates": {"q6": 1}}))
    (bench / "metrics" / "q6_statements.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(s.instance.template == 'q6'\n"
        "                     for s in ctx.completed()))\n")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tpch_tiny", "source": "test",
                           "file": "gpubench/configs/tpch_tiny.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tpch_tiny.q6only",
                             "config": "tpch_tiny", "traffic": "q6only",
                             "chips": 1, "why": "test"})
    doc["end_to_end"].append({"name": "q6_statements", "unit": "queries",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["tpch_tiny.q6only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    code = f"""
import json, sys, time
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})      # the engine; gpubench from the copy
from gpubench.harness import cell, spec
assert str(spec.HERE).startswith({str(tmp_path)!r}), spec.HERE
c = spec.load_cell(spec.HERE.parent, "tpch_tiny.q6only")
assert c.config["scale_factor"] == 0.01 and c.traffic["clients"] == 2
res = cell.run_cell(c, 3, 1.0, False, "cpu", time.perf_counter())
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["metrics"]["q6_statements"]["value"] > 0
    assert "queries_per_s" in res["metrics"]
