"""The port's one-query device profile
(presto_tpu_torch/_devtools/profile_query.py) against the JAX package's
tools/profile_query.py: for TPC-H q3 and q1 and TPC-DS q55 at SF 0.01 the
two documents have the same operators (labels, order, depth), the same
rows and batches per operator, the same executed join strategies and the
same cost-verdict keys; on a mesh of 4 CPU slots also the same stage
recipe and the flight recorder's bucket set. Times are not compared. The
command line prints one document on the CPU and raises without a GPU
when no device is named."""
import json

import pytest
import torch

from presto_tpu.connectors.spi import CatalogManager as JCatalogs
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch._devtools import profile_query as P
from tools import profile_query as JP

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_retyped import RETYPED, assert_retyped

SF = 0.01
ROWS_PER_BATCH = 1 << 20


def _jrunner(catalog):
    cats = JCatalogs()
    if catalog == "tpcds":
        from presto_tpu.connectors.tpcds import TpcdsConnector
        cats.register("tpcds", TpcdsConnector(sf=SF))
    else:
        from presto_tpu.connectors.tpch import TpchConnector
        cats.register("tpch", TpchConnector(sf=SF))
    return JRunner(catalogs=cats, catalog=catalog,
                   rows_per_batch=ROWS_PER_BATCH)


def _shape(doc):
    """What both documents must agree on: per operator its depth, label,
    rows, batches and join strategy, and the verdict's keys."""
    ops = [(r["depth"], r["operator"], r.get("rows"), r.get("batches"),
            r.get("join_strategy")) for r in doc["operators"]]
    return ops, sorted(doc["cost_verdict"] or {})


@pytest.mark.parametrize("name", ["q3", "q1", "q55"])
def test_profile_equals_reference(name):
    catalog, sql = P.NAMED[name]
    want = JP.profile_query(_jrunner(catalog), sql)
    got = P.profile_query(
        P.make_runner(catalog, SF, ROWS_PER_BATCH, "cpu"), sql)
    (ops, keys), (jops, jkeys) = _shape(got), _shape(want)
    assert keys == jkeys
    assert [o[:1] + o[2:] for o in ops] == [o[:1] + o[2:] for o in jops]
    # the labels, but for the integer literals the port types INTEGER
    # (tests/torch_retyped.py; q55 is that file's TPC-DS q55)
    assert_retyped([o[1] for o in ops], [o[1] for o in jops],
                   RETYPED[catalog].get(name, ()))
    assert got["sql"] == want["sql"]
    assert got["device"] == {"type": "cpu", "name": None,
                             "power_limit": None}
    assert sorted(got["cost_verdict"]) == ["compute_s", "input_s",
                                           "verdict"]
    strategies = [r["join_strategy"] for r in got["operators"]
                  if "join_strategy" in r]
    assert strategies or name == "q1"
    assert all(r["wall_s"] >= r["self_s"] >= 0.0
               for r in got["operators"] if "wall_s" in r)


def test_named_sql_equals_the_bench_texts():
    """The port keeps its own copies of bench.py's SQL."""
    import bench
    assert P.TPCH_Q1 == bench._TPCH_Q1
    assert P.DS_Q55 == bench._DS_Q55
    assert P.DS_Q27 == bench._DS_Q27
    assert P.TPCH_Q3 == JP._TPCH_Q3
    assert sorted(P.NAMED) == sorted(JP._NAMED)


def test_profile_lists_both_kernels_on_q3():
    """Q3 reaches both hand kernels through their plain versions on the
    CPU: the segment sum in its partial aggregation, the probe in its
    direct-address joins; each row has its launches and seconds."""
    doc = P.profile_query(P.make_runner("tpch", SF, 1 << 12, "cpu"),
                          P.TPCH_Q3, rows=True)
    kernels = {k["name"]: k for k in doc["kernels"]}
    assert set(kernels) == {"segment_sum_sorted_i64", "direct_probe"}
    for k in kernels.values():
        assert k["launches"] > 0 and k["device_time_s"] > 0.0
    secs = [k["device_time_s"] for k in doc["kernels"]]
    assert secs == sorted(secs, reverse=True)
    want = P.make_runner("tpch", SF, 1 << 12, "cpu").execute(
        P.TPCH_Q3).rows
    assert doc["rows"] == P._json_rows(want)


def test_mesh_profile_equals_reference(monkeypatch):
    """``--mesh 4`` on 4 CPU slots: the same operators, rows and join
    strategies as the reference's 4-device mesh, the same stage recipe,
    both routed onto the mesh, and an attribution with the recorder's
    six buckets."""
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    _, sql = P.NAMED["q3"]
    want = JP.profile_query(_jrunner("tpch"), sql, mesh=4)
    got = P.profile_query(P.make_runner("tpch", SF, ROWS_PER_BATCH, "cpu"),
                          sql, mesh=4)
    assert [(r["depth"], r["operator"]) for r in got["operators"]] == \
        [(r["depth"], r["operator"]) for r in want["operators"]]
    assert [r.get("join_strategy") for r in got["operators"]] == \
        [r.get("join_strategy") for r in want["operators"]]
    gm, wm = got["mesh"], want["mesh"]
    assert gm["stages"] == wm["stages"]
    assert (gm["n_devices"], gm["selected"], gm["supported"]) == \
        (wm["n_devices"], wm["selected"], wm["supported"]) == \
        (4, True, True)
    assert sorted(gm["attribution"]) == sorted(wm["attribution"])
    assert sorted(gm["attribution"]["buckets"]) == \
        sorted(wm["attribution"]["buckets"])
    assert any("device_time_per_shard_s" in r for r in got["operators"])


def test_command_line(tmp_path, capsys, monkeypatch):
    """One JSON document on stdout and in ``--out`` (no temporary file
    left); without ``--device`` and with no GPU it raises."""
    out = tmp_path / "prof.json"
    assert P.main(["--query", "q3", "--sf", "0.01", "--device", "cpu",
                   "--out", str(out)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == json.loads(out.read_text())
    assert doc["sf"] == 0.01 and doc["operators"]
    assert [p.name for p in tmp_path.iterdir()] == ["prof.json"]
    assert P.main(["--query", "q3", "--sql", "select 1"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(["--query", "q3", "--sf", "0.01"])


def test_smoke_tools_phase_on_the_cpu(capsys):
    """``chip_smoke.phase_tools`` rehearsed on the CPU at SF 0.01: the
    profile lists both kernels' plain versions, its rows and the 4-slot
    mesh profile's equal the CPU rows, the attribution passes
    mesh_report and the live SLO block passes slo_report."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.phase_tools(torch, device="cpu", sf=0.01,
                                 rows_per_batch=1 << 12)
    assert set(launches) == {"segment_sum_sorted_i64", "direct_probe"}
    assert min(launches.values()) > 0
    out = capsys.readouterr().out
    assert "tools kernel segment_sum_sorted_i64" in out
    assert "tools kernel direct_probe" in out
    assert '"ok": true' in out and "tools mesh profile" in out
