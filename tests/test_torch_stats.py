"""The port's per-operator statistics and plan printer
(presto_tpu_torch/exec/stats.py, planner/printer.py): EXPLAIN prints the
same text as presto_tpu for every TPC-H query; EXPLAIN ANALYZE gives each
plan node the same live rows and batches as presto_tpu; the collector
counts exactly under threads."""
import re
import sys
import threading

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.stats import StatsCollector
from presto_tpu_torch.planner.printer import format_skew_summary

from torch_retyped import TPCH_RETYPED, assert_retyped
from tpch_queries import Q

_SQL = {name: sql for name, sql, _ in Q}
SF = 0.01
_ANALYZED = re.compile(
    r"^(?P<label>.*?)(   \[(not executed|self [\d,.]+ms, wall [\d,.]+ms, "
    r"(?P<rows>[\d,]+) rows, (?P<batches>\d+) batches)\].*)?$")


@pytest.fixture(scope="module")
def runners():
    return JRunner(tpch_sf=SF), LocalRunner(tpch_sf=SF, device="cpu")


def _text(result):
    return [r[0] for r in result.rows]


@pytest.mark.parametrize("name", [n for n, _, _ in Q])
def test_explain_text_matches_reference(runners, name):
    jr, tr = runners
    got = _text(tr.execute("explain " + _SQL[name]))
    want = _text(jr.execute("explain " + _SQL[name]))
    # the same lines, but for the integer literals the port types
    # INTEGER (tests/torch_retyped.py)
    assert_retyped(got, want, TPCH_RETYPED.get(name, ()))
    assert got[0].startswith("- Output => [")


def _node_rows(lines):
    """(label, rows, batches) per plan line, up to the Total line."""
    out = []
    for line in lines:
        if line.startswith("Total: "):
            break
        m = _ANALYZED.match(line)
        out.append((m.group("label"), m.group("rows"), m.group("batches")))
    return out


@pytest.mark.parametrize("name", ["q1", "q3", "q6"])
def test_explain_analyze_rows_match_reference(runners, name):
    jr, tr = runners
    got = _text(tr.execute("explain analyze " + _SQL[name]))
    want = _text(jr.execute("explain analyze " + _SQL[name]))
    assert _node_rows(got) == _node_rows(want)
    assert all(rows is not None for label, rows, _ in _node_rows(got)
               if not label.startswith("- Output"))
    assert any(line.startswith("Scan cache: ") for line in got)
    assert tr.last_stats.count_rows


def test_query_stats_per_node_and_split(runners):
    _, tr = runners
    rows = tr.execute(_SQL["q3"]).rows
    stats = tr.last_stats
    snap = stats.snapshot()
    kinds = [s["node"] for s in snap]
    assert kinds.count("TableScan") == 3 and kinds.count("Join") == 2
    assert all(s["rows"] is None and s["batches"] >= 1 for s in snap)
    # three tables, two splits each
    assert sorted((s["table"], s["split"]) for s in stats.splits) == [
        (t, i) for t in ("customer", "lineitem", "orders") for i in (0, 1)]
    assert stats.cache_hits + stats.cache_misses == 6
    assert len(rows) == 10
    skew = format_skew_summary(stats)
    assert skew.startswith("Skew (splits per table):")
    assert "lineitem: 2 splits" in skew


def test_wrap_counts_batches_capacity_and_rows():
    cpu = torch.device("cpu")
    batches = [Batch.from_pydict({"a": (T.BIGINT, list(range(n)))},
                                 device=cpu) for n in (5, 200, 0)]
    for count_rows, rows in ((False, 0), (True, 205)):
        stats = StatsCollector(count_rows=count_rows)
        assert list(stats.wrap("node", iter(batches))) == batches
        st = stats.stats_for("node")
        assert (st.batches, st.capacity, st.rows) == (3, 128 + 256 + 128,
                                                      rows)
        assert st.wall_s >= 0.0


def test_wrap_closes_the_wrapped_generator():
    closed = threading.Event()

    def gen():
        try:
            while True:
                yield Batch.from_pydict({"a": (T.BIGINT, [1])},
                                        device=torch.device("cpu"))
        finally:
            closed.set()

    it = StatsCollector().wrap("n", gen())
    next(it)
    it.close()
    assert closed.is_set()


def test_recorders_exact_under_threads():
    stats = StatsCollector()
    n_threads, calls = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(j):
            for i in range(calls):
                stats.record_cache(i % 2 == 0)
                stats.record_stall(0.5)
                stats.record_split("t", j, 0.0, 0.0, 1)
        ts = [threading.Thread(target=work, args=(j,))
              for j in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * calls
    assert stats.cache_hits == stats.cache_misses == total // 2
    assert stats.prefetch_stall_s == 0.5 * total
    assert len(stats.splits) == total


@pytest.mark.parametrize("sql,what", [
    ("explain (format json) select 1", "FORMAT JSON"),
    ("explain (format graphviz) select 1", "FORMAT GRAPHVIZ"),
    ("explain (type distributed) select 1", "TYPE DISTRIBUTED"),
    ("explain (type io) select 1", "TYPE IO"),
])
def test_other_explain_forms_raise(runners, sql, what):
    """EXPLAIN's other forms, which raised until the port took them, now
    print the reference's documents: JSON, Graphviz, IO, and the
    fragments of TYPE DISTRIBUTED (test_torch_statements.py and
    test_torch_fragmenter.py hold them for every TPC-H query)."""
    jr, tr = runners
    got, want = tr.execute(sql).rows, jr.execute(sql).rows
    # ``select 1``'s column, in the Output and Project nodes: integer in
    # the port, bigint in the reference (tests/torch_retyped.py); TYPE IO
    # names no type
    pairs = [] if what == "TYPE IO" else \
        [("_col0:bigint", "_col0:integer")] * 2
    if what == "FORMAT JSON":
        pairs += [("bigint", "integer")] * 2
    assert_retyped([r[0] for r in got], [r[0] for r in want], pairs)
