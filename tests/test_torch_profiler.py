"""The port's profiler (presto_tpu_torch/obs/profiler.py) and its
EXPLAIN ANALYZE surface: the cost verdict equals presto_tpu's on the same
stats, profile mode off records nothing, a profiled kernel call is
charged to its kernel and its operator, the CPU has no HBM story, frames
from two threads serialize, and EXPLAIN ANALYZE of TPC-H Q3 puts
``[device`` on every node where presto_tpu does, and a Verdict line."""
import re
import threading

import pytest
import torch

from presto_tpu.connectors.spi import TableHandle as JTableHandle
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.exec.stats import NodeStats as JNodeStats
from presto_tpu.exec.stats import StatsCollector as JStats
from presto_tpu.obs.profiler import cost_verdict as jcost_verdict
from presto_tpu.planner.plan import TableScanNode as JScan

from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.stats import NodeStats, StatsCollector
from presto_tpu_torch.obs import profiler
from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.ops import probe, scan
from presto_tpu_torch.planner.plan import TableScanNode

from tpch_queries import Q

_SQL = {name: sql for name, sql, _ in Q}
SF = 0.01


def _verdict_cases():
    """(name, port stats, reference stats): the same fake numbers."""
    cases = []
    for name, scan_wall, stall, compute in (
            ("compute", None, 0.0, 1.0), ("input", 2.0, 1.0, 0.5),
            ("balanced", 0.6, 0.0, 0.5), ("nothing", None, 0.0, 0.0)):
        pair = []
        for Stats, NStats, Scan, TH in (
                (StatsCollector, NodeStats, TableScanNode, TableHandle),
                (JStats, JNodeStats, JScan, JTableHandle)):
            st = Stats()
            st.prefetch_stall_s = stall
            if compute:
                st.by_node[object()] = NStats(wall_s=0.1,
                                              device_time_s=compute)
            if scan_wall is not None:
                node = Scan(fields=(), catalog="tpch",
                            table=TH("tpch", "default", "t"), columns=())
                st.by_node[node] = NStats(wall_s=scan_wall)
            pair.append(st)
        cases.append((name, *pair))
    return cases


@pytest.mark.parametrize("case", _verdict_cases(), ids=lambda c: c[0])
def test_cost_verdict_matches_reference(case):
    _, tstats, jstats = case
    got, want = profiler.cost_verdict(tstats), jcost_verdict(jstats)
    assert got == want
    if got is not None:
        assert got["verdict"] in ("input-bound", "compute-bound",
                                  "balanced")


def _segment_call():
    values = torch.arange(4096, dtype=torch.int64)
    starts = torch.tensor([0, 100, 2048, 4096], dtype=torch.int32)
    return scan.segment_sum_sorted_i64(values, starts, 4)


def test_profile_off_records_nothing():
    stats = StatsCollector()
    node = object()
    before = scan.RECORD.profiled_calls
    with profiler.operator_scope(stats, node):   # no profiled()
        _segment_call()
    assert not profiler.profiling_active()
    assert stats.device_for(node) is None
    assert stats.executables_used() == []
    assert scan.RECORD.profiled_calls == before
    # off, a launch's byte count is never computed
    assert profiler.kernel_call(
        scan.RECORD, torch.device("cpu"),
        lambda out: pytest.fail("bytes counted with profiling off"),
        lambda: 7) == 7


def test_profiled_kernel_call_attributed_to_operator():
    """A call of a kernel's wrapper under a profile context charges the
    kernel's record and the operator whose scope made it (on a CPU tensor
    the wrapper runs its plain version, timed by the host clock)."""
    stats = StatsCollector()
    node = object()
    before = (scan.RECORD.profiled_calls, scan.RECORD.plain_calls)
    with profiler.profiled(True, "cpu"), \
            profiler.operator_scope(stats, node):
        out = _segment_call()
    assert out.tolist() == [sum(range(100)), sum(range(100, 2048)),
                            sum(range(2048, 4096)), 0]
    assert scan.RECORD.profiled_calls == before[0] + 1
    assert scan.RECORD.plain_calls == before[1] + 1
    dev = stats.device_for(node)
    assert dev is not None and dev["kernel_s"] > 0.0
    assert dev["bytes"] == 8 * 4096 + 12 * 4
    used = stats.executables_used()
    assert [u["name"] for u in used] == ["segment_sum_sorted_i64"]
    assert used[0]["invocations"] == 1
    row = {r["name"]: r for r in profiler.KERNELS.snapshot()}
    assert row["segment_sum_sorted_i64"]["source"] == \
        "presto_tpu_torch/csrc/scan.cu"


def test_profiled_probe_bytes_count_live_lanes():
    """The probe's profiled bytes count the lanes this launch had: codes
    and outputs on every lane, the slot tables on live lanes (code >= 0),
    the gathers on matched lanes (cnt > 0)."""
    stats = StatsCollector()
    node = object()
    lo = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    cnt = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    vbits = torch.ones(3, dtype=torch.int32)
    payload = [torch.tensor([10, 20, 30], dtype=torch.int64)]
    codes = torch.tensor([0, 1, 2, 3, -1, 2], dtype=torch.int32)
    with profiler.profiled(True, "cpu"), \
            profiler.operator_scope(stats, node):
        got_cnt, _, outs = probe.direct_probe(codes, lo, cnt, vbits,
                                              payload)
    assert got_cnt.tolist() == [1, 1, 0, 1, 0, 0]
    assert outs[0].tolist() == [10, 20, 0, 30, 0, 0]
    live, matched = 5, 3
    assert stats.device_for(node)["bytes"] == \
        6 * (4 + 4 + 4 + 8) + 8 * live + matched * (4 + 8)


def test_frames_are_exclusive_and_serialized():
    """Frames of two threads on one device never overlap (the frame lock
    serializes them), a child's frame is subtracted from its parent's, and
    a blocking wait inside a frame releases the lock for the other
    thread."""
    stats = StatsCollector()
    parent, child, other = "parent", "child", "other"
    spans = []
    done = threading.Event()

    def worker(ctx_session):
        token = profiler._ACTIVE.set(ctx_session)
        try:
            with profiler.operator_frame(ctx_session, stats, other):
                spans.append(("other-in", threading.get_ident()))
                done.set()
        finally:
            profiler._ACTIVE.reset(token)

    with profiler.profiled(True, "cpu"):
        session = profiler.active_session()
        with profiler.operator_frame(session, stats, parent):
            with profiler.operator_frame(session, stats, child):
                t = threading.Thread(target=worker, args=(session,))
                t.start()
                # the worker cannot enter its frame while this thread
                # holds the lock ...
                assert not done.wait(0.2)
                # ... until this thread blocks on it
                with profiler.blocking():
                    assert done.wait(5.0)
                    t.join(5.0)
                assert not t.is_alive()
    assert [s[0] for s in spans] == ["other-in"]
    p, c = stats.by_node[parent], stats.by_node[child]
    # the child's frame (0.2 s of waiting) is its own, not the parent's
    assert c.device_time_s >= 0.15
    assert p.device_time_s < c.device_time_s
    assert stats.by_node[other].device_time_s >= 0.0


def test_sample_hbm_cpu_is_empty(monkeypatch):
    reg = MetricsRegistry()
    assert profiler.sample_hbm([torch.device("cpu")], registry=reg) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler.sample_hbm(registry=reg) == []
    assert profiler.hbm_totals(registry=reg) == {
        "bytesInUse": 0, "peakBytes": 0, "devices": 0}


_DEVICE = re.compile(r"\[device [\d,.]+ms")


def _lines(result):
    return [r[0] for r in result.rows]


def _plan_lines(lines):
    out = []
    for line in lines:
        if line.startswith("Total: "):
            break
        out.append(line)
    return out


@pytest.fixture(scope="module")
def q3_text():
    want = _lines(JRunner(tpch_sf=SF).execute("explain analyze "
                                              + _SQL["q3"]))
    got = _lines(LocalRunner(tpch_sf=SF, device="cpu").execute(
        "explain analyze " + _SQL["q3"]))
    return got, want


def test_explain_analyze_device_lines_match_reference(q3_text):
    """Every node that carries ``[device`` in presto_tpu carries it in
    the port. The port also times the nodes whose work presto_tpu
    dispatches outside its jit cache (scans, filters, projections): its
    frames cover every executed operator, so every plan line but the
    Output shows it."""
    got, want = q3_text
    gp, wp = _plan_lines(got), _plan_lines(want)
    assert len(gp) == len(wp)
    ref_nodes = [i for i, line in enumerate(wp) if _DEVICE.search(line)]
    assert ref_nodes, "\n".join(want)
    for i in ref_nodes:
        assert _DEVICE.search(gp[i]), gp[i]
    assert all(_DEVICE.search(line) for line in gp[1:]), "\n".join(gp)


def test_explain_analyze_sections(q3_text):
    got, want = q3_text
    text = "\n".join(got)
    assert any(line.startswith("Verdict: ") for line in got)
    assert any(line.startswith("Verdict: ") for line in want)
    assert re.search(r"Verdict: (input-bound|compute-bound|balanced) "
                     r"\(device compute [\d,.]+ms vs input [\d,.]+ms "
                     r"scan\+stall\)", text), text
    i = got.index("Kernels (this query, by device time):")
    kernels = {line.split()[0] for line in got[i + 1:i + 3]}
    assert kernels == {"segment_sum_sorted_i64", "direct_probe"}
    join = next(line for line in got if "- Join[" in line)
    assert re.search(r"\[device [\d,.]+ms, [\d,.]+[KMG]?B kernels\]", join)


def test_profile_session_property(q3_text):
    """``profile=true`` on a plain query fills the per-operator device
    account; the default leaves it empty."""
    r = LocalRunner(tpch_sf=SF, device="cpu")
    r.execute(_SQL["q6"])
    assert all(st.device_time_s == 0.0
               for st in r.last_stats.by_node.values())
    r.execute(_SQL["q6"], properties={"profile": True})
    assert sum(st.device_time_s
               for st in r.last_stats.by_node.values()) > 0.0
    assert profiler.cost_verdict(r.last_stats) is not None


def test_explain_analyze_keeps_prefetch(monkeypatch):
    """EXPLAIN ANALYZE profiles the pipeline the query runs: the scan's
    split workers still prefetch, and each batch they decode is a frame
    of the scan on the worker's thread, charged to the scan."""
    from presto_tpu_torch.exec import scancache
    frames = []
    real = profiler.operator_frame

    def spy(session, stats, node):
        frames.append((threading.current_thread().name,
                       type(node).__name__))
        return real(session, stats, node)

    monkeypatch.setattr(profiler, "operator_frame", spy)
    r = LocalRunner(tpch_sf=SF, device="cpu")
    staged0 = scancache._PREFETCH_BATCHES.value
    res = r.execute("explain analyze " + _SQL["q6"],
                    properties={"scan_cache": False, "scan_threads": 2})
    assert scancache._PREFETCH_BATCHES.value > staged0
    assert any(name.startswith("scan-prefetch-") and kind ==
               "TableScanNode" for name, kind in frames), frames
    scan_st = next(st for node, st in r.last_stats.by_node.items()
                   if isinstance(node, TableScanNode))
    assert scan_st.device_time_s > 0.0
    assert any(line[0].startswith("Verdict: ") for line in res.rows)
    want = LocalRunner(tpch_sf=SF, device="cpu").execute(_SQL["q6"])
    assert r.execute(_SQL["q6"]).rows == want.rows
