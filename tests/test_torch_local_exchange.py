"""The probe-side prefetch of the port's joins
(presto_tpu_torch/exec/local_exchange.py and exec/local.py's
_join_once): the same rows with it on and off and as presto_tpu, errors
of the producer thread surface on the consumer, closing joins the
producer, and the kernels' launch and plain-call counts stay exact when
a nested join's probe runs on the producer thread."""
import sys
import threading
import time

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch.connectors.spi import CatalogManager
from presto_tpu_torch.exec import local
from presto_tpu_torch.exec.local_exchange import (
    LocalExchange, exchange_source,
)
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.scancache import CACHE
from presto_tpu_torch.ops import probe, scan

from test_torch_scancache import _SlowConnector, _SlowSource
from torch_parity import assert_results_match
from tpch_queries import Q

_SQL = {name: sql for name, sql, _ in Q}
SF = 0.01
OFF = {"probe_prefetch": False}


@pytest.fixture(scope="module")
def runners():
    return JRunner(tpch_sf=SF), LocalRunner(tpch_sf=SF, device="cpu")


@pytest.mark.parametrize("name", ["q3", "q5", "q7", "q10", "q13", "q18"])
def test_prefetch_on_and_off_give_the_reference_rows(runners, name):
    jr, tr = runners
    on = tr.execute(_SQL[name])
    off = tr.execute(_SQL[name], properties=OFF)
    assert on.rows, name
    assert on.rows == off.rows
    assert_results_match(on, jr.execute(_SQL[name]), 1e-12)


def test_nested_join_probe_counts_exact_under_prefetch(runners,
                                                        monkeypatch):
    """Q3 joins lineitem to orders inside the join to customer: the outer
    join prefetches its probe side, so the inner join's probe runs on the
    producer thread. Its plain-path calls are counted exactly as with the
    prefetch off."""
    _, tr = runners
    threads = []
    plain = probe.direct_probe_plain

    def spy(*args):
        threads.append(threading.current_thread().name)
        return plain(*args)
    monkeypatch.setattr(probe, "direct_probe_plain", spy)

    def counts(props):
        before = (probe.plain_calls, scan.plain_calls, probe.launches,
                  scan.launches)
        rows = tr.execute(_SQL["q3"], properties=props).rows
        after = (probe.plain_calls, scan.plain_calls, probe.launches,
                 scan.launches)
        return rows, tuple(a - b for a, b in zip(after, before))

    rows_off, off = counts(OFF)
    assert "local-exchange-producer" not in threads
    threads.clear()
    rows_on, on = counts({})
    assert rows_on == rows_off
    assert on == off
    assert on[0] == len(threads) >= 2        # both joins probe directly
    assert on[2] == on[3] == 0               # no kernel on the CPU
    assert "local-exchange-producer" in threads
    assert threading.current_thread().name in threads


def test_launch_counters_exact_under_threads():
    """Many threads calling both wrappers at a tiny switch interval: no
    update of the plain-call counts is lost."""
    values = torch.arange(64, dtype=torch.int64)
    starts = torch.tensor([0, 10, 64, 64], dtype=torch.int32)
    codes = torch.tensor([0, 1, -1, 3], dtype=torch.int32)
    lo = torch.arange(4, dtype=torch.int32)
    cnt = torch.ones(4, dtype=torch.int32)
    vbits = torch.zeros(4, dtype=torch.int32)
    n_threads, calls = 16, 200
    before = (scan.plain_calls, probe.plain_calls)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(calls):
                scan.segment_sum_sorted_i64(values, starts, 4)
                probe.direct_probe(codes, lo, cnt, vbits, [])
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert scan.plain_calls - before[0] == n_threads * calls
    assert probe.plain_calls - before[1] == n_threads * calls


# -- the exchange itself ------------------------------------------------------

def _producers():
    return [t for t in threading.enumerate()
            if t.name == "local-exchange-producer"]


def _assert_no_producers():
    deadline = time.time() + 10.0
    while _producers() and time.time() < deadline:
        time.sleep(0.02)
    assert not _producers()


def test_producer_error_surfaces_on_the_consumer():
    def source():
        yield 1
        yield 2
        raise ValueError("upstream failed")

    ex = exchange_source(source(), "single", 1, buffer_batches=1)
    got = []
    with pytest.raises(ValueError, match="upstream failed"):
        for item in ex.consumer(0):
            got.append(item)
    assert got == [1, 2]
    ex.close()
    _assert_no_producers()


def test_close_stops_and_joins_the_producer():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    ex = exchange_source(endless(), "single", 1, buffer_batches=2)
    it = ex.consumer(0)
    assert [next(it), next(it)] == [0, 1]
    ex.close()
    assert closed.is_set()                 # the upstream was closed
    assert not ex._producer.is_alive()
    assert list(it) == []                  # the consumer ends too


@pytest.mark.parametrize("mode,want", [
    ("single", [[0, 1, 2, 3]]),
    ("broadcast", [[0, 1, 2, 3], [0, 1, 2, 3]]),
    ("round_robin", [[0, 2], [1, 3]]),
])
def test_exchange_modes(mode, want):
    ex = LocalExchange(mode, len(want), buffer_batches=8)
    for i in range(4):
        ex.push(i)
    ex.finish()
    assert [list(c) for c in ex.consumers()] == want


def test_passthrough_and_unported_modes():
    ex = LocalExchange("passthrough", 2, buffer_batches=8)
    ex.push("a", producer=1)
    ex.push("b", producer=0)
    ex.finish()
    assert [list(c) for c in ex.consumers()] == [["b"], ["a"]]
    # the hash mode is ported (test_torch_parallel.py); it needs keys
    with pytest.raises(ValueError, match="hash mode needs key columns"):
        LocalExchange("hash", 2)
    with pytest.raises(ValueError, match="unknown"):
        LocalExchange("scatter", 2)


def test_probe_side_scan_error_surfaces_through_the_join(monkeypatch):
    """A decode error on the prefetched probe side fails the query on the
    consumer, and no producer or scan thread is left behind."""
    CACHE.clear()
    started = []

    def spy(*args, **kw):
        started.append(args[1:])
        return exchange_source(*args, **kw)
    monkeypatch.setattr(local, "exchange_source", spy)

    class _FailingProbe(_SlowConnector):
        """Table ``dims`` fails in its second split; ``slow`` works."""

        def page_source(self, split, columns, pushdown=None,
                        rows_per_batch=1 << 17, *, device=None):
            fail = split.table.table == "dims" and split.info[0] == 1
            return _SlowSource([self._batch], self.delay_s, fail=fail)

    catalogs = CatalogManager()
    catalogs.register("slow", _FailingProbe(n_splits=2, delay_s=0.01))
    r = LocalRunner(catalogs=catalogs, catalog="slow", device="cpu")
    # the planner builds on the unique aggregation and probes with the
    # dims scan; without dynamic filtering that scan is prefetched
    sql = ("select count(*) from (select x, count(*) c from slow "
           "group by x) a join (select x from dims where x < 5) b "
           "on a.x = b.x")
    with pytest.raises(RuntimeError, match="decode failed"):
        r.execute(sql, properties={"enable_dynamic_filtering": False,
                                   "scan_cache": False})
    assert started == [("single", 1)]      # the probe side was prefetched
    _assert_no_producers()
    deadline = time.time() + 10.0
    while any(t.name.startswith("scan-prefetch")
              for t in threading.enumerate()) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(t.name.startswith("scan-prefetch")
                   for t in threading.enumerate())
    CACHE.clear()
