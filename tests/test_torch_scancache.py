"""The port's device scan cache and prefetching scan pipeline
(presto_tpu_torch/exec/scancache.py), the counterpart of
tests/test_scancache.py: warm-hit parity with presto_tpu, warm runs skip
the decode, write invalidation, eviction under a small limit, prefetcher
shutdown after LIMIT and after a worker's exception, ragged-split
padding, the metrics and the EXPLAIN ANALYZE line, and one cache per
device. The overlap tests use a fake slow connector whose margins are
several times any scheduling jitter."""
import threading
import time

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.exec.scancache import CACHE as JCACHE
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connectors.spi import (
    CatalogManager, Connector, ConnectorMetadata, ConnectorSplitManager,
    PageSource, Split, TableHandle,
)
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import scancache
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.scancache import CACHE, ScanCache, ScanOptions
from presto_tpu_torch.memory import batch_device_bytes
from presto_tpu_torch.obs.metrics import REGISTRY

from torch_parity import assert_rows_match

SF = 0.01
CPU = torch.device("cpu")


def _counter(name: str) -> float:
    return REGISTRY.counter(name).value


@pytest.fixture(autouse=True)
def fresh_cache():
    """A clean cache per test; the default limit is restored afterwards."""
    CACHE.clear()
    yield
    CACHE.clear()
    CACHE.set_limit(scancache.DEFAULT_CACHE_BYTES)


@pytest.fixture(scope="module")
def runner():
    return LocalRunner(tpch_sf=SF, device="cpu")


# -- correctness: warm hits, escape hatch, invalidation ----------------------

def test_warm_hit_parity(runner):
    q = ("select l_returnflag, count(*), sum(l_extendedprice) "
         "from lineitem group by l_returnflag order by 1")
    cold = runner.execute(q).rows
    h0 = _counter("scan_cache_hit_total")
    warm = runner.execute(q).rows
    assert warm == cold
    assert _counter("scan_cache_hit_total") > h0
    assert runner.last_stats.cache_hits == 2      # both splits replayed
    assert runner.last_stats.cache_misses == 0
    # the scan_cache=false escape hatch: same rows, no cache traffic
    h1 = _counter("scan_cache_hit_total")
    m1 = _counter("scan_cache_miss_total")
    off = runner.execute(q, properties={"scan_cache": False}).rows
    assert off == cold
    assert _counter("scan_cache_hit_total") == h1
    assert _counter("scan_cache_miss_total") == m1
    # presto_tpu, cold and warm, returns the same rows
    JCACHE.clear()
    jr = JRunner(tpch_sf=SF)
    for _ in range(2):
        assert_rows_match(warm, jr.execute(q).rows, 1e-12)


class _CountingConnector:
    """Delegate that counts page_source calls (decode work) and records
    the devices asked for."""

    def __init__(self, inner):
        self._inner = inner
        self.name = inner.name
        self.page_sources = 0
        self.devices = []

    @property
    def metadata(self):
        return self._inner.metadata

    @property
    def split_manager(self):
        return self._inner.split_manager

    def data_version(self, table):
        return self._inner.data_version(table)

    def page_source(self, split, columns, pushdown=None,
                    rows_per_batch=1 << 17, *, device=None):
        self.page_sources += 1
        self.devices.append(device)
        return self._inner.page_source(split, columns, pushdown,
                                       rows_per_batch, device=CPU)


def test_warm_run_skips_decode():
    counting = _CountingConnector(TpchConnector(sf=SF))
    catalogs = CatalogManager()
    catalogs.register("tpch", counting)
    r = LocalRunner(catalogs=catalogs, device="cpu")
    q = "select count(*), sum(o_totalprice) from orders"
    cold = r.execute(q).rows
    n_cold = counting.page_sources
    assert n_cold == 2                      # two splits, two decodes
    warm = r.execute(q).rows
    assert warm == cold
    assert counting.page_sources == n_cold  # zero new decodes
    assert counting.devices == [CPU, CPU]   # the runner's device, passed


def test_invalidation_on_insert(runner):
    runner.execute("drop table if exists memory.sc_inval")
    runner.execute("create table memory.sc_inval as "
                   "select n_nationkey, n_name from nation")
    q = "select count(*) from memory.sc_inval"
    assert runner.execute(q).rows == [(25,)]
    assert runner.execute(q).rows == [(25,)]          # warm hit
    assert runner.last_stats.cache_hits == 1
    runner.execute("insert into memory.sc_inval "
                   "select n_nationkey + 100, n_name from nation")
    # the write invalidated the cached split: the new rows are visible
    assert runner.execute(q).rows == [(50,)]
    assert runner.last_stats.cache_misses == 1
    runner.execute("drop table memory.sc_inval")


# -- eviction under a small limit --------------------------------------------

class _Obj:
    pass


def _mini_batch(n=64, device=CPU):
    return Batch.from_pydict({"x": (T.BIGINT, list(range(n)))},
                             device=device)


def test_batch_device_bytes_counts_every_tensor():
    b = _mini_batch(100)                      # capacity 128
    assert batch_device_bytes(b) == 128 * 8 + 128 + 128


def test_eviction_under_small_limit():
    b = _mini_batch()
    nbytes = batch_device_bytes(b)
    cache = ScanCache(limit_bytes=int(nbytes * 2.5))  # fits two entries
    conn = _Obj()
    th = TableHandle("c", "s", "t")
    evicted0 = _counter("scan_cache_evicted_bytes_total")
    keys = [ScanCache.key(conn, "c", Split(th, (i,)), ("x",), None, 0)
            for i in range(3)]
    for k in keys:
        assert cache.put(k, conn, [b])
    # the third insert evicted the least recently used (first) entry
    assert len(cache) == 2
    assert cache.resident_bytes <= cache.pool.limit
    assert _counter("scan_cache_evicted_bytes_total") >= evicted0 + nbytes
    assert cache.get(keys[0], conn) is None           # evicted
    assert cache.get(keys[2], conn) is not None
    # an entry that can never fit is refused outright
    big = ScanCache(limit_bytes=nbytes // 2)
    assert not big.put(keys[0], conn, [b])
    assert len(big) == 0


def test_put_refused_after_version_bump():
    """A write landing while a scan decodes must not let the scan park a
    stale (unreachable) entry under the version from before the write."""
    b = _mini_batch()
    cache = ScanCache(limit_bytes=1 << 20)

    class _Versioned:
        v = 1

        def data_version(self, table):
            return self.v

    conn = _Versioned()
    th = TableHandle("c", "s", "t")
    key = ScanCache.key(conn, "c", Split(th, (0,)), ("x",), None,
                        conn.data_version("t"))
    conn.v = 2            # a concurrent write bumped the version
    assert not cache.put(key, conn, [b])
    assert len(cache) == 0 and cache.resident_bytes == 0


def test_shrinking_limit_evicts():
    b = _mini_batch()
    nbytes = batch_device_bytes(b)
    cache = ScanCache(limit_bytes=nbytes * 4)
    conn = _Obj()
    th = TableHandle("c", "s", "t")
    for i in range(3):
        cache.put(ScanCache.key(conn, "c", Split(th, (i,)), ("x",),
                                None, 0), conn, [b])
    assert len(cache) == 3
    cache.set_limit(nbytes)
    assert len(cache) == 1
    assert cache.resident_bytes <= nbytes


def test_collected_connector_entries_never_serve():
    """An entry whose connector died is swept on the next insert, and a
    recycled id() never serves another connector's data."""
    b = _mini_batch()
    cache = ScanCache(limit_bytes=1 << 20)
    th = TableHandle("c", "s", "t")
    dead = _Obj()
    key = ScanCache.key(dead, "c", Split(th, (0,)), ("x",), None, 0)
    cache.put(key, dead, [b])
    del dead
    other = _Obj()
    # whether or not CPython reuses the address, `other` must miss
    assert cache.get(key, other) is None
    live = _Obj()
    cache.put(ScanCache.key(live, "c", Split(th, (1,)), ("x",), None, 0),
              live, [b])
    assert len(cache) == 1


# -- one cache per device -----------------------------------------------------

def test_keys_carry_the_device():
    conn = _Obj()
    split = Split(TableHandle("c", "s", "t"), (0,))
    k_cpu = ScanCache.key(conn, "c", split, ("x",), None, 0, 1 << 17, CPU)
    k_gpu = ScanCache.key(conn, "c", split, ("x",), None, 0, 1 << 17,
                          torch.device("cuda"))
    assert k_cpu != k_gpu
    assert CACHE.for_device(CPU) is CACHE.for_device("cpu")
    assert CACHE.for_device(CPU) is not CACHE.for_device("cuda")


def test_devices_neither_share_nor_evict_entries():
    """A scan on another device misses the CPU entries, generates on its
    own device, and does not evict the CPU entries even when one entry
    fills a device's whole bound."""
    counting = _CountingConnector(TpchConnector(sf=SF))
    th = TableHandle("tpch", "default", "orders")
    splits = counting.split_manager.splits(th, 1)
    opts = ScanOptions(prefetch=False)

    def scan(device):
        return sum(b.host_count() for b in scancache.scan_splits(
            counting, "tpch", ["o_orderkey"], splits, lambda: None,
            1 << 17, opts, device))

    n = scan(CPU)
    cpu_bytes = CACHE.resident_bytes(CPU)
    assert cpu_bytes > 0 and counting.page_sources == 1
    CACHE.set_limit(cpu_bytes)                 # room for one entry each
    other = torch.device("meta")
    assert scan(other) == n                    # a miss: generated again
    assert counting.page_sources == 2
    assert counting.devices == [CPU, other]
    assert CACHE.resident_bytes(other) == cpu_bytes
    assert CACHE.resident_bytes(CPU) == cpu_bytes   # not evicted
    assert scan(CPU) == n and counting.page_sources == 2   # still warm
    assert CACHE.resident_bytes() == 2 * cpu_bytes


# -- prefetcher ---------------------------------------------------------------

def _scan_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("scan-prefetch")]


def _assert_no_scan_threads():
    deadline = time.time() + 10.0
    while _scan_threads() and time.time() < deadline:
        time.sleep(0.02)
    assert not _scan_threads()


def test_prefetcher_shutdown_clean(runner):
    # full drain
    runner.execute("select count(*) from lineitem")
    _assert_no_scan_threads()
    # early abandonment (LIMIT satisfied before the scan finishes)
    rows = runner.execute("select l_orderkey from lineitem limit 3",
                          properties={"scan_threads": 2,
                                      "scan_cache": False,
                                      "scan_prefetch_depth": 1}).rows
    assert len(rows) == 3
    _assert_no_scan_threads()


class _SlowSource(PageSource):
    def __init__(self, batches, delay_s, fail=False):
        self._batches = batches
        self._delay = delay_s
        self._fail = fail

    def batches(self):
        for b in self._batches:
            time.sleep(self._delay)
            if self._fail:
                raise RuntimeError("decode failed")
            yield b


class _SlowMeta(ConnectorMetadata):
    def __init__(self, schema):
        self._schema = schema

    def list_tables(self, schema=None):
        return ["slow"]

    def table_schema(self, table):
        return self._schema


class _SlowSplits(ConnectorSplitManager):
    def __init__(self, n):
        self.n = n

    def splits(self, table, desired=1):
        return [Split(table, (i,)) for i in range(self.n)]


class _SlowConnector(Connector):
    """Fixed table, n splits of two 128-row batches, ``delay_s`` of fake
    decode per batch; split ``fail_split`` raises on its first batch."""

    name = "slow"

    def __init__(self, n_splits=4, delay_s=0.05, fail_split=None):
        self._batch = Batch.from_pydict(
            {"x": (T.BIGINT, list(range(128)))}, device=CPU)
        self._meta = _SlowMeta(self._batch.schema)
        self._splits = _SlowSplits(n_splits)
        self.delay_s = delay_s
        self.fail_split = fail_split
        self.page_sources = 0

    @property
    def metadata(self):
        return self._meta

    @property
    def split_manager(self):
        return self._splits

    def data_version(self, table):
        return 0

    def page_source(self, split, columns, pushdown=None,
                    rows_per_batch=1 << 17, *, device=None):
        self.page_sources += 1
        return _SlowSource([self._batch, self._batch], self.delay_s,
                           fail=split.info[0] == self.fail_split)


def test_warm_measurably_faster_than_cold():
    """A decode-bound scan's second run does not pay the decode again."""
    catalogs = CatalogManager()
    catalogs.register("slow", _SlowConnector(n_splits=4, delay_s=0.1))
    r = LocalRunner(catalogs=catalogs, catalog="slow", device="cpu")
    q = "select count(*) from slow"
    t0 = time.perf_counter()
    cold = r.execute(q).rows
    cold_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    warm = r.execute(q).rows
    warm_s = time.perf_counter() - t1
    assert warm == cold == [(1024,)]
    assert cold_s >= 0.4          # 4 splits x 2 batches x 0.1 s, 2 threads
    assert warm_s < cold_s * 0.5  # the warm replay skips the decode
    assert r.last_stats.cache_hits == 4


def test_prefetch_overlaps_decode():
    """With prefetch on, 4 workers overlap the split decodes; serially the
    same scan pays the sum (0.8 s against about 0.2 s)."""
    conn = _SlowConnector(n_splits=4, delay_s=0.1)
    th = TableHandle("slow", "default", "slow")
    splits = conn.split_manager.splits(th, 4)

    def drain(opts):
        t0 = time.perf_counter()
        n = sum(b.host_count() for b in scancache.scan_splits(
            conn, "slow", ["x"], splits, lambda: None, 1 << 17, opts, CPU))
        return n, time.perf_counter() - t0

    n1, serial_s = drain(ScanOptions(cache=False, prefetch=False))
    n2, overlap_s = drain(ScanOptions(cache=False, prefetch=True,
                                      threads=4, depth=2))
    assert n1 == n2 == 1024
    assert serial_s >= 0.8
    assert overlap_s < serial_s * 0.75


def test_splits_delivered_in_split_order():
    """Delivery follows split order whatever order the workers finish in:
    the first split is the slowest here."""

    class _Ordered(_SlowConnector):
        def page_source(self, split, columns, pushdown=None,
                        rows_per_batch=1 << 17, *, device=None):
            i = split.info[0]
            b = Batch.from_pydict({"x": (T.BIGINT, [i] * 4)}, device=CPU)
            return _SlowSource([b], 0.2 if i == 0 else 0.0)

    conn = _Ordered(n_splits=3)
    th = TableHandle("slow", "default", "slow")
    out = [int(b.columns[0].data[0]) for b in scancache.scan_splits(
        conn, "slow", ["x"], conn.split_manager.splits(th, 3),
        lambda: None, 1 << 17, ScanOptions(cache=False, threads=3), CPU)]
    assert out == [0, 1, 2]


def test_worker_exception_surfaces_and_threads_end():
    """A worker's decode error re-raises on the consumer, nothing of the
    failed split enters the cache, and no prefetch thread outlives the
    scan."""
    conn = _SlowConnector(n_splits=4, delay_s=0.01, fail_split=2)
    catalogs = CatalogManager()
    catalogs.register("slow", conn)
    r = LocalRunner(catalogs=catalogs, catalog="slow", device="cpu")
    with pytest.raises(RuntimeError, match="decode failed"):
        r.execute("select count(*) from slow")
    _assert_no_scan_threads()
    assert len(CACHE.for_device(CPU)) <= 3     # never the failed split


def test_shared_scan_attaches_to_inflight_decode():
    """Two concurrent scans of one split decode it once: the second
    attaches to the first's in-flight decode and replays its batches."""
    entered, release = threading.Event(), threading.Event()

    class _Gated(_SlowConnector):
        def page_source(self, split, columns, pushdown=None,
                        rows_per_batch=1 << 17, *, device=None):
            self.page_sources += 1
            entered.set()
            release.wait(30)
            return _SlowSource([self._batch], 0.0)

    conn = _Gated(n_splits=1)
    th = TableHandle("slow", "default", "slow")
    splits = conn.split_manager.splits(th, 1)
    opts = ScanOptions(threads=2)
    results = {}

    def scan(name):
        results[name] = sum(b.host_count() for b in scancache.scan_splits(
            conn, "slow", ["x"], splits, lambda: None, 1 << 17, opts, CPU))

    attach0 = _counter("scan_shared_attach_total")
    owner = threading.Thread(target=scan, args=("owner",))
    owner.start()
    assert entered.wait(30)
    rider = threading.Thread(target=scan, args=("rider",))
    rider.start()
    deadline = time.time() + 30
    while _counter("scan_shared_attach_total") == attach0 \
            and time.time() < deadline:
        time.sleep(0.01)
    release.set()
    owner.join(30)
    rider.join(30)
    assert not owner.is_alive() and not rider.is_alive()
    assert results == {"owner": 128, "rider": 128}
    assert conn.page_sources == 1
    assert _counter("scan_shared_attach_total") == attach0 + 1


# -- ragged-split padding -----------------------------------------------------

def test_ragged_final_chunk_padded():
    conn = TpchConnector(sf=SF)
    th = TableHandle("tpch", "default", "orders")
    splits = conn.split_manager.splits(th, 1)
    # rows_per_batch deliberately NOT a power of two: full chunks bucket
    # to 16384; the residual would bucket smaller without padding
    rpb = 10_000
    padded = list(scancache.scan_splits(
        conn, "tpch", ["o_orderkey"], splits, lambda: None, rpb,
        ScanOptions(cache=False, prefetch=False, pad=True), CPU))
    assert len(padded) > 1
    assert len({b.capacity for b in padded}) == 1
    raw = list(scancache.scan_splits(
        conn, "tpch", ["o_orderkey"], splits, lambda: None, rpb,
        ScanOptions(cache=False, prefetch=False, pad=False), CPU))
    assert raw[-1].capacity < raw[0].capacity          # ragged without
    assert sum(b.host_count() for b in padded) == \
        sum(b.host_count() for b in raw)               # same live rows
    tail = padded[-1]
    assert not tail.row_mask[raw[-1].capacity:].any()
    assert not tail.columns[0].validity[raw[-1].capacity:].any()


def test_batch_pad_adds_dead_lanes():
    b = _mini_batch(100)
    p = b.pad(512)
    assert p.capacity == 512 and p.host_count() == 100
    assert p.to_pylist() == b.to_pylist()
    assert b.pad(64) is b


# -- observability ------------------------------------------------------------

def test_metrics_surfaces(runner):
    runner.execute("select count(*) from region")
    runner.execute("select count(*) from region")
    by_name = {m["name"]: m["value"] for m in REGISTRY.snapshot()}
    assert {"scan_cache_hit_total", "scan_cache_miss_total",
            "scan_cache_insert_total", "scan_cache_evicted_bytes_total",
            "scan_cache_resident_bytes.cpu",
            "scan_prefetch_stall_seconds.count",
            "scan_prefetch_batches_total"} <= set(by_name)
    assert by_name["scan_cache_resident_bytes.cpu"] == \
        CACHE.resident_bytes(CPU) > 0


def test_explain_analyze_scan_cache_line(runner):
    runner.execute("select count(*) from supplier")
    out = runner.execute("explain analyze select count(*) from supplier")
    text = "\n".join(r[0] for r in out.rows)
    assert "Scan cache:" in text
    assert "2 split hits / 0 misses" in text.split("Scan cache:")[1]
