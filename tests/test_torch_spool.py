"""The port's spooled exchange (presto_tpu_torch/exec/spool.py) run
through presto_tpu's spool tests (tests/test_spool.py, all 32 of them,
on the port's stores, buffers, exchange client and CPU worker), plus a
cross-read: the page logs and object manifests one package writes are
read back, page for page, by the other, and their pages decode to the
same rows."""
import json
import os
import threading
import time
import urllib.request

import pytest

from presto_tpu_torch.exec.failpoints import FAILPOINTS
from presto_tpu_torch.exec.spool import (
    LocalDiskSpoolStore, SpoolCorruptionError, SpoolFullError,
)

SF = 0.001


@pytest.fixture(autouse=True)
def clean_failpoints():
    FAILPOINTS.clear()
    yield
    FAILPOINTS.clear()


@pytest.fixture()
def store(tmp_path):
    return LocalDiskSpoolStore(directory=str(tmp_path))


def _fill(store, qid="q1", tid="q1.0.0", n_buffers=2):
    w = store.writer(qid, tid, n_buffers)
    w.append(0, 0, b"page-zero")
    w.append(0, 1, b"page-one")
    w.append(1, 0, b"other-buffer")
    w.finish([2, 1])
    return w


# -- store round-trips --------------------------------------------------------

def test_write_read_roundtrip(store):
    _fill(store)
    assert store.finished_tokens("q1", "q1.0.0") == [2, 1]
    pages, nxt = store.read_pages("q1", "q1.0.0", 0, 0)
    assert pages == [b"page-zero", b"page-one"] and nxt == 2
    # resume mid-stream: token addressing, not offsets
    pages, nxt = store.read_pages("q1", "q1.0.0", 0, 1)
    assert pages == [b"page-one"] and nxt == 2
    pages, nxt = store.read_pages("q1", "q1.0.0", 1, 0)
    assert pages == [b"other-buffer"] and nxt == 1


def test_unfinished_task_has_no_marker(store):
    w = store.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"partial")
    assert store.finished_tokens("q1", "q1.0.0") is None
    # pages written so far are still readable (live fallback path)
    pages, nxt = store.read_pages("q1", "q1.0.0", 0, 0)
    assert pages == [b"partial"] and nxt == 1
    w.abandon()
    assert store.read_pages("q1", "q1.0.0", 0, 0)[0] == []


def test_partial_trailing_frame_ignored(store, tmp_path):
    _fill(store, n_buffers=1)
    path = store._page_path("q1", "q1.0.0", 0)
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00\x00")      # torn frame header
    pages, nxt = store.read_pages("q1", "q1.0.0", 0, 0)
    assert len(pages) == 2 and nxt == 2   # the torn tail is invisible


def test_checksum_detects_on_disk_corruption(store):
    from presto_tpu_torch.obs.metrics import REGISTRY
    _fill(store, n_buffers=1)
    path = store._page_path("q1", "q1.0.0", 0)
    data = bytearray(open(path, "rb").read())
    data[12] ^= 0xFF                      # flip a payload byte
    with open(path, "wb") as f:
        f.write(bytes(data))
    before = REGISTRY.counter("spool_corruption_total").value
    with pytest.raises(SpoolCorruptionError):
        store.read_pages("q1", "q1.0.0", 0, 0)
    assert REGISTRY.counter("spool_corruption_total").value \
        == before + 1


def test_release_query_gc_and_accounting(store):
    _fill(store, qid="qa", tid="qa.0.0")
    _fill(store, qid="qb", tid="qb.0.0")
    assert store.query_dirs() == ["qa", "qb"]
    used = store.usage()["bytes"]
    assert used > 0
    freed = store.release_query("qa")
    assert freed > 0
    assert store.query_dirs() == ["qb"]
    assert store.usage()["bytes"] == used - freed
    # idempotent: coordinator AND workers may each release
    assert store.release_query("qa") == 0
    store.release_query("qb")
    assert store.query_dirs() == [] and store.usage()["bytes"] == 0


def test_max_bytes_refuses_writes(tmp_path):
    small = LocalDiskSpoolStore(directory=str(tmp_path), max_bytes=64)
    w = small.writer("q1", "q1.0.0", 1)
    with pytest.raises(SpoolFullError):
        w.append(0, 0, b"x" * 128)
    # released space becomes writable again
    small.release_query("q1")
    big = LocalDiskSpoolStore(directory=str(tmp_path),
                              max_bytes=1 << 20)
    big.writer("q2", "q2.0.0", 1).append(0, 0, b"x" * 128)


def test_failpoint_spool_write_fails_append(store):
    FAILPOINTS.configure("spool.write", action="error",
                         message="chaos: spool write")
    w = store.writer("q1", "q1.0.0", 1)
    with pytest.raises(Exception, match="chaos: spool write"):
        w.append(0, 0, b"page")


def test_failpoint_spool_corrupt_plants_detectable_corruption(store):
    FAILPOINTS.configure("spool.corrupt", action="error", times=1)
    w = store.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"page-zero")          # corrupted on disk
    w.append(0, 1, b"page-one")           # clean (times=1)
    w.finish([2])
    with pytest.raises(SpoolCorruptionError):
        store.read_pages("q1", "q1.0.0", 0, 0)
    # later tokens remain readable
    pages, _ = store.read_pages("q1", "q1.0.0", 0, 1)
    assert pages == [b"page-one"]


# -- OutputBuffer spool replay ------------------------------------------------

def test_output_buffer_replays_acked_pages_from_spool(store):
    from presto_tpu_torch.server.worker import OutputBuffer
    w = store.writer("q1", "q1.1.0", 1)
    buf = OutputBuffer(1, spool=w)
    buf.add(0, b"p0")
    buf.add(0, b"p1")
    # first consumer generation reads + acks everything
    pages, nxt, complete = buf.get(0, 0, 0.1)
    assert pages == [b"p0", b"p1"] and nxt == 2
    pages, nxt, complete = buf.get(0, 2, 0.1)   # ack drops memory
    assert pages == [] and not complete
    assert all(not q for q in buf.pages)        # RAM is bounded
    # a re-created consumer re-reads from token 0: spool replay
    pages, nxt, complete = buf.get(0, 0, 0.1)
    assert pages == [b"p0", b"p1"] and nxt == 2
    buf.finish()
    assert buf.get(0, 2, 0.1)[2] is True


def test_output_buffer_drained_semantics(store):
    from presto_tpu_torch.server.worker import OutputBuffer
    spooled = OutputBuffer(1, spool=store.writer("q1", "q1.1.0", 1))
    spooled.add(0, b"p0")
    assert not spooled.drained()          # still running
    spooled.finish()
    assert spooled.drained()              # unread pages live in spool
    retained = OutputBuffer(1, retain=True)
    retained.add(0, b"p0")
    retained.finish()
    assert not retained.drained()         # only THIS process can serve


# -- ExchangeClient fallback --------------------------------------------------

def test_exchange_client_falls_back_to_spool(store, monkeypatch):
    """A consumer whose upstream worker is GONE drains the committed
    attempt from the spool — no retry window, no upstream re-run."""
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.batch import Batch, Schema
    from presto_tpu_torch import types as T
    from presto_tpu_torch.exec.pages import serialize_page
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.server.worker import ExchangeClient
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    schema = Schema([("x", T.BIGINT)])
    import numpy as np
    batch = Batch.from_arrays(schema, [np.arange(4, dtype=np.int64)],
                              [np.ones(4, dtype=bool)], [None],
                              num_rows=4, device="cpu")
    w = store.writer("qx", "qx.0.0", 1)
    w.append(0, 0, serialize_page(batch))
    w.finish([1])
    before = REGISTRY.counter("exchange_spool_fallback_total").value
    # port 1 refuses instantly: first transport error -> spool drain
    client = ExchangeClient(["http://127.0.0.1:1/v1/task/qx.0.0"], 0,
                            "cpu",
                            fail_fast_s=5.0)
    got = [b.to_pylist() for b in client.batches()]
    assert got == [[(0,), (1,), (2,), (3,)]]
    assert REGISTRY.counter("exchange_spool_fallback_total").value \
        == before + 1


def test_exchange_client_spool_corruption_names_upstream(store,
                                                         monkeypatch):
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.server.worker import (
        ExchangeClient, ExchangeFailedError,
    )
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    FAILPOINTS.configure("spool.corrupt", action="error", times=1)
    w = store.writer("qy", "qy.0.0", 1)
    w.append(0, 0, b"not-a-real-page")
    w.finish([1])
    client = ExchangeClient(["http://127.0.0.1:1/v1/task/qy.0.0"], 0,
                            "cpu",
                            fail_fast_s=5.0)
    with pytest.raises(ExchangeFailedError) as ei:
        list(client.batches())
    assert ei.value.task_id == "qy.0.0"   # the retry layer's pointer
    assert "spool replay" in str(ei.value)


# -- worker drain fast-exit ---------------------------------------------------

def test_drain_exits_without_waiting_for_consumers(tmp_path,
                                                   monkeypatch):
    """A draining worker whose finished task holds consumed-but-
    unfinished output EXITS within its grace; the slow consumer then
    completes from the durable spool."""
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.planner.codec import encode
    from presto_tpu_torch.server.worker import ExchangeClient, WorkerServer
    store = LocalDiskSpoolStore(directory=str(tmp_path))
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    worker = WorkerServer(tpch_sf=SF, drain_grace_s=2.0,
                          device="cpu")
    worker.start()
    try:
        lr = LocalRunner(tpch_sf=SF, device="cpu")
        plan = lr.plan("select n_regionkey, count(*) c from nation "
                       "group by n_regionkey")
        from presto_tpu_torch.planner.plan import TableScanNode

        def walk(n):
            yield n
            for c in n.children:
                yield from walk(c)
        scan = next(n for n in walk(plan.root)
                    if isinstance(n, TableScanNode))
        conn = lr.session.catalogs.get("tpch")
        splits = conn.split_manager.splits(scan.table, 1)
        doc = {"fragment": encode(plan.root),
               "output": {"kind": "single", "n_buffers": 1,
                          "spool": True},
               "splits": [encode(s) for s in splits], "sources": {}}
        url = f"http://127.0.0.1:{worker.port}"
        req = urllib.request.Request(f"{url}/v1/task/qd.0.0",
                                     method="PUT",
                                     data=json.dumps(doc).encode())
        with urllib.request.urlopen(req, timeout=10):
            pass
        deadline = time.time() + 20
        while worker.tasks["qd.0.0"].state != "FINISHED":
            assert time.time() < deadline
            time.sleep(0.05)
        # NO consumer has pulled a single page; drain must still exit
        t0 = time.monotonic()
        worker.begin_shutdown()
        while time.monotonic() - t0 < 5.0:
            try:
                with urllib.request.urlopen(f"{url}/v1/info",
                                            timeout=1):
                    pass
            except Exception:
                break
            time.sleep(0.05)
        exit_s = time.monotonic() - t0
        assert exit_s < 4.0, \
            f"drained worker lingered {exit_s:.1f}s"
        # the consumer that shows up AFTER the exit drains the spool
        client = ExchangeClient([f"{url}/v1/task/qd.0.0"], 0, "cpu",
                                fail_fast_s=5.0)
        rows = [r for b in client.batches() for r in b.to_pylist()]
        assert len(rows) == 5             # nation has 5 region keys
    finally:
        try:
            worker.stop()
        except Exception:
            pass


# -- retry backoff jitter -----------------------------------------------------

def test_backoff_jitter_spreads_retries():
    from presto_tpu_torch.server.worker import jittered
    samples = {jittered(1.0) for _ in range(64)}
    assert all(0.5 <= s <= 1.5 for s in samples)
    assert len(samples) > 32              # not deterministic


# -- config wiring ------------------------------------------------------------

def test_node_config_spool_keys(tmp_path):
    from presto_tpu_torch.config import NodeConfig, parse_properties
    etc = tmp_path / "config.properties"
    etc.write_text("spool.dir=/var/spool/presto\n"
                   "spool.max-bytes=1073741824\n")
    cfg = NodeConfig(parse_properties(str(etc)))
    assert cfg.spool_dir == "/var/spool/presto"
    assert cfg.spool_max_bytes == 1 << 30


def test_spool_store_configure(tmp_path):
    st = LocalDiskSpoolStore()
    st.configure(directory=str(tmp_path / "sp"), max_bytes=123)
    assert st.max_bytes == 123
    assert st.directory == str(tmp_path / "sp")


def test_spool_session_property_registered():
    from presto_tpu_torch.config import validate_session_property
    assert validate_session_property("spool_exchange", "false") is False
    with pytest.raises(Exception):
        validate_session_property("spool_exchang", True)


# -- the object-store backend  --------------------------------------

@pytest.fixture()
def obj(tmp_path):
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    return ObjectSpoolStore(directory=str(tmp_path / "bucket"))


def _counter(name: str) -> float:
    from presto_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.counter(name).value


def test_object_store_roundtrip_and_manifest_commit(obj):
    """Pages upload as content-addressed blobs immediately; the
    attempt becomes visible to OTHER processes only when the manifest
    commits — but the owning process reads its uncommitted pages
    through the live index the whole time."""
    w = obj.writer("q1", "q1.0.0", 2)
    w.append(0, 0, b"page-zero")
    w.append(0, 1, b"page-one")
    w.append(1, 0, b"other-buffer")
    # uncommitted: no completion marker, live index still serves
    assert obj.finished_tokens("q1", "q1.0.0") is None
    pages, nxt = obj.read_pages("q1", "q1.0.0", 0, 0)
    assert pages == [b"page-zero", b"page-one"] and nxt == 2
    w.finish([2, 1])
    assert obj.finished_tokens("q1", "q1.0.0") == [2, 1]
    # token addressing, mid-stream resume
    pages, nxt = obj.read_pages("q1", "q1.0.0", 0, 1)
    assert pages == [b"page-one"] and nxt == 2
    pages, nxt = obj.read_pages("q1", "q1.0.0", 1, 0)
    assert pages == [b"other-buffer"] and nxt == 1


def test_object_store_survives_scale_to_zero(obj, tmp_path):
    """A committed attempt is readable by a PROCESS THAT NEVER WROTE
    IT (fresh store over the same bucket): every worker that produced
    the data can be gone — the scale-to-zero contract."""
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    w = obj.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"durable-page")
    w.finish([1])
    fresh = ObjectSpoolStore(directory=str(tmp_path / "bucket"))
    assert fresh.finished_tokens("q1", "q1.0.0") == [1]
    pages, nxt = fresh.read_pages("q1", "q1.0.0", 0, 0)
    assert pages == [b"durable-page"] and nxt == 1


def test_object_store_content_addressed_dedup(obj):
    """Identical payloads (broadcast pages fanned to every consumer
    buffer) store ONE blob: dedup counted, bytes charged once."""
    dedup0 = _counter("spool_object_dedup_total")
    w = obj.writer("q1", "q1.0.0", 3)
    payload = b"broadcast-page" * 16
    for buf in range(3):
        w.append(buf, 0, payload)
    w.finish([1, 1, 1])
    assert _counter("spool_object_dedup_total") == dedup0 + 2
    blob_dir = os.path.join(obj.directory, "q1", "blobs")
    assert len(os.listdir(blob_dir)) == 1
    # accounting charges the blob once plus the manifest — never the
    # 3x a per-reference charge would cost
    assert obj.usage()["bytes"] < 3 * len(payload)
    for buf in range(3):
        pages, _ = obj.read_pages("q1", "q1.0.0", buf, 0)
        assert pages == [payload]


def test_object_torn_manifest_is_uncommitted_not_corrupt(obj):
    """A torn/garbled manifest upload is an UNCOMMITTED attempt —
    readers keep their normal retry semantics, nothing raises."""
    w = obj.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"page")
    path = obj._manifest_path("q1", "q1.0.0", create=True)
    with open(path, "wb") as f:
        f.write(b'{"tok')                 # torn mid-upload
    assert obj.finished_tokens("q1", "q1.0.0") is None
    with open(path, "wb") as f:
        f.write(b'{"no_tokens_key": 1}')  # garbled
    assert obj.finished_tokens("q1", "q1.0.0") is None


def test_object_corruption_is_attributed_to_the_page(obj):
    """The planted-corruption contract carries over from the disk
    backend: digest/crc are of the CLEAN page, so the read side names
    the exact page that failed its checksum."""
    FAILPOINTS.configure("spool.corrupt", action="error", times=1)
    w = obj.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"page-to-corrupt")
    w.finish([1])
    before = _counter("spool_corruption_total")
    with pytest.raises(SpoolCorruptionError, match=r"b0/t0"):
        obj.read_pages("q1", "q1.0.0", 0, 0)
    assert _counter("spool_corruption_total") == before + 1


def test_object_missing_blob_is_corruption(obj):
    """A manifest referencing a vanished blob is a damaged copy, not
    a retryable miss — the consumer must re-run the producer."""
    w = obj.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"page")
    w.finish([1])
    import hashlib
    digest = hashlib.sha256(b"page").hexdigest()[:32]
    os.unlink(obj._blob_path("q1", digest))
    with pytest.raises(SpoolCorruptionError, match="unreadable"):
        obj.read_pages("q1", "q1.0.0", 0, 0)


def test_object_release_query_gc_zero_orphans(obj):
    w = obj.writer("qa", "qa.0.0", 1)
    w.append(0, 0, b"qa-page")
    w.finish([1])
    w = obj.writer("qb", "qb.0.0", 1)
    w.append(0, 0, b"qb-page")
    w.finish([1])
    assert obj.query_dirs() == ["qa", "qb"]
    used = obj.usage()["bytes"]
    freed = obj.release_query("qa")
    assert freed > 0
    assert obj.query_dirs() == ["qb"]
    assert obj.usage()["bytes"] == used - freed
    assert obj.release_query("qa") == 0          # idempotent
    obj.release_query("qb")
    assert obj.query_dirs() == []
    assert obj.usage()["bytes"] == 0             # zero orphans


def test_object_abandon_respects_shared_blob_refcounts(obj):
    """Two attempts of one query share a dedup'd blob: abandoning one
    keeps the blob for the survivor; abandoning both deletes it."""
    shared = b"shared-payload" * 8
    w1 = obj.writer("q1", "q1.0.0", 1)
    w1.append(0, 0, shared)
    w2 = obj.writer("q1", "q1.0.1", 1)
    w2.append(0, 0, shared)
    import hashlib
    blob = obj._blob_path(
        "q1", hashlib.sha256(shared).hexdigest()[:32])
    w1.abandon()
    assert os.path.exists(blob)                  # w2 still references
    pages, _ = obj.read_pages("q1", "q1.0.1", 0, 0)
    assert pages == [shared]
    w2.abandon()
    assert not os.path.exists(blob)
    assert obj.usage()["bytes"] == 0


def test_object_max_bytes_refuses_puts(tmp_path):
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    small = ObjectSpoolStore(directory=str(tmp_path / "b"),
                             max_bytes=64)
    w = small.writer("q1", "q1.0.0", 1)
    with pytest.raises(SpoolFullError):
        w.append(0, 0, b"x" * 128)
    small.release_query("q1")
    w = small.writer("q2", "q2.0.0", 1)
    w.append(0, 0, b"x" * 32)                    # freed space reusable


def test_object_failpoints_cover_both_directions(obj):
    from presto_tpu_torch.exec.failpoints import FailpointError
    FAILPOINTS.configure("spool.object_put", action="error", times=1,
                         message="chaos: object put")
    w = obj.writer("q1", "q1.0.0", 1)
    with pytest.raises(FailpointError, match="object put"):
        w.append(0, 0, b"page")
    FAILPOINTS.clear()
    w.append(0, 0, b"page")
    w.finish([1])
    FAILPOINTS.configure("spool.object_get", action="error", times=1,
                         message="chaos: object get")
    with pytest.raises(FailpointError, match="object get"):
        obj.read_pages("q1", "q1.0.0", 0, 0)


def test_object_latency_bandwidth_model(tmp_path):
    """The modeled round trip really costs wall time (latency +
    size/bandwidth) and lands in the RTT histogram."""
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    st = ObjectSpoolStore(directory=str(tmp_path / "b"),
                          get_latency_s=0.05,
                          bandwidth_bytes_per_s=1e6)
    w = st.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"x" * 100_000)
    w.finish([1])
    st._manifests.clear()                 # force the wire path
    t0 = time.monotonic()
    pages, _ = st.read_pages("q1", "q1.0.0", 0, 0)
    dt = time.monotonic() - t0
    assert pages == [b"x" * 100_000]
    # one manifest get + one 100kB blob get: >= 2x latency + 0.1s
    assert dt >= 0.15, f"modeled RTT not paid ({dt:.3f}s)"


def test_facade_backend_switch_and_config(tmp_path):
    from presto_tpu_torch.exec.spool import SwitchableSpoolStore
    sw = SwitchableSpoolStore()
    sw.configure(directory=str(tmp_path / "local"),
                 object_dir=str(tmp_path / "bucket"),
                 backend="object", object_put_latency_s=0.0,
                 object_get_latency_s=0.0, object_bandwidth_mbps=0.0)
    assert sw.backend == "object"
    w = sw.writer("q1", "q1.0.0", 1)
    w.append(0, 0, b"page")
    w.finish([1])
    assert sw.finished_tokens("q1", "q1.0.0") == [1]
    assert (tmp_path / "bucket" / "q1").is_dir()
    with pytest.raises(ValueError, match="local or object"):
        sw.configure(backend="s3")
    sw.configure(backend="local")
    assert sw.backend == "local"


# -- speculative reads: replay vs live, both outcomes -------------------------

def _committed_page_store(store, qid, tid):
    import numpy as np
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Schema
    from presto_tpu_torch.exec.pages import serialize_page
    schema = Schema([("x", T.BIGINT)])
    batch = Batch.from_arrays(schema, [np.arange(4, dtype=np.int64)],
                              [np.ones(4, dtype=bool)], [None],
                              num_rows=4, device="cpu")
    page = serialize_page(batch)
    w = store.writer(qid, tid, 1)
    w.append(0, 0, page)
    w.finish([1])
    return page


def test_speculative_replay_wins_when_live_stays_dead(tmp_path,
                                                      monkeypatch):
    """Producer truly gone (port refuses, the spec_live failpoint
    keeps the resumed pull dead): the object-store replay wins the
    race and the consumer gets every row."""
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    from presto_tpu_torch.server.worker import ExchangeClient
    store = ObjectSpoolStore(directory=str(tmp_path / "bucket"))
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    _committed_page_store(store, "qs", "qs.0.0")
    FAILPOINTS.configure("exchange.spec_live", action="error",
                         message="chaos: live pull down")
    reads0 = _counter("exchange_speculative_read_total")
    won0 = _counter("exchange_speculative_replay_won_total")
    client = ExchangeClient(["http://127.0.0.1:1/v1/task/qs.0.0"], 0,
                            "cpu",
                            fail_fast_s=5.0)
    got = [b.to_pylist() for b in client.batches()]
    assert got == [[(0,), (1,), (2,), (3,)]]
    assert _counter("exchange_speculative_read_total") == reads0 + 1
    assert _counter("exchange_speculative_replay_won_total") == won0 + 1


def test_speculative_live_wins_when_replay_is_slow(tmp_path,
                                                   monkeypatch):
    """Producer merely restarting: the live pull completes while the
    object-store replay is still paying its modeled round trips — the
    live arm wins and the replay is cancelled."""
    import http.server
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    from presto_tpu_torch.server.worker import ExchangeClient, frame_pages
    store = ObjectSpoolStore(directory=str(tmp_path / "bucket"))
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    page = _committed_page_store(store, "ql", "ql.0.0")

    class Upstream(http.server.BaseHTTPRequestHandler):
        def do_GET(self):              # noqa: N802 (stdlib casing)
            body = frame_pages([page])
            self.send_response(200)
            self.send_header("X-Buffer-Complete", "true")
            self.send_header("X-Next-Token", "1")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Upstream)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = (f"http://127.0.0.1:{httpd.server_address[1]}"
               "/v1/task/ql.0.0")
        FAILPOINTS.configure("exchange.spec_replay", action="sleep",
                             sleep_s=1.5)
        won0 = _counter("exchange_speculative_live_won_total")
        client = ExchangeClient([url], 0, "cpu", fail_fast_s=5.0)
        assert client._race_spool(url, "ql.0.0", 0) is True
        assert _counter("exchange_speculative_live_won_total") \
            == won0 + 1
        assert client.queue.get_nowait() == page
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_speculative_disabled_session_property_drains_serially(
        tmp_path, monkeypatch):
    """``speculative_spool_reads=false`` falls back to the plain
    serial spool drain — no race, no speculative counters."""
    import presto_tpu_torch.exec.spool as spool_mod
    from presto_tpu_torch.exec.spool import ObjectSpoolStore
    from presto_tpu_torch.server.worker import ExchangeClient
    store = ObjectSpoolStore(directory=str(tmp_path / "bucket"))
    monkeypatch.setattr(spool_mod, "SPOOL", store)
    page = _committed_page_store(store, "qn", "qn.0.0")
    reads0 = _counter("exchange_speculative_read_total")
    client = ExchangeClient(["http://127.0.0.1:1/v1/task/qn.0.0"], 0,
                            "cpu",
                            fail_fast_s=5.0, speculative=False)
    assert client._race_spool("http://127.0.0.1:1/v1/task/qn.0.0",
                              "qn.0.0", 0) is True
    assert _counter("exchange_speculative_read_total") == reads0
    assert client.queue.get_nowait() == page


# -- cross-read: one package writes, the other reads --------------------------

def _pages():
    """Three wire pages of a seeded batch, encoded by the port (the
    format is byte for byte the reference's)."""
    import numpy as np
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Schema
    from presto_tpu_torch.exec.pages import serialize_page
    rng = np.random.default_rng(13)
    schema = Schema([("k", T.BIGINT), ("v", T.DOUBLE), ("s", T.VARCHAR)])
    out = []
    for n in (5, 300, 1):
        b = Batch.from_arrays(
            schema, [rng.integers(-9, 9, n).astype(np.int64),
                     rng.normal(size=n),
                     rng.integers(0, 3, n).astype(np.int32)],
            [rng.random(n) > 0.2 for _ in range(3)],
            [None, None, ("a", "bb", "ccc")], num_rows=n, device="cpu")
        out.append((serialize_page(b), b.to_pylist()))
    return out


def _stores(kind, directory):
    import presto_tpu.exec.spool as jspool
    import presto_tpu_torch.exec.spool as tspool
    if kind == "local":
        return (tspool.LocalDiskSpoolStore(directory=directory),
                jspool.LocalDiskSpoolStore(directory=directory))
    return (tspool.ObjectSpoolStore(directory=directory),
            jspool.ObjectSpoolStore(directory=directory))


@pytest.mark.parametrize("kind", ["local", "object"])
@pytest.mark.parametrize("writer_is_port", [True, False],
                         ids=["port_writes", "reference_writes"])
def test_cross_read_between_packages(tmp_path, kind, writer_is_port):
    """Page logs (and object manifests) written by one package read back
    page for page in the other; each page decodes to the same rows in
    both packages."""
    from presto_tpu.exec.pages import deserialize_page as jdecode
    from presto_tpu_torch.exec.pages import deserialize_page
    port, ref = _stores(kind, str(tmp_path / "spool"))
    writer, reader = (port, ref) if writer_is_port else (ref, port)
    pages = _pages()
    w = writer.writer("qc", "qc.1.0.a1", 2)
    for t, (page, _) in enumerate(pages):
        w.append(t % 2, t // 2, page)
    w.finish([2, 1])
    assert reader.finished_tokens("qc", "qc.1.0.a1") == [2, 1]
    got0, nxt0 = reader.read_pages("qc", "qc.1.0.a1", 0, 0)
    got1, nxt1 = reader.read_pages("qc", "qc.1.0.a1", 1, 0)
    assert (nxt0, nxt1) == (2, 1)
    assert got0 == [pages[0][0], pages[2][0]] and got1 == [pages[1][0]]
    for page, rows in pages:
        assert deserialize_page(page, "cpu").to_pylist() == rows
        assert jdecode(page).to_pylist() == rows
    assert reader.release_query("qc") >= 0
    assert writer.release_query("qc") >= 0
    assert not os.listdir(str(tmp_path / "spool"))


def test_cross_read_detects_the_other_packages_corruption(tmp_path):
    """A corruption planted through the reference's ``spool.corrupt``
    site fails the port's checksum on read, and the other way round."""
    from presto_tpu.exec.failpoints import FAILPOINTS as JFAILPOINTS
    from presto_tpu.exec.spool import SpoolCorruptionError as JCorrupt
    port, ref = _stores("local", str(tmp_path / "spool"))
    page = _pages()[0][0]
    for writer, reader, fps, err in (
            (ref, port, JFAILPOINTS, SpoolCorruptionError),
            (port, ref, FAILPOINTS, JCorrupt)):
        fps.configure("spool.corrupt", action="error", times=1)
        try:
            w = writer.writer("qz", "qz.0.0", 1)
            w.append(0, 0, page)
            w.finish([1])
        finally:
            fps.clear()
        with pytest.raises(err, match="failed checksum"):
            reader.read_pages("qz", "qz.0.0", 0, 0)
        writer.release_query("qz")
        reader.release_query("qz")
