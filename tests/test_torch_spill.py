"""Two-tier spill of presto_tpu_torch (exec/spill.py, exec/pages.py,
parallel/exchange.py) against presto_tpu's on the CPU: the six queries
of tests/test_spill.py at SF 0.01 under a 200 000-byte budget (4096-row
batches, four partitions, the sort-path grouping) return presto_tpu's
rows under the same session, stay within the budget and spill; with a
50 000-byte host tier they also write disk pages and leave the spill
directory empty; unlimited, nothing spills. Pages are byte-equal to
presto_tpu's for a seeded batch of every scalar type and each side
reads the other's; partition ids equal presto_tpu's; the spilled ORDER
BY's host sort orders rows as the device sort does."""
import os

import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.batch import Batch as JBatch, Schema as JSchema
from presto_tpu.exec import pages as jpages
from presto_tpu.exec.runner import LocalRunner
from presto_tpu.parallel.exchange import hash_partition_ids as jhash
from presto_tpu_torch.exec import pages
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.exec.spill import (
    HostPartitionStore, _gather_chunks, _np_sortable, _stage_chunk,
)
from presto_tpu_torch.memory import QueryMemoryPool
from presto_tpu_torch.ops.sort import SortKey, sort_permutation
from presto_tpu_torch.parallel.exchange import hash_partition_ids

from torch_parity import assert_results_match, to_port

from test_spill import BUDGET, SPILL_QUERIES

SF = 0.01
SESSION = {"query_max_memory": BUDGET, "spill_partitions": 4,
           "dense_grouping": False}
SEED = 20261017
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def runners():
    return (LocalRunner(tpch_sf=SF, rows_per_batch=1 << 12),
            TLocalRunner(tpch_sf=SF, rows_per_batch=1 << 12, device="cpu"))


def _run_both(runners, sql, props):
    jax_runner, torch_runner = runners
    got = torch_runner.execute(sql, properties=props)
    want = jax_runner.execute(sql, properties=props)
    assert got.rows
    assert_results_match(got, want, 1e-12)
    return torch_runner.session.last_memory_stats


@pytest.mark.parametrize("i", range(len(SPILL_QUERIES)))
def test_spill_matches_reference(runners, i):
    stats = _run_both(runners, SPILL_QUERIES[i], SESSION)
    assert stats.peak_bytes <= BUDGET, stats
    assert stats.spilled_bytes > 0, stats
    assert stats.disk_spilled_bytes == 0, stats


@pytest.mark.parametrize("i", range(len(SPILL_QUERIES)))
def test_disk_spill_matches_reference(runners, i, tmp_path):
    props = dict(SESSION, spill_to_disk_bytes=50_000,
                 spill_path=str(tmp_path))
    stats = _run_both(runners, SPILL_QUERIES[i], props)
    assert stats.peak_bytes <= BUDGET, stats
    assert stats.disk_spilled_bytes > 0, stats
    assert os.listdir(tmp_path) == []


def test_no_spill_when_unlimited(runners):
    stats = _run_both(runners, SPILL_QUERIES[0], {"dense_grouping": False})
    assert stats.spilled_bytes == 0 and stats.revocations == 0


# -- pages and partition ids ---------------------------------------------------

def _seeded_batch(n=300, cap=512, vocab_shift=0):
    """A presto_tpu batch of every scalar type with NULLs, dead lanes,
    string vocabularies and long-decimal limb pairs."""
    rng = np.random.default_rng(SEED + vocab_shift)
    words = [f"w{(i * 7 + vocab_shift) % 23}" for i in range(23)]
    cols = [
        ("b", JT.BOOLEAN, rng.random(n) < 0.5),
        ("t", JT.TINYINT, rng.integers(-100, 100, n).astype(np.int8)),
        ("s", JT.SMALLINT, rng.integers(-3000, 3000, n).astype(np.int16)),
        ("i", JT.INTEGER, rng.integers(-2**31, 2**31 - 1, n,
                                       dtype=np.int64).astype(np.int32)),
        ("l", JT.BIGINT, rng.integers(-2**62, 2**62, n)),
        ("r", JT.REAL, rng.normal(0, 100, n).astype(np.float32)),
        ("d", JT.DOUBLE, rng.normal(0, 1e6, n)),
        ("dt", JT.DATE, rng.integers(0, 20000, n).astype(np.int32)),
        ("dec", JT.parse_type("decimal(12,2)"), rng.integers(-10**9, 10**9,
                                                             n)),
        ("ldec", JT.parse_type("decimal(30,2)"),
         np.stack([rng.integers(-2**40, 2**40, n),
                   rng.integers(-2**63, 2**63 - 1, n)], axis=1)),
        ("v", JT.VARCHAR, rng.integers(0, len(words), n).astype(np.int32)),
    ]
    schema = JSchema([(name, t) for name, t, _ in cols])
    arrays = [a for _, _, a in cols]
    valid = [rng.random(n) < 0.85 for _ in cols]
    dicts = [tuple(words) if t.is_string else None for _, t, _ in cols]
    b = JBatch.from_arrays(schema, arrays, valid, dicts, capacity=cap,
                           num_rows=n)
    mask = np.asarray(b.row_mask).copy()
    mask[rng.random(cap) < 0.1] = False
    return JBatch(b.schema, b.columns, mask)


def test_pages_byte_equal_to_reference():
    jb = _seeded_batch()
    tb = to_port(jb)
    for compress in (False, True):
        got = pages.serialize_page(tb, compress=compress)
        want = jpages.serialize_page(jb, compress=compress)
        assert got == want
    assert want[5] == 1                   # the compressed page
    # each side reads the other's bytes
    want_rows = sorted(map(repr, jb.to_pylist()))
    back = pages.deserialize_page(want, CPU)
    assert sorted(map(repr, back.to_pylist())) == want_rows
    jback = jpages.deserialize_page(got)
    assert sorted(map(repr, jback.to_pylist())) == want_rows
    assert pages.serialize_page(back) == want


def test_pages_small_payload_stays_raw():
    """A payload of at most 256 bytes is not compressed."""
    jb = JBatch.from_pydict({"k": (JT.BIGINT, [7, None]),
                             "p": (JT.parse_type("decimal(30,2)"),
                                   [None, 12])})
    page = pages.serialize_page(to_port(jb))
    assert page == jpages.serialize_page(jb)
    assert page[:4] == pages.MAGIC and page[5] == 0
    schema, arrays, valids, dicts, n = pages.deserialize_arrays(page)
    assert n == 2 and arrays[1].shape == (2, 2)
    assert [list(v) for v in valids] == [[True, False], [False, True]]


@pytest.mark.parametrize("cols", [[4], [7], [10], [6], [9], [3, 10, 0]],
                         ids=["bigint", "date", "varchar", "double",
                              "long_decimal", "mixed"])
@pytest.mark.parametrize("n_parts", [4, 7])
def test_partition_ids_match_reference(cols, n_parts):
    jb = _seeded_batch()
    if cols == [6]:
        # in-range doubles only: NaN and out-of-range images differ
        # between numpy and torch, and only co-location matters there
        d = np.asarray(jb.columns[6].data)
        assert np.all(np.abs(d * 65536.0) < 2**62)
    want = np.asarray(jhash(jb, cols, n_parts))
    got = hash_partition_ids(to_port(jb), cols, n_parts).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_parts


def test_string_keys_hash_values_across_vocabularies():
    """Two chunks whose string column carries different vocabularies put
    equal strings in one partition, as presto_tpu does."""
    a, b = _seeded_batch(vocab_shift=0), _seeded_batch(vocab_shift=5)
    assert a.columns[10].dictionary != b.columns[10].dictionary
    place = {}
    for jb in (a, b):
        ids = hash_partition_ids(to_port(jb), [10], 4).numpy()
        np.testing.assert_array_equal(ids, np.asarray(jhash(jb, [10], 4)))
        codes = np.asarray(jb.columns[10].data)
        valid = np.asarray(jb.columns[10].validity)
        for i in np.nonzero(valid)[0]:
            word = jb.columns[10].dictionary[codes[i]]
            assert place.setdefault(word, ids[i]) == ids[i]


def test_staged_chunks_unify_vocabularies_and_read_back():
    """A store over chunks with different vocabularies reads each
    partition back with one vocabulary, every live row exactly once."""
    chunks = [to_port(_seeded_batch(vocab_shift=s)) for s in (0, 5)]
    store = HostPartitionStore(chunks[0].schema, 3,
                               pool=QueryMemoryPool(disk_threshold=None))
    for tb in chunks:
        store.add(tb, [10])
    rows = []
    for p in range(3):
        part = store.partition_batch(p)
        rows.extend(part.to_pylist())
    store.close()
    want = [r for tb in chunks for r in tb.to_pylist()]
    assert sorted(map(repr, rows)) == sorted(map(repr, want))
    # the whole-chunk selection of _gather_chunks keeps row order
    staged = [_stage_chunk(tb) for tb in chunks]
    arrays, valids, vocabs = _gather_chunks(
        chunks[0].schema, [(ch, ch.part_rows) for ch in staged])
    assert len(arrays[0]) == len(want) and vocabs[10] is not None


@pytest.mark.parametrize("ascending,nulls_first", [
    (True, None), (False, None), (True, True), (False, False)])
def test_host_sort_orders_as_device_sort(ascending, nulls_first):
    """np.lexsort over _np_sortable's operands gives the device sort's
    permutation: descending strings by rank, doubles with -0.0 and NaN,
    long-decimal limbs, NULL ordering, stable ties."""
    jb = _seeded_batch(n=400, cap=512)
    d = np.asarray(jb.columns[6].data).copy()
    d[:12] = [0.0, -0.0, np.nan, 1.5, -1.5, np.nan, -0.0, 0.0, 2.5, 2.5,
              -np.inf, np.inf]
    cols = list(jb.columns)
    cols[6] = type(cols[6])(cols[6].type, d, cols[6].validity, None)
    tb = to_port(JBatch(jb.schema, cols, np.ones(512, dtype=bool)))
    for key_cols in ([10, 6], [6], [9, 0], [2, 10, 5]):
        keys = [SortKey(c, ascending, nulls_first) for c in key_cols]
        want = sort_permutation(tb, keys).numpy()
        operands = []
        for k in keys:
            c = tb.columns[k.column]
            operands.extend(_np_sortable(c.data.numpy(), c.validity.numpy(),
                                         c.dictionary, c.type, k))
        got = np.lexsort(tuple(reversed(operands)))
        np.testing.assert_array_equal(got, want)


def test_spilled_long_decimal_order_by_matches_device_sort(runners):
    """A spilled ORDER BY on a long-decimal key orders as the in-memory
    device sort does. presto_tpu raises here (its host sort passes the
    [n, 2] limb pairs to np.lexsort; ROADMAP.md section 3), so the port
    is held to its own unbudgeted run."""
    _, torch_runner = runners
    sql = ("select cast(o_totalprice as decimal(30,2)) p, o_orderkey "
           "from orders order by p desc, o_orderkey")
    got = torch_runner.execute(sql, properties={"query_max_memory": 30_000})
    stats = torch_runner.session.last_memory_stats
    assert stats.spilled_bytes > 0 and stats.peak_bytes <= 30_000
    want = torch_runner.execute(sql)
    assert torch_runner.session.last_memory_stats.spilled_bytes == 0
    assert got.rows == want.rows and len(got.rows) == 15_000


def test_buffers_keep_every_row_once_under_cross_thread_revocation():
    """Build and aggregation buffers of several threads share one small
    pool, so each thread's reservations revoke the others' buffers
    mid-add and mid-merge: every buffer still yields each of its rows
    exactly once."""
    import sys
    import threading

    from presto_tpu_torch import types as PT
    from presto_tpu_torch.batch import Batch, concat_batches
    from presto_tpu_torch.exec.spill import (
        AggSpillBuffer, SpillableBuildBuffer,
    )
    from presto_tpu_torch.ops.aggregation import AggSpec, grouped_aggregate

    count = [AggSpec("count_star", None, PT.BIGINT, "c")]
    n_threads, n_batches, rows = 12, 24, 200

    def batch(t, i):
        ids = [t * 100_000 + i * rows + r for r in range(rows)]
        return Batch.from_pydict({"k": (PT.BIGINT, [x % 97 for x in ids]),
                                  "id": (PT.BIGINT, ids)}, device=CPU)

    one = batch(0, 0)
    pool = QueryMemoryPool(limit_bytes=4 * (one.capacity * 19 + 256),
                           disk_threshold=None)
    results, errors = {}, []

    def work(t):
        try:
            if t % 2:
                buf = SpillableBuildBuffer(pool, f"build{t}", [0], 4)
                for i in range(n_batches):
                    buf.add(batch(t, i))
                got = buf.finish()
                if isinstance(got, HostPartitionStore):
                    parts = [got.partition_batch(p) for p in range(4)]
                    got = concat_batches([p for p in parts if p])
                results[t] = sorted(r[1] for r in got.to_pylist())
            else:
                buf = AggSpillBuffer(pool, f"agg{t}", [0], count, 4,
                                     merge_every=3, allow_dense=False)
                for i in range(n_batches):
                    buf.add_partial(grouped_aggregate(
                        batch(t, i), [0], count, mode="partial",
                        allow_dense=False))
                results[t] = sorted(r for b in buf.results()
                                    for r in b.to_pylist())
            buf.close()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for t in range(n_threads):
        ids = [t * 100_000 + i for i in range(n_batches * rows)]
        if t % 2:
            assert results[t] == ids
        else:
            want = {}
            for x in ids:
                want[x % 97] = want.get(x % 97, 0) + 1
            assert results[t] == sorted(want.items())
    assert pool.stats.revocations > 0 and pool.stats.spilled_bytes > 0
    assert pool.reserved >= 0
