"""The port's Parquet reader, writer and connector
(presto_tpu_torch/formats/parquet.py, connectors/parquet.py) held against
presto_tpu's on the same files, in the shapes of tests/test_parquet.py:
dictionary pages, gzip, multiple pages, nanosecond timestamps, all-null
columns, row-group pruning, the own writer's bytes and pyarrow's reading
of them. Every decode is exact (doubles bit for bit)."""
import datetime

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from presto_tpu import types as JT  # noqa: E402
from presto_tpu.batch import Batch as JBatch, Schema as JSchema  # noqa: E402
from presto_tpu.connectors.parquet import ParquetConnector as JParquet  # noqa: E402
from presto_tpu.connectors.spi import CatalogManager as JCatalogs  # noqa: E402
from presto_tpu.exec.runner import LocalRunner as JRunner  # noqa: E402
from presto_tpu.formats.parquet import (  # noqa: E402
    ParquetReader as JReader, write_parquet as jwrite_parquet,
)

from presto_tpu_torch import types as T  # noqa: E402
from presto_tpu_torch.batch import Schema  # noqa: E402
from presto_tpu_torch.connectors.parquet import ParquetConnector  # noqa: E402
from presto_tpu_torch.connectors.spi import CatalogManager, TableHandle  # noqa: E402
from presto_tpu_torch.exec.runner import LocalRunner  # noqa: E402
from presto_tpu_torch.formats import decodestats  # noqa: E402
from presto_tpu_torch.formats.parquet import (  # noqa: E402
    ParquetReader, decode_hybrid_device, write_parquet,
    write_parquet_batches,
)

from torch_parity import (  # noqa: E402
    assert_batches_equal, assert_results_match, to_port,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("parquet")
    table = pa.table({
        "a": pa.array([1, 2, None, 4], type=pa.int64()),
        "b": pa.array(["x", "y", "x", None]),
        "c": pa.array([1.5, None, 2.5, 3.5], type=pa.float64()),
        "d": pa.array([datetime.date(2020, 1, 1), None,
                       datetime.date(2021, 2, 3),
                       datetime.date(2022, 3, 4)]),
        "t": pa.array([datetime.datetime(2020, 1, 1, 12, 30), None,
                       datetime.datetime(2021, 1, 1),
                       datetime.datetime(2022, 5, 6, 7, 8, 9)],
                      type=pa.timestamp("us")),
    })
    pq.write_table(table, str(d / "small.parquet"), compression="NONE",
                   version="1.0")
    pq.write_table(table, str(d / "gz.parquet"), compression="GZIP",
                   use_dictionary=False, version="1.0")
    rng = np.random.RandomState(7)
    n = 50_000
    big = pa.table({
        "k": pa.array(rng.randint(0, 100, n), type=pa.int64()),
        "v": pa.array(rng.rand(n)),
        "s": pa.array([f"tag{int(i)}" for i in rng.randint(0, 50, n)]),
        "i": pa.array(rng.randint(-1000, 1000, n), type=pa.int32()),
        "f": pa.array(rng.rand(n).astype(np.float32)),
        "ok": pa.array(rng.rand(n) < 0.5),
    })
    pq.write_table(big, str(d / "big.parquet"), compression="NONE",
                   row_group_size=16_384, version="1.0")
    return d


def _pair(path, cols):
    """(reference batches, port batches) of one file."""
    return (list(JReader(str(path)).batches(cols)),
            list(ParquetReader(str(path)).batches(cols, device=CPU)))


def _assert_same(path, cols):
    jb, tb = _pair(path, cols)
    assert len(jb) == len(tb) >= 1
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
    return [r for b in tb for r in b.to_pylist()]


def test_schema_mapping(fixture_dir):
    r = ParquetReader(str(fixture_dir / "small.parquet"))
    got = {f.name: f.type.display() for f in r.schema.fields}
    assert got == {f.name: f.type.display() for f in
                   JReader(str(fixture_dir / "small.parquet"))
                   .schema.fields}
    assert got == {"a": "bigint", "b": "varchar", "c": "double",
                   "d": "date", "t": "timestamp"}


def test_pyarrow_dictionary_pages(fixture_dir):
    rows = _assert_same(fixture_dir / "small.parquet",
                        ["a", "b", "c", "d", "t"])
    assert rows[0] == (1, "x", 1.5, datetime.date(2020, 1, 1),
                       datetime.datetime(2020, 1, 1, 12, 30))
    assert rows[1][1] == "y" and rows[1][2] is None and rows[1][3] is None
    assert rows[3][1] is None


def test_gzip_plain_pages(fixture_dir):
    rows = _assert_same(fixture_dir / "gz.parquet", ["a", "b", "c"])
    assert [r[0] for r in rows] == [1, 2, None, 4]
    assert [r[1] for r in rows] == ["x", "y", "x", None]


def test_big_file_matches_reference_and_pyarrow(fixture_dir):
    path = fixture_dir / "big.parquet"
    want = pq.read_table(str(path)).to_pydict()
    rows = _assert_same(path, ["k", "v", "s", "i", "f", "ok"])
    assert len(rows) == len(want["k"])
    for j, name in enumerate(["k", "v", "s", "i", "f", "ok"]):
        assert [r[j] for r in rows] == want[name], name


def test_hybrid_decode_matches_reference(fixture_dir):
    """The device expansion of the dictionary indices equals the
    reference's on bit-packed and RLE runs."""
    from presto_tpu.formats.parquet import decode_hybrid_device as jdec
    rng = np.random.RandomState(1)
    for width in (1, 3, 7, 12, 20):
        vals = rng.randint(0, 1 << width, 1000)
        vals[100:400] = vals[100]             # an RLE-friendly stretch
        t = pa.table({"x": pa.array(vals.astype(np.int64))})
        path = str(fixture_dir / f"w{width}.parquet")
        pq.write_table(t, path, compression="NONE", version="1.0")
        _assert_same(path, ["x"])
    # a hand-made stream: bit-packed groups then an RLE run
    data = bytes([(2 << 1) | 1]) + bytes(range(16 * 5 // 8)) \
        + bytes([10 << 1, 3])
    want = np.asarray(jdec(data, 26, 5, 128))[:26]
    got = decode_hybrid_device(data, 26, 5, 128, device=CPU)
    assert np.array_equal(got.numpy()[:26], want)


def test_row_group_pruning(fixture_dir):
    r = ParquetReader(str(fixture_dir / "big.parquet"))
    assert len(r.row_groups) > 1
    pruned0 = decodestats.PARQUET_GROUPS_PRUNED.value
    assert list(r.batches(["k"], pushdown=[("k", 1000, None)],
                          device=CPU)) == []
    assert decodestats.PARQUET_GROUPS_PRUNED.value - pruned0 == \
        len(r.row_groups)
    total = sum(b.host_count()
                for b in r.batches(["k"], pushdown=[("k", 0, 99)],
                                   device=CPU))
    assert total == r.num_rows


def test_multipage_dictionary_with_nulls(tmp_path):
    n = 20_000
    vals = [f"tag{i % 37}" if i % 7 else None for i in range(n)]
    p = tmp_path / "mp.parquet"
    pq.write_table(pa.table({"s": pa.array(vals)}), str(p),
                   compression="NONE", version="1.0", data_page_size=1024)
    rows = _assert_same(p, ["s"])
    assert [r[0] for r in rows] == vals


def test_multipage_plain_strings(tmp_path):
    n = 5_000
    vals = [f"val{i}" for i in range(n)]
    p = tmp_path / "plain.parquet"
    pq.write_table(pa.table({"s": pa.array(vals)}), str(p),
                   compression="NONE", version="1.0",
                   use_dictionary=False, data_page_size=1024)
    rows = _assert_same(p, ["s"])
    assert [r[0] for r in rows] == vals


def test_nanosecond_timestamps_logical_only(tmp_path):
    ts = [datetime.datetime(2020, 1, 1, 12, 0, 0, 123456),
          datetime.datetime(2021, 6, 5, 4, 3, 2, 999000)]
    p = tmp_path / "ns.parquet"
    pq.write_table(pa.table({"t": pa.array(ts, type=pa.timestamp("ns"))}),
                   str(p), compression="NONE", version="2.6")
    assert ParquetReader(str(p)).schema.fields[0].type.display() == \
        "timestamp"
    rows = _assert_same(p, ["t"])
    assert [r[0] for r in rows] == ts


def test_all_null_column(tmp_path):
    p = tmp_path / "nulls.parquet"
    pq.write_table(pa.table({"a": pa.array([None] * 3, type=pa.int64()),
                             "b": pa.array([1, 2, 3])}),
                   str(p), compression="NONE", version="1.0")
    assert _assert_same(p, ["a", "b"]) == [(None, 1), (None, 2), (None, 3)]


def test_empty_table_dir_is_unknown_table(tmp_path):
    (tmp_path / "emptytab").mkdir()
    conn = ParquetConnector(str(tmp_path))
    with pytest.raises(KeyError, match="emptytab"):
        conn.metadata.table_schema(TableHandle("pq", "d", "emptytab"))
    assert conn.metadata.list_tables() == []


_WRITE_TYPES = [("a", "BIGINT"), ("b", "VARCHAR"), ("e", "BOOLEAN"),
                ("d", "DATE"), ("x", "DOUBLE"), ("i", "INTEGER"),
                ("m", "DecimalType(10, 2)")]


def _write_values(n: int, seed: int):
    rng = np.random.RandomState(seed)

    def maybe(vals, every):
        return [None if i % every == 0 else v for i, v in enumerate(vals)]
    return [
        maybe([int(v) for v in rng.randint(-10**12, 10**12, n)], 5),
        maybe([f"s{int(v)}" for v in rng.randint(0, 60, n)], 7),
        maybe([bool(v) for v in rng.rand(n) < 0.4], 3),
        maybe([datetime.date(1992, 1, 1) + datetime.timedelta(days=int(v))
               for v in rng.randint(0, 3000, n)], 11),
        maybe(rng.standard_normal(n - 2).tolist() + [0.0, -0.0], 4),
        maybe([int(v) for v in rng.randint(-10**6, 10**6, n)], 9),
        maybe([int(v) for v in rng.randint(-10**8, 10**8, n)], 13),
    ]


def _schemas():
    def t(mod, name):
        if name.startswith("DecimalType"):
            return mod.DecimalType(10, 2)
        return getattr(mod, name)
    return (JSchema([(n, t(JT, k)) for n, k in _WRITE_TYPES]),
            Schema([(n, t(T, k)) for n, k in _WRITE_TYPES]))


def test_own_writer_bytes_equal_reference(tmp_path):
    """write_parquet writes the reference's bytes for the same python
    values (every type, nulls, a -0.0 beside 0.0 in the double stats);
    pyarrow reads the file."""
    js, ts = _schemas()
    values = _write_values(3000, 2)
    jp, tp = str(tmp_path / "j.parquet"), str(tmp_path / "t.parquet")
    jwrite_parquet(jp, js, values)
    write_parquet(tp, ts, values)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    got = pq.read_table(tp).to_pydict()
    assert got["a"] == values[0] and got["b"] == values[1]
    assert got["e"] == values[2] and got["d"] == values[3]
    rows = _assert_same(tp, [n for n, _ in _WRITE_TYPES])
    assert len(rows) == 3000


def test_connector_write_bytes_equal_reference(tmp_path):
    """The port's connector writes batches (several, each with its own
    string vocabulary) straight from storage; the file equals the one the
    reference's connector writes through python values."""
    js, _ = _schemas()
    jbatches = [JBatch.from_pydict({n: (t, v) for (n, t), v in zip(
        [(f.name, f.type) for f in js.fields], _write_values(n, seed))})
        for n, seed in ((700, 4), (1300, 5))]
    jconn, tconn = JParquet(str(tmp_path)), ParquetConnector(str(tmp_path))
    assert jconn.write_file(str(tmp_path / "j.parquet"), js, jbatches) \
        == 2000
    tbatches = [to_port(b) for b in jbatches]
    assert tconn.write_file(str(tmp_path / "t.parquet"),
                            tbatches[0].schema, tbatches) == 2000
    with open(tmp_path / "j.parquet", "rb") as a, \
            open(tmp_path / "t.parquet", "rb") as b:
        assert a.read() == b.read()
    assert write_parquet_batches(str(tmp_path / "u.parquet"),
                                 tbatches[0].schema, tbatches[:1]) == 700


def test_sql_over_parquet_matches_reference(fixture_dir, tmp_path):
    jc, tc = JCatalogs(), CatalogManager()
    jc.register("pq", JParquet(str(fixture_dir)))
    tc.register("pq", ParquetConnector(str(fixture_dir)))
    jr = JRunner(catalogs=jc, catalog="pq")
    tr = LocalRunner(catalogs=tc, catalog="pq", device="cpu")
    for sql in ("select count(*), sum(k), sum(v), min(s), max(s), "
                "count(ok) from big",
                "select count(*) from big where k > 1000",
                "select k, count(*) c, sum(i) from big where s = 'tag7' "
                "group by k order by c desc, k limit 5"):
        assert_results_match(tr.execute(sql), jr.execute(sql))
    # the pushdown prunes every row group
    pruned0 = decodestats.PARQUET_GROUPS_PRUNED.value
    assert tr.execute("select count(*) from big where k > 1000",
                      properties={"scan_cache": False}).rows == [(0,)]
    assert decodestats.PARQUET_GROUPS_PRUNED.value > pruned0
