"""The port's ORC reader, writer and connector
(presto_tpu_torch/formats/orc*.py, connectors/orc.py) held against
presto_tpu's on the same files: pyarrow writes the independent
fixtures, and each engine's writer writes the other's input.

Every decode is exact: integers, codes and vocabularies equal, doubles
bit for bit (the decode does no arithmetic). SQL results follow the
port's parity rule (torch_parity.assert_results_match)."""
import datetime
import re

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.orc as pa_orc  # noqa: E402

from presto_tpu import types as JT  # noqa: E402
from presto_tpu.batch import Batch as JBatch  # noqa: E402
from presto_tpu.connectors.orc import OrcConnector as JOrcConnector  # noqa: E402
from presto_tpu.connectors.spi import CatalogManager as JCatalogs  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JTpch  # noqa: E402
from presto_tpu.exec.runner import LocalRunner as JRunner  # noqa: E402
from presto_tpu.formats import orc_rle as jrle  # noqa: E402
from presto_tpu.formats.orc import OrcReader as JOrcReader  # noqa: E402
from presto_tpu.formats.orc_writer import write_orc as jwrite_orc  # noqa: E402

from presto_tpu_torch.connectors.orc import OrcConnector  # noqa: E402
from presto_tpu_torch.connectors.spi import CatalogManager, TableHandle  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector  # noqa: E402
from presto_tpu_torch.exec.runner import LocalRunner  # noqa: E402
from presto_tpu_torch.formats import decodestats  # noqa: E402
from presto_tpu_torch.formats import orc_rle  # noqa: E402
from presto_tpu_torch.formats.orc import OrcReader  # noqa: E402
from presto_tpu_torch.formats.orc_meta import parse_stripe_footer  # noqa: E402
from presto_tpu_torch.formats.orc_writer import write_orc  # noqa: E402
from presto_tpu_torch.ops import probe, scan  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_batches_equal, assert_results_match, to_port,
)

CPU = torch.device("cpu")
N = 10_000


def _events_table(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return pa.table({
        "k": pa.array(np.arange(n)),
        "small": pa.array(rng.randint(-128, 128, n), type=pa.int32()),
        "big": pa.array(rng.randint(-10**14, 10**14, n)),
        "price": pa.array(np.round(rng.uniform(0, 1e4, n), 2)),
        "flag": pa.array(rng.choice(["A", "N", "R"], n)),
        "day": pa.array([datetime.date(1995, 1, 1)
                         + datetime.timedelta(days=int(d))
                         for d in rng.randint(0, 2000, n)]),
        "maybe": pa.array([None if i % 11 == 0 else float(i)
                           for i in range(n)]),
        "tiny": pa.array(rng.randint(-128, 128, n).astype(np.int8)),
        "ok": pa.array(rng.rand(n) < 0.5),
        "tag": pa.array([None if i % 13 == 0 else f"t{i % 700}"
                         for i in range(n)]),
        "wide": pa.array(rng.randint(1 << 57, 1 << 61, n, dtype=np.int64)),
        "f32": pa.array(rng.rand(n).astype(np.float32)),
    })


@pytest.fixture(scope="module")
def orc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("orc_tables")
    t = _events_table(N, 7)
    (root / "events").mkdir()
    # two files -> two splits; both compressions
    pa_orc.write_table(t.slice(0, N // 2),
                       str(root / "events" / "part0.orc"),
                       compression="zlib")
    pa_orc.write_table(t.slice(N // 2),
                       str(root / "events" / "part1.orc"),
                       compression="uncompressed")
    return root, t


def test_reader_matches_reference_and_pyarrow(orc_dir):
    """Every stripe of both files decodes to the reference reader's
    batch; the rows also equal pyarrow's (the reference's float32 decode
    widens each value to a vector, so that column is held to pyarrow
    only)."""
    root, t = orc_dir
    halves = [t.slice(0, N // 2), t.slice(N // 2)]
    for part, want in zip(("part0", "part1"), halves):
        path = str(root / "events" / f"{part}.orc")
        jb = list(JOrcReader(path).batches())
        tb = list(OrcReader(path).batches(device=CPU))
        assert len(jb) == len(tb) >= 1
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b, skip=("f32",))
        rows = [r for b in tb for r in b.to_pylist()]
        names = t.column_names
        for got, exp in zip(rows, want.to_pylist()):
            for name, g in zip(names, got):
                w = exp[name]
                if isinstance(w, float) and name == "f32":
                    w = float(np.float32(w))
                assert (g is None and w is None) or g == w, (name, g, w)


def _int_streams(path):
    """(column name, DATA stream bytes, value count) of the integer
    columns without nulls of every stripe of one file."""
    r = OrcReader(path)
    out = []
    for stripe in r.tail.stripes:
        body = r._read_range(stripe.offset, stripe.index_length
                             + stripe.data_length + stripe.footer_length)
        footer = parse_stripe_footer(
            body[stripe.index_length + stripe.data_length:],
            r.tail.compression)
        for c in r.columns:
            if c.orc_kind not in ("long", "int", "short", "date"):
                continue
            streams = r._streams(footer, body, c.orc_id)
            if "data" in streams and "present" not in streams:
                out.append((c.name, streams["data"], stripe.num_rows))
    return out


def test_rle_v2_device_matches_reference(tmp_path):
    """decode_rle_v2_device equals the reference's host and device
    decoders on pyarrow streams holding all four run kinds
    (SHORT_REPEAT, DIRECT, PATCHED_BASE, DELTA), outliers, and a run over
    56 bits, which decodes on the host and is counted."""
    rng = np.random.RandomState(11)
    n = 6000
    outliers = rng.randint(0, 512, n)
    outliers[rng.choice(n, 25, replace=False)] = 10**13
    t = pa.table({
        "repeats": pa.array(np.repeat(rng.randint(-50, 50, n // 5), 5)),
        "random": pa.array(rng.randint(-10**9, 10**9, n)),
        "outliers": pa.array(outliers),
        "ramp": pa.array(np.arange(n) * 3 + 17),
        "steps": pa.array(np.cumsum(rng.randint(0, 40, n))),
        "wide": pa.array(rng.randint(1 << 57, 1 << 61, n, dtype=np.int64)),
        "tiny": pa.array(rng.randint(-128, 128, n).astype(np.int8)),
    })
    path = str(tmp_path / "kinds.orc")
    pa_orc.write_table(t, path, compression="uncompressed")
    kinds = set()
    wide0 = decodestats.WIDE_HOST_DECODES.value
    for name, data, count in _int_streams(path):
        kinds |= set(orc_rle.scan_rle_v2(data, count, True).kinds.tolist())
        want = jrle.decode_rle_v2_numpy(data, count, signed=True)
        jdev = np.asarray(jrle.decode_rle_v2_device(data, count,
                                                    signed=True))[:count]
        got = orc_rle.decode_rle_v2_device(data, count, signed=True,
                                           device=CPU)
        assert got.dtype == torch.int64 and got.device == CPU
        assert np.array_equal(got.numpy()[:count], want), name
        assert np.array_equal(jdev, want), name
        np.testing.assert_array_equal(
            orc_rle.decode_rle_v2_numpy(data, count, signed=True), want)
    assert kinds == {orc_rle.K_SHORT_REPEAT, orc_rle.K_DIRECT,
                     orc_rle.K_PATCHED, orc_rle.K_DELTA}
    assert decodestats.WIDE_HOST_DECODES.value > wide0
    # tinyint (byte RLE) and every column through the readers
    for jb, tb in zip(JOrcReader(path).batches(),
                      OrcReader(path).batches(device=CPU)):
        assert_batches_equal(jb, tb)


def _writer_batches(device=None):
    """Two reference batches of every type the writers take, nulls in
    each, and their copies in the port."""
    rng = np.random.RandomState(3)
    out = []
    for b, n in enumerate((2500, 1700)):
        def maybe(vals, every):
            return [None if (i + b) % every == 0 else v
                    for i, v in enumerate(vals)]
        data = {
            "id": (JT.BIGINT, [int(v) for v in np.arange(n) + 10_000 * b]),
            "i": (JT.INTEGER, maybe(rng.randint(-10**6, 10**6, n).tolist(),
                                    17)),
            "sm": (JT.SMALLINT, rng.randint(-300, 300, n).tolist()),
            "tiny": (JT.TINYINT, maybe(rng.randint(-128, 128, n).tolist(),
                                       9)),
            "d": (JT.DATE, [datetime.date(1990, 1, 1)
                            + datetime.timedelta(days=int(x))
                            for x in rng.randint(0, 9000, n)]),
            "x": (JT.DOUBLE, maybe(rng.standard_normal(n).tolist(), 5)),
            "s": (JT.VARCHAR, maybe([f"w{int(v)}" for v in
                                     rng.randint(0, 400, n)], 7)),
            "flag": (JT.BOOLEAN, maybe((rng.rand(n) < 0.3).tolist(), 11)),
            "dec": (JT.DecimalType(12, 2),
                    maybe([int(v) for v in rng.randint(-10**9, 10**9, n)],
                          13)),
        }
        out.append(JBatch.from_pydict(data))
    return out


def test_writer_bytes_equal_reference(tmp_path):
    """write_orc writes the reference writer's bytes for the same
    batches (several stripes, every type, nulls), and pyarrow reads the
    port's file."""
    jbatches = _writer_batches()
    schema = jbatches[0].schema
    jpath, tpath = str(tmp_path / "j.orc"), str(tmp_path / "t.orc")
    assert jwrite_orc(jpath, schema, jbatches, stripe_rows=1000) == 4200
    tbatches = [to_port(b) for b in jbatches]
    assert write_orc(tpath, tbatches[0].schema, tbatches,
                     stripe_rows=1000) == 4200
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert f1.read() == f2.read()
    table = pa_orc.read_table(tpath)
    assert table.num_rows == 4200
    want = [r for b in jbatches for r in b.to_pylist()]
    got = [r for b in OrcReader(tpath).batches(device=CPU)
           for r in b.to_pylist()]
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in want]
    assert table.column("id").to_pylist() == [r[0] for r in want]


@pytest.fixture(scope="module")
def runners(orc_dir, tmp_path_factory):
    """The reference and the port over the same ORC catalog (events,
    a TPC-H lineitem slice written by the port, and multi-stripe free
    text) beside TPC-H at SF 0.01."""
    root, _ = orc_dir
    tp = TpchConnector(sf=0.01)
    th = TableHandle("tpch", "default", "lineitem")
    cols = ["l_orderkey", "l_shipdate", "l_discount", "l_quantity",
            "l_extendedprice", "l_comment"]
    schema = tp.metadata.table_schema(th).select(cols)
    (root / "lineitem").mkdir()
    for i, split in enumerate(tp.split_manager.splits(th, 2)):
        write_orc(str(root / "lineitem" / f"p{i}.orc"), schema,
                  tp.page_source(split, cols, device=CPU).batches(),
                  stripe_rows=8192)
    # free text over several stripes: each stripe its own sorted
    # vocabulary, the same string under other codes in other stripes
    rng = np.random.RandomState(5)
    words = np.asarray([f"word{i:04d}" for i in range(3000)], dtype=object)
    (root / "notes").mkdir()
    pa_orc.write_table(
        pa.table({"id": pa.array(np.arange(12_000)),
                  "note": pa.array(words[rng.randint(0, 3000, 12_000)]),
                  "grp": pa.array(rng.randint(0, 5, 12_000))}),
        str(root / "notes" / "a.orc"), compression="zlib",
        stripe_size=16 * 1024, dictionary_key_size_threshold=1.0)
    jc = JCatalogs()
    jc.register("hive", JOrcConnector(str(root)))
    jc.register("tpch", JTpch(sf=0.01))
    tc = CatalogManager()
    tc.register("hive", OrcConnector(str(root)))
    tc.register("tpch", tp)
    return (JRunner(catalogs=jc, catalog="hive"),
            LocalRunner(catalogs=tc, catalog="hive", device="cpu"))


Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from {table}
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""


@pytest.mark.parametrize("sql", [
    "select count(*), sum(big), min(k), max(k) from events",
    "select count(*), count(maybe), sum(maybe), count(tag) from events",
    "select count(*) from events, tpch.default.region "
    "where small = r_regionkey",
    "select count(*), sum(tiny), min(day), max(day) from events "
    "where ok and day >= date '1996-01-01'",
    Q6.format(table="lineitem"),
    "select count(*), count(distinct note), min(note), max(note) "
    "from notes",
    "select grp, count(*), sum(id) from notes "
    "where note between 'word0100' and 'word0400' group by grp "
    "order by grp",
], ids=["aggregates", "nulls", "join_tpch", "bool_filter", "q6",
        "text_distinct", "text_group"])
def test_sql_over_orc_matches_reference(runners, sql):
    jr, tr = runners
    assert_results_match(tr.execute(sql), jr.execute(sql))


def test_multi_stripe_dictionaries_and_q6(runners, orc_dir):
    """The free-text table spans stripes with different vocabularies;
    the port's ORC Q6 equals its own TPC-H Q6; a join on a string key
    across stripes matches the reference."""
    _, tr = runners
    root, _ = orc_dir
    r = OrcReader(str(root / "notes" / "a.orc"))
    vocabs = [b.columns[0].dictionary
              for b in r.batches(["note"], device=CPU)]
    assert len(vocabs) > 1 and len(set(vocabs)) > 1
    got = tr.execute(Q6.format(table="lineitem")).rows
    want = tr.execute(Q6.format(table="tpch.default.lineitem")).rows
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-12)
    assert got[0][0] > 0
    lineitem = OrcReader(str(root / "lineitem" / "p0.orc"))
    comments = [b.columns[0].dictionary
                for b in lineitem.batches(["l_comment"], device=CPU)]
    assert len(comments) > 1 and len(set(comments)) > 1


def test_join_on_text_across_stripes(runners, orc_dir):
    """A join on a string key whose sides come from stripes with
    different vocabularies, against the answer computed from pyarrow's
    read of the file (presto_tpu answers 2478 rows here, not the 2956
    distinct notes: its join compares codes of unreconciled stripe
    vocabularies)."""
    _, tr = runners
    root, _ = orc_dir
    t = pa_orc.read_table(str(root / "notes" / "a.orc")).to_pydict()
    first = {}
    for i, note in zip(t["id"], t["note"]):
        first[note] = min(i, first.get(note, i))
    got = tr.execute(
        "select count(*), sum(a.id) from notes a join "
        "(select note, min(id) m from notes group by note) b "
        "on a.note = b.note and a.id = b.m").rows
    assert got == [(len(first), sum(first.values()))]


def test_q3_over_orc_launches_both_kernels(tmp_path):
    """TPC-H Q3 over ORC lineitem, orders and customer written by the
    port equals presto_tpu's Q3 over the same files and the TPC-H answer,
    and goes through both kernels' wrappers (their plain versions on the
    CPU): the sort-path partial aggregation's segment sums, and the probe
    for builds whose keys measure unique (a file catalog declares no
    keys)."""
    from tpch_queries import Q
    q3 = {n: s for n, s, _ in Q}["q3"]
    tp = TpchConnector(sf=0.01)
    conn = OrcConnector(str(tmp_path))
    for table in ("lineitem", "orders", "customer"):
        th = TableHandle("tpch", "default", table)
        schema = tp.metadata.table_schema(th)
        conn.create_table(table, schema)
        for split in tp.split_manager.splits(th, 2):
            for b in tp.page_source(split, schema.names,
                                    device=CPU).batches():
                conn.append(table, b)
    cm = CatalogManager()
    cm.register("orc", conn)
    r = LocalRunner(catalogs=cm, catalog="orc", device="cpu")
    scan.plain_calls = probe.plain_calls = 0
    got = r.execute(q3)
    assert scan.plain_calls > 0 and probe.plain_calls > 0
    jc = JCatalogs()
    jc.register("orc", JOrcConnector(str(tmp_path)))
    assert_results_match(got, JRunner(catalogs=jc, catalog="orc")
                         .execute(q3))
    want = LocalRunner(tpch_sf=0.01, device="cpu").execute(q3)
    assert got.rows and [r[0] for r in got.rows] == [r[0] for r in
                                                     want.rows]
    for a, b in zip(got.rows, want.rows):
        assert a[1] == pytest.approx(b[1], rel=1e-12) and a[2:] == b[2:]


def _scan_rows(runner, sql: str) -> int:
    text = "\n".join(r[0] for r in runner.execute(
        f"explain analyze {sql}", properties={"scan_cache": False}).rows)
    m = re.search(r"TableScan\[hive.*?(\d[\d,]*) rows", text)
    assert m, text
    return int(m.group(1).replace(",", ""))


def test_stripe_pruning(tmp_path):
    """Sorted data with per-stripe stats: a tight filter decodes only the
    matching stripes, at the reader and through the engine's pushdown."""
    n = 400_000
    rng = np.random.RandomState(5)
    t = pa.table({
        "k": pa.array(np.arange(n)),
        "pad": pa.array(rng.randint(-10**15, 10**15, n)),
    })
    (tmp_path / "seq").mkdir()
    pa_orc.write_table(t, str(tmp_path / "seq" / "a.orc"),
                       compression="uncompressed",
                       stripe_size=256 * 1024)
    r = OrcReader(str(tmp_path / "seq" / "a.orc"))
    assert len(r.tail.stripes) > 2
    pruned0 = decodestats.ORC_STRIPES_PRUNED.value
    kept = list(r.batches(["k"], min_max={"k": (0, 10)}, device=CPU))
    assert 0 < len(kept) < len(r.tail.stripes)
    assert decodestats.ORC_STRIPES_PRUNED.value - pruned0 == \
        len(r.tail.stripes) - len(kept)
    cm = CatalogManager()
    cm.register("hive", OrcConnector(str(tmp_path)))
    runner = LocalRunner(catalogs=cm, catalog="hive", device="cpu")
    res = runner.execute("select count(*), min(k), max(k) from seq "
                         "where k between 100 and 200")
    assert res.rows == [(101, 100, 200)]
    assert _scan_rows(runner, "select count(*) from seq where k between "
                              "100 and 200") < n


def test_one_sided_pushdown_large_values(tmp_path):
    """A one-sided filter (k >= lo) must not prune stripes whose values
    exceed any finite sentinel: unbounded sides travel as None."""
    n = 200_000
    big = (1 << 62) + 17
    t = pa.table({"k": pa.array(np.concatenate([
        np.arange(n, dtype=np.int64),
        np.arange(n, dtype=np.int64) + big,
    ]))})
    (tmp_path / "huge").mkdir()
    pa_orc.write_table(t, str(tmp_path / "huge" / "a.orc"),
                       compression="uncompressed",
                       stripe_size=256 * 1024)
    cm = CatalogManager()
    cm.register("hive", OrcConnector(str(tmp_path)))
    runner = LocalRunner(catalogs=cm, catalog="hive", device="cpu")
    res = runner.execute("select count(*) c from huge where k >= 10")
    assert res.rows[0][0] == 2 * n - 10


def test_page_source_device_rule(orc_dir, monkeypatch):
    """The catalog takes ``device=``; with none it wants the GPU and
    raises without one."""
    root, _ = orc_dir
    conn = OrcConnector(str(root))
    th = TableHandle("hive", "default", "events")
    split = conn.split_manager.splits(th)[0]
    b = next(iter(conn.page_source(split, ["k"], device="cpu").batches()))
    assert b.device.type == "cpu" and b.columns[0].data.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conn.page_source(split, ["k"])


def test_expansion_range_under_torch_profiler(orc_dir):
    """While torch.profiler records, each device expansion runs in the
    ``file_decode_expansion`` range (its kernels are the expansion's
    device time); without a profiler the range is not entered."""
    root, _ = orc_dir
    path = str(root / "events" / "part0.orc")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        want = [b for b in OrcReader(path).batches(device=CPU)]
    names = [e.name for e in prof.events()]
    assert names.count(decodestats.EXPANSION) > 0
    assert not torch.autograd._profiler_enabled()
    for a, b in zip(want, OrcReader(path).batches(device=CPU)):
        assert_batches_equal(b, a)


def test_string_join_across_orc_and_parquet_with_null_keys(tmp_path):
    """One pyarrow table written as ORC and as Parquet (20 000 rows, the
    string key NULL on every 13th row), joined across the two catalogs
    on the string and the id: the port counts the 18 461 non-NULL rows,
    computed here from the table (presto_tpu joins the two files'
    dictionary codes without unifying their vocabularies: it counts 0
    for this table)."""
    import pyarrow.parquet as pa_pq
    from presto_tpu_torch.connectors.parquet import ParquetConnector
    n = 20_000
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array([None if i % 13 == 0 else f"s{(i * 7919) % 1009}"
                       for i in range(n)]),
    })
    (tmp_path / "orc" / "ext").mkdir(parents=True)
    (tmp_path / "pq" / "ext").mkdir(parents=True)
    pa_orc.write_table(t, str(tmp_path / "orc" / "ext" / "part0.orc"))
    pa_pq.write_table(t, str(tmp_path / "pq" / "ext" / "part0.parquet"),
                      compression="gzip")
    cm = CatalogManager()
    cm.register("orc", OrcConnector(str(tmp_path / "orc")))
    cm.register("pq", ParquetConnector(str(tmp_path / "pq")))
    r = LocalRunner(catalogs=cm, catalog="orc", device="cpu")
    want = sum(1 for v in t.column("s").to_pylist() if v is not None)
    assert want == 18_461
    got = r.execute("select count(*) from orc.default.ext a join "
                    "pq.default.ext b on a.s = b.s and a.id = b.id").rows
    assert got == [(want,)]
    # the NULL keys match nothing, on either side of the join
    got = r.execute("select count(*) from orc.default.ext a join "
                    "pq.default.ext b on a.id = b.id "
                    "where a.s is null").rows
    assert got == [(n - want,)]
