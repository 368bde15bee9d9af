"""The client, DB-API and CLI of presto_tpu_torch (client.py, dbapi.py,
cli.py) against presto_tpu's: ``dbapi._bind`` on 200 parameter lists
made from a numpy seed and ``cli.format_rows`` in every format give
the same text (exactly), and the port's counterparts of
tests/test_dbapi.py run against the port's server on ``device="cpu"``.
The CLI's ``--profile-out`` writes one merged trace holding the span
tracer's host spans and the torch.profiler session's events."""
import datetime
import json
import os

import numpy as np
import pytest

from presto_tpu import cli as jcli
from presto_tpu import dbapi as jdbapi
from presto_tpu_torch import cli, dbapi

import torch_parity  # noqa: F401  (one torch thread per worker)


@pytest.fixture(scope="module")
def server():
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.server.protocol import PrestoTpuServer
    srv = PrestoTpuServer(runner=LocalRunner(tpch_sf=0.001, device="cpu"))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def conn(server):
    c = dbapi.connect(port=server.port, catalog="tpch", schema="default")
    yield c
    c.close()


# -- parity with presto_tpu ----------------------------------------------------

_TEMPLATES = ("select ?", "select ? as a, ? as b",
              "select '?' as q, ? as v -- tail?",
              "select \"a?\" from t where x = ? /* ? */ and y in (?, ?)",
              "select 'it''s ?', ?, ?")


def _value(rng):
    kind = rng.integers(0, 10)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-2**62, 2**62))
    if kind == 3:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-5, 9))
    if kind == 4:
        alphabet = list("ab'?\"-/* \t\n\\%_") + ["é", "中"]
        return "".join(rng.choice(alphabet, size=rng.integers(0, 9)))
    if kind == 5:
        return datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(rng.integers(0, 20000)))
    if kind == 6:
        return datetime.datetime(2020, 1, 1) + datetime.timedelta(
            microseconds=int(rng.integers(0, 10**12)))
    if kind == 7:
        return [int(x) for x in rng.integers(-9, 9, size=3)]
    if kind == 8:
        return (float(rng.random()), None, "x'y")
    return -0.0 if rng.integers(0, 2) else float("inf")


def _bound(mod, op, params):
    try:
        return "ok", mod._bind(op, params)
    except mod.ProgrammingError as e:
        return "error", str(e)


def test_bind_equals_reference_on_seeded_parameters():
    rng = np.random.default_rng(20261017)
    errors = 0
    for i in range(200):
        op = _TEMPLATES[i % len(_TEMPLATES)]
        n = op.count("?") - op.count("'?'") - op.count("a?") \
            - op.count("tail?") - op.count("/* ? */") - op.count("'it''s ?'")
        # a tenth of the lists has one parameter too many or too few
        n += int(rng.choice([0] * 9 + [1])) * int(rng.choice([-1, 1]))
        params = [_value(rng) for _ in range(max(n, 0))]
        got, want = _bound(dbapi, op, params), _bound(jdbapi, op, params)
        assert got == want, (op, params)
        errors += got[0] == "error"
    assert 0 < errors < 200
    assert dbapi._bind("select 1", None) == "select 1"


FORMAT_COLS = [("a", "bigint"), ("b", "varchar"), ("c", "double"),
               ("d", "date"), ("e", "decimal(10,2)"), ("f", "boolean")]
FORMAT_ROWS = [
    [1, "x,y", 1.5, "1998-09-02", "12.25", True],
    [None, 'say "hi"\tnow\nthen\\', "NaN", None, "-0.10", False],
    [-7, "", -2.5e-300, "2020-01-01", None, None],
]


@pytest.mark.parametrize("fmt", ["ALIGNED", "CSV", "CSV_HEADER", "TSV",
                                 "TSV_HEADER", "JSON"])
def test_format_rows_equal_reference(fmt):
    assert cli.format_rows(FORMAT_COLS, FORMAT_ROWS, fmt) == \
        jcli.format_rows(FORMAT_COLS, FORMAT_ROWS, fmt)
    with pytest.raises(ValueError):
        cli.format_rows(FORMAT_COLS, FORMAT_ROWS, "XML")


# -- tests/test_dbapi.py -------------------------------------------------------

def test_module_globals():
    assert dbapi.apilevel == "2.0"
    assert dbapi.paramstyle == "qmark"
    assert dbapi.threadsafety == 1


def test_basic_query(conn):
    cur = conn.cursor()
    cur.execute("select n_name, n_nationkey from nation "
                "where n_nationkey < 3 order by 2")
    assert cur.rowcount == 3
    assert [d[0] for d in cur.description] == ["n_name", "n_nationkey"]
    assert cur.fetchone() == ("ALGERIA", 0)
    assert cur.fetchmany(1) == [("ARGENTINA", 1)]
    assert cur.fetchall() == [("BRAZIL", 2)]
    assert cur.fetchone() is None


def test_cursor_iteration(conn):
    cur = conn.cursor()
    cur.execute("select n_nationkey from nation order by 1 limit 4")
    assert [r[0] for r in cur] == [0, 1, 2, 3]


def test_qmark_parameters(conn):
    cur = conn.cursor()
    cur.execute("select n_name from nation where n_nationkey = ?", (3,))
    assert cur.fetchall() == [("CANADA",)]
    cur.execute("select n_name from nation where n_name = ?", ("PERU",))
    assert cur.fetchall() == [("PERU",)]


def test_string_escaping(conn):
    cur = conn.cursor()
    cur.execute("select ? as v", ("it's",))
    assert cur.fetchall() == [("it's",)]


def test_question_mark_in_string_literal(conn):
    cur = conn.cursor()
    cur.execute("select '?' as q, ? as v", (7,))
    assert cur.fetchall() == [("?", 7)]


def test_parameter_count_mismatch(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select ? as v", (1, 2))
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select ?, ? ", (1,))


def test_date_parameter(conn):
    cur = conn.cursor()
    cur.execute("select ? < date '2021-01-01'",
                (datetime.date(2020, 5, 5),))
    assert cur.fetchall() == [(True,)]


def test_error_maps_to_database_error(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.DatabaseError):
        cur.execute("select no_such from nation")


def test_closed_cursor_rejects(conn):
    cur = conn.cursor()
    cur.close()
    with pytest.raises(dbapi.InterfaceError):
        cur.execute("select 1")


def test_context_managers(server):
    with dbapi.connect(port=server.port, catalog="tpch") as c:
        with c.cursor() as cur:
            cur.execute("select count(*) from region")
            assert cur.fetchone() == (5,)
    with pytest.raises(dbapi.InterfaceError):
        c.cursor()


def test_placeholder_in_comment_ignored(conn):
    cur = conn.cursor()
    cur.execute("select ? as v -- trailing comment?", (5,))
    assert cur.fetchall() == [(5,)]
    cur.execute("select ? as v /* block ? comment */", (6,))
    assert cur.fetchall() == [(6,)]


def test_escaped_quote_in_string(conn):
    cur = conn.cursor()
    cur.execute("select 'it''s' as s, ? as v", (1,))
    assert cur.fetchall() == [("it's", 1)]


def test_empty_params_with_placeholder_rejected(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select ? as v", ())


def test_commit_without_transaction_ok(conn):
    conn.commit()
    conn.rollback()


def test_executemany_and_transactions(conn):
    cur = conn.cursor()
    cur.execute("create table memory.default.dbt as select 1 as k")
    cur.executemany("insert into memory.default.dbt select ? as k",
                    [(2,), (3,)])
    cur.execute("select sum(k), count(*) from memory.default.dbt")
    assert cur.fetchall() == [(6, 3)]
    cur.execute("drop table memory.default.dbt")


# -- CLI -----------------------------------------------------------------------

COLS = [("a", "bigint"), ("b", "varchar")]
ROWS = [(1, "x,y"), (2, None)]


def test_format_csv():
    out = cli.format_rows(COLS, ROWS, "CSV")
    assert out == '"1","x,y"\n"2",'
    assert cli.format_rows(COLS, ROWS, "CSV_HEADER").startswith('"a","b"\n')


def test_format_tsv():
    assert cli.format_rows(COLS, [(1, "a\tb")], "TSV") == "1\ta\\tb"


def test_format_json():
    lines = cli.format_rows(COLS, ROWS, "JSON").split("\n")
    assert json.loads(lines[0]) == {"a": 1, "b": "x,y"}
    assert json.loads(lines[1]) == {"a": 2, "b": None}


def test_cli_execute_csv(server, capsys):
    rc = cli.main(["--server", f"http://127.0.0.1:{server.port}",
                   "--catalog", "tpch", "--output-format", "CSV_HEADER",
                   "-e", "select n_nationkey from nation order by 1 limit 2"])
    assert rc == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert out == ['"n_nationkey"', '"0"', '"1"']


def test_cli_aligned_and_failed_statement(server, capsys):
    rc = cli.main(["--server", f"http://127.0.0.1:{server.port}",
                   "-e", "select r_name from region order by 1 limit 2; "
                         "select bogus from region"])
    assert rc == 0
    out, err = capsys.readouterr()
    assert out.split("\n")[:5] == ["r_name ", "-------", "AFRICA ",
                                   "AMERICA", "(2 rows)"]
    assert "Query failed" in err and "bogus" in err


def test_cli_embedded_profile_out_merges_host_and_device(tmp_path, capsys):
    """The embedded server on the CPU: --profile-out leaves
    merged_trace.json with the tracer's spans of the statement and the
    torch.profiler session's events, both in epoch microseconds; a second
    session in the same directory replaces the first's events. (The
    tracer's clock is the wall clock at import plus a monotonic clock,
    the profiler's the wall clock at its start: they agree to the extent
    the host's wall clock was not stepped in between, so the check here
    is of the scale, not of the microsecond.)"""
    from presto_tpu_torch.obs import profiler
    from presto_tpu_torch.obs.trace import TRACER
    out = str(tmp_path / "prof")
    try:
        for _ in range(2):
            rc = cli.main(["--device", "cpu", "--sf", "0.001",
                           "--profile-out", out, "--output-format", "CSV",
                           "-e", "select count(*) from orders"])
            assert rc == 0
    finally:
        TRACER.enable(False)
        TRACER.clear()
    assert capsys.readouterr().out.split("\n")[-2] == '"1500"'
    sessions = os.listdir(os.path.join(out, profiler.TRACE_SESSIONS))
    assert len(sessions) == 2
    assert len(profiler.find_device_traces(out)) == 1
    doc = json.load(open(os.path.join(out, "merged_trace.json")))
    events = doc["traceEvents"]
    host = [e for e in events if e.get("cat") == "presto_tpu_torch"]
    assert {"query", "plan"} <= {e["name"] for e in host}
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "presto_tpu_torch"]
    assert device, "no profiler events were merged"
    host_pids = {e["pid"] for e in host}
    assert not host_pids & {e["pid"] for e in device}
    hour_us = 3600e6
    lo = min(e["ts"] for e in host) - hour_us
    hi = max(e["ts"] for e in host) + hour_us
    for e in device:
        assert lo <= e["ts"] <= hi, e


def test_merge_shifts_by_the_trace_base_time(tmp_path):
    path = tmp_path / "x.trace.json"
    path.write_text(json.dumps({
        "baseTimeNanoseconds": 1_700_000_000_000_000_000,
        "traceEvents": [{"ph": "X", "name": "k", "ts": 5.0, "dur": 1,
                         "pid": 0, "tid": 0}, {"ph": "M", "name": "m"}]}))
    from presto_tpu_torch.obs.profiler import load_trace_events
    ev = load_trace_events(str(path))
    assert ev[0]["ts"] == 1_700_000_000_000_000 + 5.0
    assert "ts" not in ev[1]


def test_frontdoor_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's frontdoor phase on the CPU at SF 0.01 (three warm
    runs a query): the 22 TPC-H queries over HTTP equal the CPU rows, the
    DB-API bindings and the CLI's CSV equal the runner's, the embedded
    CLI's merged trace holds host spans and profiler events, the fleet's
    remote write drops the peer's cached result before its next read,
    and the endpoints answer; both kernels' plain versions ran."""
    import importlib.util
    import pathlib

    import torch
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.phase_frontdoor(torch, None, device="cpu", sf=0.01,
                                     cli_sf=0.01, runs=3,
                                     rows_per_batch=1 << 12)
    assert min(launches.values()) > 0, launches
