"""The statement server of presto_tpu_torch (server/protocol.py) against
presto_tpu's: the same statements POSTed to both packages' servers (the
port's on ``device="cpu"``, the reference's on JAX's CPU) give the same
assembled columns and data, the same paging, the same error verdicts,
session headers and status documents. Doubles are held at rel 1e-12,
everything else exactly, non-finite doubles included (the protocol
sends them as strings).

Then the port's counterparts of the server cases of tests/test_protocol.py,
test_security.py, test_serving.py, test_serving_cache.py,
test_resource_groups.py, test_slo.py, test_explain_formats.py and
test_timeseries.py (both halves of the history endpoint), the worker and
coordinator metrics endpoints of test_obs_ops.py over a three-worker
cluster, and a check that no context variable leaks between statements
that share a worker thread. Every server listens on port 0 and stops in a finally."""
import base64
import contextlib
import json
import math
import threading
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.server.protocol import PrestoTpuServer as JServer
from presto_tpu_torch.client import QueryFailed, StatementClient
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.server import PrestoTpuServer, StatementServer
from presto_tpu_torch.server import protocol as P

import torch_parity  # noqa: F401  (one torch thread per worker)

REL = 1e-12


def _metric(name: str) -> float:
    for m in REGISTRY.snapshot():
        if m["name"] == name:
            return m["value"]
    return 0.0


@contextlib.contextmanager
def serving(srv):
    srv.start()
    try:
        yield f"http://127.0.0.1:{srv.port}"
    finally:
        srv.stop()


def _request(url, data=None, method=None, headers=None):
    """(status, headers, document) of one request; HTTP errors too."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _statement(base, sql, headers=None):
    """POST one statement and follow nextUri: (columns, data pages,
    error, session headers of every response)."""
    status, hdrs, doc = _request(f"{base}/v1/statement", sql.encode(),
                                 "POST", headers)
    assert status == 200, (status, doc)
    columns, pages, session = None, [], []
    while True:
        session += [(k, v) for k, v in hdrs.items()
                    if k.startswith("X-Presto-")]
        if doc.get("columns") and columns is None:
            columns = doc["columns"]
        if "data" in doc:
            pages.append(doc["data"])
        if not doc.get("nextUri"):
            return columns, pages, doc.get("error"), session
        status, hdrs, doc = _request(doc["nextUri"])
        assert status == 200, (status, doc)


def _until_inline(client, sql, rows, inline0, least=3, most=50):
    """Run ``sql`` at least ``least`` times and until the inline lane has
    served it (a statement earns the lane by draining within the POST's
    grace, which a loaded host may miss now and then)."""
    for i in range(most):
        assert client.execute(sql).rows == rows
        if i + 1 >= least and _metric("serving_inline_lane_total") > inline0:
            return
    raise AssertionError(f"{sql!r} never took the inline lane")


def assert_json_rows(got, want, rel=REL):
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b), (i, a, b)
        for u, v in zip(a, b):
            if isinstance(v, float) and not isinstance(u, bool):
                assert isinstance(u, float), (i, u, v)
                assert math.isclose(u, v, rel_tol=rel), (i, u, v)
            else:
                assert u == v and type(u) is type(v), (i, u, v)


_PAIR_SERVERS = []


@pytest.fixture(scope="module")
def pair():
    """Both packages' servers at TPC-H SF 0.01."""
    j = JServer(JRunner(tpch_sf=0.01))
    t = PrestoTpuServer(LocalRunner(tpch_sf=0.01, device="cpu"))
    with serving(j) as jurl, serving(t) as turl:
        _PAIR_SERVERS[:] = [j, t]
        yield jurl, turl


# -- parity with presto_tpu's server ------------------------------------------

PARITY_SQL = [
    "select n_name, n_regionkey from nation order by n_name limit 3",
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "avg(l_extendedprice), count(*) from lineitem group by 1, 2 "
    "order by 1, 2",
    "select o_orderkey, o_orderdate, o_totalprice, o_orderpriority "
    "from orders order by o_orderkey limit 7",
    # every value kind whose JSON form could differ: REAL widened to a
    # double, non-finite doubles as strings, dates, short and long
    # decimals, ARRAY, MAP, booleans and NULLs
    "select cast(2.5 as real) r, cast(0.1 as real) r2, nan() n, "
    "infinity() i, -infinity() ni, date '1998-09-02' d, "
    "cast(12.25 as decimal(10, 2)) sd, "
    "cast(12345678901234567890.12 as decimal(30, 2)) ld, "
    "array[1, 2, 3] a, map(array['k'], array[7]) m, true b, "
    "cast(null as bigint) nb, cast(null as varchar) nv",
    "select 1",
]

#: columns of integer literals, by statement: INTEGER in the port
#: (Presto's LongLiteral typing), BIGINT in the reference; column index
#: -> (the reference's type, the port's)
PARITY_RETYPED = {
    PARITY_SQL[3]: {8: ("array(bigint)", "array(integer)"),
                    9: ("map(varchar(1), bigint)", "map(varchar(1), integer)")},
    "select 1": {0: ("bigint", "integer")},
}


def _retyped(columns, retyped):
    """The reference's column list with the types that differ by design
    replaced by the port's, each asserted first."""
    out = [dict(c) for c in columns]
    for i, (ref_type, port_type) in (retyped or {}).items():
        assert out[i]["type"] == ref_type, (i, out[i])
        out[i]["type"] = port_type
    return out


def _nested(columns):
    """Indexes of the ARRAY and MAP columns: their values cross as JSON
    arrays and objects in the port and as Python text in the reference
    (test_array_and_map_values_cross_as_json)."""
    return {i for i, c in enumerate(columns)
            if c["type"].startswith(("array(", "map("))}


@pytest.mark.parametrize("sql", PARITY_SQL)
def test_statements_equal_reference(pair, sql):
    jurl, turl = pair
    jcols, jpages, jerr, _ = _statement(jurl, sql)
    tcols, tpages, terr, _ = _statement(turl, sql)
    assert terr is None and jerr is None, (terr, jerr)
    assert tcols == _retyped(jcols, PARITY_RETYPED.get(sql))
    skip = _nested(tcols)
    assert_json_rows([[v for i, v in enumerate(r) if i not in skip]
                      for p in tpages for r in p],
                     [[v for i, v in enumerate(r) if i not in skip]
                      for p in jpages for r in p])


def test_array_and_map_values_cross_as_json(pair):
    """An ARRAY crosses the protocol as a JSON array and a MAP as a JSON
    object (keys as text), element by element, as Presto's client
    protocol has them; the client and DB-API hand back a list and a dict
    with typed keys. The reference sends the text of a Python list or
    dict of numpy scalars."""
    from presto_tpu_torch import dbapi
    jurl, turl = pair
    sql = ("select array[1, 2, 3] a, map(array['k'], array[7]) m, "
           "map(array[1, 2], array['x', null]) mi, array['s', null] s, "
           "cast(null as array(bigint)) n")
    jcols, jpages, _, _ = _statement(jurl, sql)
    tcols, tpages, _, _ = _statement(turl, sql)
    # the literals' columns: integer in the port, bigint in the reference
    assert tcols == _retyped(jcols, {
        0: ("array(bigint)", "array(integer)"),
        1: ("map(varchar(1), bigint)", "map(varchar(1), integer)"),
        2: ("map(bigint, varchar(1))", "map(integer, varchar(1))")})
    assert _nested(tcols) == {0, 1, 2, 3, 4}
    assert jpages[0][0][:2] == [                   # the reference
        "[np.int64(1), np.int64(2), np.int64(3)]", "{'k': np.int64(7)}"]
    assert tpages[0][0] == [[1, 2, 3], {"k": 7}, {"1": "x", "2": None},
                            ["s", None], None]
    want = [[1, 2, 3], {"k": 7}, {1: "x", 2: None}, ["s", None], None]
    assert StatementClient(turl).execute(sql).rows == [want]
    port = int(turl.rsplit(":", 1)[1])
    cur = dbapi.connect(port=port).cursor()
    cur.execute(sql)
    assert cur.fetchall() == [tuple(want)]


def test_pages_of_a_10000_row_result(pair):
    """The buffered pages hold ROWS_PER_PAGE rows each in both packages.
    Over HTTP the POST may fold the first two into its answer when the
    second is ready within its short wait, so the pages a client sees
    depend on timing; their rows do not."""
    jurl, turl = pair
    sql = "select l_orderkey, l_linenumber from lineitem limit 10000"
    _, jpages, _, _ = _statement(jurl, sql)
    _, tpages, _, _ = _statement(turl, sql)
    assert [r for p in tpages for r in p] == [r for p in jpages for r in p]
    assert sum(len(p) for p in tpages) == 10000
    sizes = {}
    for srv in _PAIR_SERVERS:
        q = srv.create_query(sql, {})
        assert q.done.wait(timeout=60)
        token, lens = 0, []
        while True:
            page = q.next_page(token)
            if page is None:
                break
            lens.append(len(page))
            token += 1
        sizes[type(srv).__module__] = lens
    assert P.ROWS_PER_PAGE == 4096
    assert list(sizes.values()) == [[4096, 4096, 1808]] * 2, sizes


@pytest.mark.parametrize("sql", [
    "select bogus_column from nation",
    "select * from no_such_table",
    "set session join_distribution_type = 'b'",
    "select cast('x' as bigint)",
])
def test_error_verdicts_equal_reference(pair, sql):
    jurl, turl = pair
    _, _, jerr, _ = _statement(jurl, sql)
    _, _, terr, _ = _statement(turl, sql)
    assert jerr is not None and terr is not None
    assert (terr["errorName"], terr["errorType"], terr["errorCode"]) == \
        (jerr["errorName"], jerr["errorType"], jerr["errorCode"])


def test_session_headers_equal_reference(pair):
    jurl, turl = pair
    for sql in ("set session task_concurrency = 2",
                "set session spill_path = '/tmp/x'",
                "reset session task_concurrency",
                "reset session spill_path"):
        _, _, jerr, jsess = _statement(jurl, sql)
        _, _, terr, tsess = _statement(turl, sql)
        assert jerr is None and terr is None
        # every response after the statement ran repeats the headers, and
        # how many responses there are depends on timing
        assert set(tsess) == set(jsess) and tsess, sql


def test_info_and_resource_group_docs_equal_reference(pair):
    jurl, turl = pair
    for path in ("/v1/info", "/v1/resourceGroup", "/v1/service"):
        _, _, jdoc = _request(jurl + path)
        _, _, tdoc = _request(turl + path)
        assert tdoc == jdoc, path
    for path in ("/v1/fleet", "/v1/autoscale", "/v1/nope"):
        assert _request(turl + path)[0] == _request(jurl + path)[0] == 404


def test_execute_bindings_on_one_worker_equal_reference(pair, monkeypatch):
    """Two EXECUTEs with different bindings back to back through a
    server whose producer pool has one worker thread: each equals the
    reference, so no binding scope survives from one statement to the
    next on that thread."""
    jurl, _ = pair
    monkeypatch.setattr(P, "_PRODUCERS", P._ProducerPool(cap=1))
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.01, device="cpu"))
    srv.runner.session.properties["plan_template_cache"] = True
    with serving(srv) as turl:
        prep = ("prepare q from select count(*), sum(l_quantity) from "
                "lineitem where l_quantity < ?")
        for base in (jurl, turl):
            assert _statement(base, prep)[2] is None
        for qty in (10, 30, 10):
            sql = f"execute q using {qty}"
            _, jpages, _, _ = _statement(jurl, sql)
            _, tpages, terr, _ = _statement(turl, sql)
            assert terr is None
            assert_json_rows(tpages[0], jpages[0])
        assert P._PRODUCERS._threads == 1


def test_no_context_variable_survives_a_statement(monkeypatch):
    """A runner that sets the binding scope, the profile session and the
    current span and never resets them: the next statement, on the same
    pooled worker or on the same keep-alive handler thread (the inline
    lane), still starts with all three unset."""
    from presto_tpu_torch.expr import params
    from presto_tpu_torch.obs import profiler, trace
    from presto_tpu_torch.exec.local import QueryResult

    seen = []

    class LeakyRunner:
        def execute(self, sql, properties=None, user="", cancel_event=None):
            seen.append((params._BINDINGS.get(), profiler._ACTIVE.get(),
                         trace._CURRENT.get(), threading.get_ident()))
            params._BINDINGS.set(object())
            profiler._ACTIVE.set(object())
            trace._CURRENT.set(object())
            return QueryResult(["x"], [], [(1,)])

    monkeypatch.setattr(P, "_PRODUCERS", P._ProducerPool(cap=1))
    srv = PrestoTpuServer(runner=LeakyRunner())
    with serving(srv) as base:
        client = StatementClient(base)
        i0 = _metric("serving_inline_lane_total")
        _until_inline(client, "select leak", [[1]], i0)
        for _ in range(2):
            assert StatementClient(base).execute("select other").rows \
                == [[1]]
    assert all(s[:3] == (None, None, None) for s in seen), seen


# -- tests/test_protocol.py ----------------------------------------------------

@pytest.fixture(scope="module")
def server():
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    return StatementClient(f"http://127.0.0.1:{server.port}")


def test_simple_query(server, client):
    res = client.execute("select n_name, n_regionkey from nation "
                         "order by n_name limit 3")
    assert [c[0] for c in res.columns] == ["n_name", "n_regionkey"]
    assert len(res.rows) == 3
    assert res.rows[0][0] == "ALGERIA"
    direct = server.runner.execute(
        "select n_name, n_regionkey from nation order by n_name limit 3")
    assert [list(r) for r in res.rows] == \
        [[v if not hasattr(v, "item") else v.item() for v in r]
         for r in direct.rows]


def test_multi_page(server, client):
    res = client.execute("select l_orderkey from lineitem")
    direct = server.runner.execute("select count(*) from lineitem")
    assert len(res.rows) == direct.rows[0][0]


def test_error_surfaces_as_query_error(server, client):
    with pytest.raises(QueryFailed) as ei:
        client.execute("select bogus_column from nation")
    assert "bogus_column" in str(ei.value)


def test_session_roundtrip(server, client):
    client.execute("set session task_concurrency = 2")
    assert client.session_properties.get("task_concurrency") == "2"
    client.execute("show session")
    client.execute("reset session task_concurrency")
    assert "task_concurrency" not in client.session_properties


def test_set_session_unknown_property_is_query_error(server, client):
    with pytest.raises(QueryFailed) as ei:
        client.execute("set session join_distribution_type = 'b'")
    assert "unknown session property" in str(ei.value)


def test_raw_protocol_shape(server):
    status, _, doc = _request(
        f"http://127.0.0.1:{server.port}/v1/statement", b"select 1",
        "POST", {"X-Presto-User": "test"})
    assert status == 200
    assert set(doc) >= {"id", "infoUri", "stats"}
    while "data" not in doc:
        assert "nextUri" in doc
        _, _, doc = _request(doc["nextUri"])
    # the literal 1 is INTEGER (Presto's LongLiteral typing)
    assert doc["columns"][0]["type"] == "integer"
    assert doc["data"] == [[1]]


class _SlowConnector:
    """A TPC-H connector whose every batch sleeps ``delay_s`` first."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self.name = inner.name
        self.delay_s = delay_s

    @property
    def metadata(self):
        return self._inner.metadata

    @property
    def split_manager(self):
        return self._inner.split_manager

    def page_source(self, split, columns, pushdown=None,
                    rows_per_batch=1 << 17, device=None):
        inner = self._inner.page_source(
            split, columns, pushdown=pushdown,
            rows_per_batch=rows_per_batch, device=device)
        delay = self.delay_s

        class _PS:
            def batches(self):
                for b in inner.batches():
                    time.sleep(delay)
                    yield b

            def close(self):
                inner.close()
        return _PS()


def test_cancel():
    """DELETE-cancel interrupts a RUNNING query: the scan below is slow
    (>= 4 s of per-batch delays), and the executor's per-batch cancel
    check must stop the producer long before the scan could finish."""
    from presto_tpu_torch.connectors.spi import CatalogManager
    from presto_tpu_torch.connectors.tpch import TpchConnector

    catalogs = CatalogManager()
    catalogs.register("tpch", _SlowConnector(TpchConnector(sf=0.001), 0.05))
    srv = PrestoTpuServer(LocalRunner(catalogs=catalogs, device="cpu",
                                      rows_per_batch=64))
    with serving(srv) as base:
        pages = StatementClient(base).pages(
            "select count(*) from lineitem")
        first = next(pages)
        q = srv.queries[first["id"]]
        deadline = time.time() + 10
        while q.state == "QUEUED" and time.time() < deadline:
            time.sleep(0.01)
        assert q.state == "RUNNING"
        t0 = time.time()
        urllib.request.urlopen(urllib.request.Request(
            first["nextUri"], method="DELETE"), timeout=10)
        assert q.state == "FAILED"
        assert q.error["errorName"] == "USER_CANCELED"
        assert q.done.wait(timeout=3.0)
        assert time.time() - t0 < 3.0
        assert q.state == "FAILED"


def test_query_detail_stats_endpoint():
    srv = StatementServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    with serving(srv) as base:
        _statement(base, "select count(*) from lineitem where "
                         "l_quantity > 10")
        _, _, qs = _request(f"{base}/v1/query")
        qid = qs[0]["queryId"]
        _, _, detail = _request(f"{base}/v1/query/{qid}")
        assert detail["state"] == "FINISHED"
        names = [n["node"] for n in detail["nodes"]]
        assert "TableScan" in names
        scan = next(n for n in detail["nodes"] if n["node"] == "TableScan")
        assert scan["batches"] >= 1 and scan["wallMs"] >= 0
        assert detail["splits"] and \
            detail["splits"][0]["table"] == "lineitem"
        assert _request(f"{base}/v1/query/nope")[0] == 404


def test_split_completed_events():
    r = LocalRunner(tpch_sf=0.001, device="cpu")
    seen = []
    r.events.register_split_listener(seen.append)
    r.execute("select count(*) from orders")
    assert seen and seen[0].table == "orders" and seen[0].batches >= 1


def test_drain_refuses_new_statements_and_reports_state():
    """PUT SHUTTING_DOWN: /v1/info reports the state, new statements get
    503 while a running one drains, then the server stops itself."""
    runner = _GatedRunner()
    srv = PrestoTpuServer(runner=runner)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert _request(base + "/v1/info")[2]["state"] == "ACTIVE"
        q = srv.create_query("slow", {})
        assert runner.started.wait(10)
        status, _, doc = _request(base + "/v1/info/state",
                                  json.dumps("SHUTTING_DOWN").encode(),
                                  "PUT")
        assert (status, doc) == (200, {"state": "SHUTTING_DOWN"})
        info = _request(base + "/v1/info")[2]
        assert info["state"] == "SHUTTING_DOWN"
        assert info["queries"] == {"RUNNING": 1}
        assert _request(base + "/v1/statement", b"select 1",
                        "POST")[0] == 503
        runner.gate.set()
        assert q.done.wait(10) and q.state == "FINISHED"
        assert q.next_page(0) == [[1]]
        assert q.next_page(1) is None      # the drain waits for this too
        deadline = time.time() + 10
        while srv._thread.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        assert not srv._thread.is_alive()
    finally:
        runner.gate.set()
        srv.stop()


# -- the server cases of tests/test_security.py --------------------------------

def test_server_basic_auth():
    from presto_tpu_torch.server.security import PasswordAuthenticator
    srv = PrestoTpuServer(
        runner=LocalRunner(tpch_sf=0.001, device="cpu"),
        authenticator=PasswordAuthenticator({"alice": "pw"}))
    with serving(srv) as base:
        url = f"{base}/v1/statement"
        status, hdrs, _ = _request(url, b"select 1", "POST")
        assert status == 401
        assert "Basic" in hdrs.get("WWW-Authenticate", "")
        cred = base64.b64encode(b"alice:pw").decode()
        status, _, doc = _request(url, b"select 1", "POST",
                                  {"Authorization": f"Basic {cred}"})
        assert status == 200
        assert "nextUri" in doc or doc.get("data") == [[1]]
        assert _request(f"{base}/v1/resourceGroup")[0] == 401


def test_jwt_bearer_against_statement_server():
    from presto_tpu_torch.server.security import JwtAuthenticator
    srv = StatementServer(LocalRunner(tpch_sf=0.001, device="cpu"),
                          jwt_authenticator=JwtAuthenticator("k3y"))
    with serving(srv) as base:
        tok = JwtAuthenticator.issue("k3y", "erin", exp=time.time() + 60)
        auth = {"Authorization": f"Bearer {tok}"}
        _, _, doc = _request(f"{base}/v1/statement", b"select 42", "POST",
                             auth)
        while "data" not in doc and "nextUri" in doc:
            _, _, doc = _request(doc["nextUri"], headers=auth)
        assert doc["data"] == [[42]]
        assert srv.runner.query_log[-1].user == "erin"
        status, _, _ = _request(f"{base}/v1/statement", b"select 1",
                                "POST", {"Authorization": "Bearer nope"})
        assert status == 401


# -- the server cases of tests/test_serving.py ---------------------------------

class _GatedRunner:
    """Answers every statement with one row; ``slow`` waits on the gate."""

    def __init__(self):
        from presto_tpu_torch.exec.local import QueryResult
        self.gate = threading.Event()
        self.started = threading.Event()
        self._result = QueryResult(["x"], [], [(1,)])

    def execute(self, sql, properties=None, user="", cancel_event=None):
        if sql == "slow":
            self.started.set()
            self.gate.wait(20)
        return self._result


def test_group_memory_via_protocol_query():
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    try:
        q = srv.create_query(
            "select l_returnflag, sum(l_quantity) from lineitem "
            "group by l_returnflag", {})
        assert q.done.wait(timeout=30)
        assert q.state == "FINISHED", q.error
        root = srv.resource_groups.roots["global"]
        assert root.memory_reserved == 0
        assert root.running == 0
    finally:
        srv.stop()


def test_failed_query_releases_admission_slot():
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    try:
        q = srv.create_query("select bogus_column from nation", {})
        assert q.done.wait(timeout=30)
        assert q.state == "FAILED"
        info = srv.resource_groups.info()[0]
        assert info["numRunning"] == 0 and info["numQueued"] == 0
        q2 = srv.create_query("select 1", {})
        assert q2.done.wait(timeout=30)
        assert q2.state == "FINISHED"
    finally:
        srv.stop()


def test_query_queued_timeout():
    runner = _GatedRunner()
    srv = PrestoTpuServer(runner=runner)   # serial default group
    try:
        q1 = srv.create_query("slow", {})
        assert runner.started.wait(10)
        q2 = srv.create_query("fast", {"query_queued_timeout": "0.3s"})
        assert q2.done.wait(timeout=10)
        assert q2.state == "FAILED"
        assert q2.error["errorName"] == "QUERY_QUEUED_TIMEOUT"
        assert q2.error["errorType"] == "INSUFFICIENT_RESOURCES"
        assert srv.resource_groups.info()[0]["numQueued"] == 0
        runner.gate.set()
        assert q1.done.wait(timeout=10)
        assert q1.state == "FINISHED"
    finally:
        runner.gate.set()
        srv.stop()


def test_queued_timeout_session_default_is_validated():
    from presto_tpu_torch.config import SessionPropertyError
    r = LocalRunner(tpch_sf=0.001, device="cpu")
    r.execute("set session query_queued_timeout = '250ms'")
    assert r.session.properties["query_queued_timeout"] == "250ms"
    with pytest.raises(SessionPropertyError):
        r.execute("set session query_queued_timeout = 'soon'")


def test_queue_full_is_a_429():
    runner = _GatedRunner()
    srv = PrestoTpuServer(runner=runner, resource_groups={
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 1,
                        "maxQueued": 1}],
        "selectors": [{"group": "g"}]})
    with serving(srv) as base:
        try:
            srv.create_query("slow", {})
            assert runner.started.wait(10)
            srv.create_query("queued", {})
            status, _, doc = _request(f"{base}/v1/statement", b"fast",
                                      "POST")
            assert status == 429
            assert doc["error"]["errorName"] == "QUERY_QUEUE_FULL"
        finally:
            runner.gate.set()


STRESS_GROUPS = {
    "rootGroups": [
        {"name": "root", "hardConcurrencyLimit": 8, "maxQueued": 1000,
         "subGroups": [
             {"name": "etl", "hardConcurrencyLimit": 8,
              "schedulingWeight": 2},
             {"name": "adhoc", "hardConcurrencyLimit": 8,
              "schedulingWeight": 1}]}],
    "selectors": [{"user": "etl-.*", "group": "root.etl"},
                  {"group": "root.adhoc"}]}

STRESS_SQL = [
    "select count(*) from lineitem where l_quantity > 25",
    "select l_returnflag, count(*) from lineitem "
    "group by l_returnflag order by l_returnflag",
    "select count(*) from orders where o_totalprice > 1000",
    "select n_name from nation order by n_name limit 3",
    "select r_name, count(*) from region group by r_name order by r_name",
    "select max(o_orderdate) from orders",
    "select count(distinct l_suppkey) from lineitem",
    "select sum(l_extendedprice * (1 - l_discount)) from lineitem "
    "where l_shipdate > date '1995-01-01'",
]


def test_concurrent_stress_parity_and_fairness():
    """32 mixed statements from concurrent clients of two groups equal
    the serial results, ride the plan cache, and drain both groups."""
    runner = LocalRunner(tpch_sf=0.001, device="cpu")
    srv = PrestoTpuServer(runner, resource_groups=STRESS_GROUPS)
    with serving(srv) as base:
        oracle = StatementClient(base, user="oracle")
        serial = {s: oracle.execute(s).rows for s in STRESS_SQL}
        h0 = _metric("plan_cache_hit_total")
        results, errors = {}, []
        lock = threading.Lock()

        def client(ci):
            user = f"etl-{ci}" if ci % 2 == 0 else f"adhoc-{ci}"
            sql = STRESS_SQL[ci % len(STRESS_SQL)]
            try:
                rows = StatementClient(base, user=user).execute(sql).rows
                with lock:
                    results.setdefault(sql, []).append(rows)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(f"{ci}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        total = 0
        for sql, outs in results.items():
            for rows in outs:
                assert rows == serial[sql], sql
                total += 1
        assert total == 32
        assert _metric("plan_cache_hit_total") > h0
        info = srv.resource_groups.info()[0]
        assert info["numRunning"] == 0 and info["numQueued"] == 0
        rows = runner.execute(
            "select \"group\", running, queued from "
            "system.runtime.resource_groups").rows
        assert {"root", "root.etl", "root.adhoc"} <= {r[0] for r in rows}
        from presto_tpu_torch._devtools import lockcheck
        assert lockcheck.ENABLED
        assert lockcheck.GRAPH.check() == [], lockcheck.GRAPH.check()


# -- tests/test_serving_cache.py and tests/test_resource_groups.py -------------

def test_result_cache_hit_releases_admission_slot_and_ctx():
    srv = PrestoTpuServer(
        LocalRunner(tpch_sf=0.001, device="cpu"),
        resource_groups={
            "rootGroups": [{"name": "g", "hardConcurrencyLimit": 2,
                            "softMemoryLimit": 1 << 30}],
            "selectors": [{"group": "g"}]})
    try:
        srv.runner.session.properties["result_cache"] = True
        h0 = _metric("result_cache_hit_total")
        for _ in range(2):
            q = srv.create_query("select count(*) from lineitem", {})
            assert q.done.wait(timeout=30)
            assert q.state == "FINISHED", q.error
        assert _metric("result_cache_hit_total") == h0 + 1
        info = srv.resource_groups.info()[0]
        assert info["numRunning"] == 0 and info["numQueued"] == 0
        assert info["memoryReservedBytes"] == 0
    finally:
        srv.stop()


def test_server_queues_second_query():
    runner = _GatedRunner()
    srv = PrestoTpuServer(runner=runner)
    try:
        q1 = srv.create_query("slow", {})
        q2 = srv.create_query("fast", {})
        deadline = time.time() + 10
        while q1.state != "RUNNING" and time.time() < deadline:
            time.sleep(0.02)
        assert q1.state == "RUNNING"
        time.sleep(0.3)
        assert q2.state == "QUEUED"
        runner.gate.set()
        assert q2.done.wait(timeout=10) and q1.done.wait(timeout=10)
        assert q1.state == "FINISHED" and q2.state == "FINISHED"
        info = srv.resource_groups.info()
        assert info[0]["numRunning"] == 0 and info[0]["numQueued"] == 0
    finally:
        runner.gate.set()
        srv.stop()


# -- tests/test_slo.py: the failpoint drill through the server -----------------

@pytest.fixture
def health_plane():
    from presto_tpu_torch.obs.slo import SLO
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()
    yield TIMESERIES, SLO
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()


def test_failpoint_latency_spike_pages_and_recovers(health_plane):
    """A latency failpoint on ``protocol.serve`` drives the group's burn
    through WARN then PAGE; clearing it recovers to OK after the
    hysteresis streak. The server records the per-group series itself.
    The objective is 250 ms (the reference's drill uses 100 ms) so a fast
    statement on a loaded test host stays well under it."""
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    TIMESERIES, SLO = health_plane
    runner = LocalRunner(tpch_sf=0.001, device="cpu")
    srv = PrestoTpuServer(runner, resource_groups={
        "rootGroups": [{"name": "sloe2e", "hardConcurrencyLimit": 4,
                        "slo": {"latencyTargetMs": 250.0,
                                "latencyObjective": 0.95,
                                "availabilityObjective": 0.99,
                                "windows": [5.0, 10.0]}}],
        "selectors": [{"group": "sloe2e"}]})
    sql = "select count(*) from nation"

    def run(n):
        for _ in range(n):
            q = srv.create_query(sql, {})
            assert q.done.wait(timeout=60)
            assert q.state == "FINISHED", q.error

    try:
        run(2)
        TIMESERIES.sample(now=100.0)
        FAILPOINTS.configure("protocol.serve", action="sleep",
                             sleep_s=0.5, times=1)
        run(9)
        TIMESERIES.sample(now=101.0)
        transitions = SLO.evaluate(now=101.0)
        assert [(t["from"], t["to"]) for t in transitions] == \
            [("OK", "WARN")]
        assert transitions[0]["rule"] == "latency_burn"
        FAILPOINTS.configure("protocol.serve", action="sleep",
                             sleep_s=0.5, times=None)
        run(4)
        FAILPOINTS.clear("protocol.serve")
        TIMESERIES.sample(now=115.0)
        transitions = SLO.evaluate(now=115.0)
        assert [(t["from"], t["to"]) for t in transitions] == \
            [("WARN", "PAGE")]
        assert SLO.state_of("sloe2e", "latency") == "PAGE"
        run(6)
        TIMESERIES.sample(now=130.0)
        assert SLO.evaluate(now=130.0) == []
        assert SLO.state_of("sloe2e", "latency") == "PAGE"
        TIMESERIES.sample(now=131.0)
        transitions = SLO.evaluate(now=131.0)
        assert [(t["from"], t["to"]) for t in transitions] == \
            [("PAGE", "OK")]
        assert SLO.state_of("sloe2e", "availability") == "OK"
        res = runner.execute("select from_state, to_state, rule from "
                             "system.runtime.alerts")
        lat = [(f, t) for f, t, r in res.rows if r == "latency_burn"]
        assert lat == [("OK", "WARN"), ("WARN", "PAGE"), ("PAGE", "OK")]
        res = runner.execute(
            "select objective, state, budget_remaining from "
            "system.runtime.slo where group_path = 'sloe2e'")
        states = {o: (s, b) for o, s, b in res.rows}
        assert states["latency"][0] == "OK"
        assert states["availability"] == ("OK", 1.0)
        res = runner.execute(
            "select name, kind from system.runtime.timeseries "
            "where name = 'serving_latency_seconds.sloe2e.p95'")
        assert res.rows and res.rows[0][1] == "histogram"
        assert _metric("serving_requests_total.sloe2e") >= 21
    finally:
        FAILPOINTS.clear("protocol.serve")
        srv.stop()


# -- test_explain_formats.py::test_ui_endpoints, the history endpoint ----------

def test_ui_endpoints():
    runner = LocalRunner(tpch_sf=0.001, device="cpu")
    srv = PrestoTpuServer(runner=runner)
    with serving(srv) as base:
        runner.execute("select 1")
        _, _, qs = _request(base + "/v1/query")
        assert qs and {"queryId", "state", "query",
                       "elapsedMs"} <= set(qs[0])
        html = urllib.request.urlopen(base + "/ui", timeout=10).read()
        assert b"presto-tpu" in html and b"/v1/query" in html


def test_history_endpoint_on_coordinator(health_plane):
    """The coordinator serves the windowed-history doc without auth; the
    route wins over the /v1/metrics prefix, which still serves the
    exposition."""
    TIMESERIES, _ = health_plane
    TIMESERIES.registry.counter("history_ep_total").inc(5)
    TIMESERIES.sample()
    TIMESERIES.registry.counter("history_ep_total").inc(5)
    TIMESERIES.sample()
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    with serving(srv) as base:
        status, _, doc = _request(
            f"{base}/v1/metrics/history?name=history_ep_total&window=300")
        assert status == 200
        assert doc["kind"] == "counter" and doc["points"]
        with urllib.request.urlopen(f"{base}/v1/metrics",
                                    timeout=10) as r:
            assert b"history_ep_total" in r.read()
        assert _request(f"{base}/v1/metrics/history")[0] == 400
        assert _request(
            f"{base}/v1/metrics/history?name=nope_total")[0] == 404
        status, _, slo = _request(f"{base}/v1/slo")
        assert status == 200 and isinstance(slo, dict)


# -- two faults of the reference the port repairs ------------------------------

def test_drain_after_an_inline_statement_stops_the_server():
    """The drain of ``begin_shutdown`` asks every query's page channel
    whether it is empty; an inline-lane statement's channel answers (in
    presto_tpu the drain thread dies on it and the server never stops)."""
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    srv.start()
    try:
        client = StatementClient(f"http://127.0.0.1:{srv.port}")
        _until_inline(client, "select 7", [[7]],
                      _metric("serving_inline_lane_total"))
        assert any(isinstance(q._pages, P._InlinePages)
                   for q in srv.queries.values())
        srv.begin_shutdown()
        deadline = time.time() + 10
        while srv._thread.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        assert not srv._thread.is_alive()
    finally:
        srv.stop()


def test_idle_pool_worker_keeps_no_statement_alive(monkeypatch):
    """A pooled worker that finished a statement holds no reference to
    it (its query, pages and admission) while it waits for the next."""
    import gc
    import weakref
    monkeypatch.setattr(P, "_PRODUCERS", P._ProducerPool(cap=1))
    runner = _GatedRunner()
    srv = PrestoTpuServer(runner=runner)
    try:
        q = srv.create_query("select 1", {})
        assert q.done.wait(10)
        ref = weakref.ref(q)
        srv.queries.clear()
        del q
        deadline = time.time() + 5
        while ref() is not None and time.time() < deadline:
            gc.collect()
            time.sleep(0.02)
        assert ref() is None
    finally:
        srv.stop()


# -- the cluster's endpoints (tests/test_obs_ops.py, tests/test_timeseries.py) -

@pytest.fixture(scope="module")
def worker_cluster():
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.server.worker import WorkerServer
    workers = [WorkerServer(tpch_sf=0.001, device="cpu") for _ in range(3)]
    for w in workers:
        w.start()
    runner = ClusterRunner([f"http://127.0.0.1:{w.port}" for w in workers],
                           tpch_sf=0.001, heartbeat=False, device="cpu")
    yield runner, workers
    for w in workers:
        w.stop()


def test_worker_metrics_endpoint(worker_cluster):
    from presto_tpu_torch.obs.exposition import parse_exposition
    runner, workers = worker_cluster
    runner.execute("select count(*) from nation")
    url = f"http://127.0.0.1:{workers[0].port}/v1/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    samples, types = parse_exposition(text)
    assert samples and types
    assert samples[("cluster_queries_total", ())] >= 1
    assert types["query_seconds"] == "histogram"
    assert text.rstrip().endswith("# EOF")


def test_coordinator_metrics_endpoint(worker_cluster):
    """The coordinator's /v1/metrics carries the node-labelled series
    federated from the three workers' heartbeats."""
    from presto_tpu_torch.obs.exposition import parse_exposition
    crunner, _ = worker_cluster
    crunner.execute("select count(*) from region")
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    with serving(srv) as base:
        with urllib.request.urlopen(f"{base}/v1/metrics",
                                    timeout=10) as resp:
            samples, types = parse_exposition(resp.read().decode())
    ups = [lbl for (n, lbl), v in samples.items() if n == "node_up"]
    assert len(ups) >= 3
    assert types["node_heartbeat_age_seconds"] == "gauge"


def test_history_endpoint_on_worker(health_plane):
    """A worker serves the windowed-history doc as the coordinator does;
    the route wins over the /v1/metrics prefix."""
    from presto_tpu_torch.server.worker import WorkerServer
    TIMESERIES, _ = health_plane
    TIMESERIES.registry.counter("history_ep_total").inc(5)
    TIMESERIES.sample()
    TIMESERIES.registry.counter("history_ep_total").inc(5)
    TIMESERIES.sample()
    w = WorkerServer(tpch_sf=0.001, device="cpu")
    w.start()
    try:
        base = f"http://127.0.0.1:{w.port}"
        status, _, doc = _request(
            f"{base}/v1/metrics/history?name=history_ep_total&window=300")
        assert status == 200
        assert doc["kind"] == "counter" and doc["points"]
        with urllib.request.urlopen(f"{base}/v1/metrics",
                                    timeout=10) as r:
            assert b"history_ep_total" in r.read()
        assert _request(f"{base}/v1/metrics/history")[0] == 400
        assert _request(
            f"{base}/v1/metrics/history?name=nope_total")[0] == 404
    finally:
        w.stop()


def test_protocol_suite_lock_graph_clean():
    """The front door's locks (producer pool, query pages and state,
    server, fleet member) are checked locks: every edge this module's
    statements, drains and stress recorded is in the process graph, which
    must hold no cycle and no guarded-field violation. Defined last:
    pytest runs a module in definition order."""
    from presto_tpu_torch._devtools import lockcheck
    assert lockcheck.ENABLED
    assert lockcheck.GRAPH.check() == [], lockcheck.GRAPH.check()
