"""Coordinator-fleet membership of presto_tpu_torch (serving/fleet.py):
the port's counterparts of tests/test_fleet.py.

Two statement servers ("coordinators") in one process, each over its own
LocalRunner (``device="cpu"``) and its own CatalogManager, share one
writable SQLite file: a write through A reaches B's template and result
entries only through the fleet's bump broadcast (``fold_bump`` ->
``spi.notify_data_change``), as between processes. The caches and the
metrics registry are process-wide, so counters are read as deltas. Each
case also runs the same statements through presto_tpu's servers over
their own SQLite file and holds the rows equal (integers, exactly)."""
import os
import sqlite3
import tempfile

import pytest

from presto_tpu_torch.client import FleetClient, StatementClient
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.spi import CatalogManager
from presto_tpu_torch.connectors.sqlite import SqliteConnector
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.server.protocol import PrestoTpuServer
from presto_tpu_torch.serving.fleet import FleetMember

import torch_parity  # noqa: F401  (one torch thread per worker)

CACHE_PROPS = {"plan_template_cache": True, "result_cache": True}


def _metric(name: str) -> float:
    for m in REGISTRY.snapshot():
        if m["name"] == name:
            return m["value"]
    return 0.0


def _make_runner(db_path: str) -> LocalRunner:
    cats = CatalogManager()
    cats.register("memory", MemoryConnector())
    cats.register("fleetdb", SqliteConnector(db_path))
    r = LocalRunner(catalogs=cats, catalog="fleetdb", device="cpu")
    r.session.properties.update(CACHE_PROPS)
    return r


def _start_pair(make_server, make_runner):
    db = os.path.join(tempfile.mkdtemp(prefix="fleet_test_"), "shared.db")
    servers = []
    for _ in range(2):
        srv = make_server(make_runner(db))
        srv.start()
        servers.append(srv)
    urls = [f"http://127.0.0.1:{s.port}" for s in servers]
    for i, srv in enumerate(servers):
        srv.enable_fleet(f"coord-{i}",
                         peers=[u for j, u in enumerate(urls) if j != i],
                         heartbeat_s=5.0)
    return servers, urls


@pytest.fixture()
def fleet_pair():
    """Two HTTP coordinators, fleet-enabled, over one SQLite file."""
    servers, urls = _start_pair(PrestoTpuServer, _make_runner)
    try:
        yield servers, urls
    finally:
        for srv in servers:
            srv.kill()


@pytest.fixture()
def reference_pair():
    """presto_tpu's fleet over its own SQLite file: the rows to hold."""
    from presto_tpu.connectors.memory import MemoryConnector as JMemory
    from presto_tpu.connectors.spi import CatalogManager as JCatalogs
    from presto_tpu.connectors.sqlite import SqliteConnector as JSqlite
    from presto_tpu.exec.runner import LocalRunner as JRunner
    from presto_tpu.server.protocol import PrestoTpuServer as JServer

    def make_runner(db):
        cats = JCatalogs()
        cats.register("memory", JMemory())
        cats.register("fleetdb", JSqlite(db))
        r = JRunner(catalogs=cats, catalog="fleetdb")
        r.session.properties.update(CACHE_PROPS)
        return r

    servers, urls = _start_pair(JServer, make_runner)
    try:
        yield urls
    finally:
        for srv in servers:
            srv.kill()


def _client(url):
    return StatementClient(url, user="fleet-test")


def _ref_client(url):
    from presto_tpu.client import StatementClient as JClient
    return JClient(url, user="fleet-test")


def test_remote_write_invalidates_before_next_hit(fleet_pair,
                                                  reference_pair):
    """Write through A -> B's template and result entries drop eagerly,
    before B's next lookup, and B's re-read equals an uncached run and
    the reference fleet's."""
    servers, urls = fleet_pair
    a, b = _client(urls[0]), _client(urls[1])
    ja, jb = _ref_client(reference_pair[0]), _ref_client(reference_pair[1])
    for c in (a, ja):
        c.execute("create table fleetdb.default.t1 as select 1 as x")
    sql = ("select count(*) as c, sum(x) as s "
           "from fleetdb.default.t1 where x < 100")
    h0 = _metric("result_cache_hit_total")
    r1 = b.execute(sql).rows
    r2 = b.execute(sql).rows
    assert r1 == r2 == [[1, 1]] == jb.execute(sql).rows
    assert _metric("result_cache_hit_total") == h0 + 1
    th0 = _metric("plan_template_cache_hit_total")
    b.execute("select count(*) as c, sum(x) as s "
              "from fleetdb.default.t1 where x < 200")
    assert _metric("plan_template_cache_hit_total") > th0

    ri0 = _metric("result_cache_invalidated_total")
    ti0 = _metric("plan_template_cache_invalidated_total")
    f0 = _metric("fleet_bump_fold_total")
    for c in (a, ja):
        c.execute("insert into fleetdb.default.t1 select 2 as x")
    # the bump POST rides A's write synchronously: B folded it before
    # A's statement finished
    assert _metric("fleet_bump_fold_total") > f0
    assert _metric("result_cache_invalidated_total") > ri0
    assert _metric("plan_template_cache_invalidated_total") > ti0
    h1 = _metric("result_cache_hit_total")
    got = b.execute(sql).rows
    assert got == [[2, 3]] == jb.execute(sql).rows
    assert _metric("result_cache_hit_total") == h1
    uncached = servers[1].runner.execute(sql, properties={
        "plan_template_cache": False, "result_cache": False}).rows
    assert got == [list(r) for r in uncached]


def test_dropped_broadcast_still_serves_correct_rows(fleet_pair):
    """With every broadcast dropped at the ``fleet.broadcast``
    failpoint, B never hears of A's write, but its hit-time
    data_version revalidation refuses the stale entry."""
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    _, urls = fleet_pair
    a, b = _client(urls[0]), _client(urls[1])
    a.execute("create table fleetdb.default.t2 as select 10 as x")
    sql = "select count(*) as c, sum(x) as s from fleetdb.default.t2"
    assert b.execute(sql).rows == [[1, 10]]
    h0 = _metric("result_cache_hit_total")
    assert b.execute(sql).rows == [[1, 10]]
    assert _metric("result_cache_hit_total") == h0 + 1

    FAILPOINTS.configure("fleet.broadcast", action="error",
                         message="chaos: broadcast dropped")
    try:
        d0 = _metric("fleet_bump_dropped_total")
        f0 = _metric("fleet_bump_fold_total")
        a.execute("insert into fleetdb.default.t2 select 20 as x")
        assert _metric("fleet_bump_dropped_total") > d0
        assert _metric("fleet_bump_fold_total") == f0
        assert b.execute(sql).rows == [[2, 30]]
    finally:
        FAILPOINTS.clear("fleet.broadcast")
    f1 = _metric("fleet_bump_fold_total")
    a.execute("insert into fleetdb.default.t2 select 30 as x")
    assert _metric("fleet_bump_fold_total") > f1
    assert b.execute(sql).rows == [[3, 60]]


def test_fold_is_deduped_and_catalog_checked():
    db = os.path.join(tempfile.mkdtemp(prefix="fleet_fold_"), "f.db")
    cats = CatalogManager()
    cats.register("fleetdb", SqliteConnector(db))
    m = FleetMember("coord-b", "http://127.0.0.1:0", catalogs=cats)
    doc = {"origin": "coord-a", "seq": 1, "connectorId": "fleetdb",
           "table": "t"}
    assert m.fold_bump(dict(doc)) is True
    s0 = _metric("fleet_bump_stale_total")
    assert m.fold_bump(dict(doc)) is False
    assert _metric("fleet_bump_stale_total") == s0 + 1
    assert m.fold_bump(dict(doc, seq=2)) is True
    u0 = _metric("fleet_bump_unknown_catalog_total")
    assert m.fold_bump(dict(doc, seq=3, connectorId="nosuch")) is False
    assert _metric("fleet_bump_unknown_catalog_total") == u0 + 1
    assert m.fold_bump(dict(doc, origin="coord-b", seq=9)) is False


def test_remote_bump_vs_local_insert_interleaving():
    """B runs a cacheable SELECT while a remote write (raw SQLite commit,
    then ``fold_bump``) lands at every schedulable seam: no interleaving
    may leave a stale entry."""
    from presto_tpu_torch._devtools.interleave import (
        explore, failpoints_as_points, point,
    )

    def make():
        db = os.path.join(tempfile.mkdtemp(prefix="fleet_race_"),
                          "race.db")
        r = _make_runner(db)
        member = FleetMember("coord-b", "http://127.0.0.1:0",
                             catalogs=r.session.catalogs)
        r.execute("create table fleetdb.default.rt as select 1 as x")
        sql = ("select count(*) as c, sum(x) as s "
               "from fleetdb.default.rt")

        def reader():
            r.execute(sql, properties=CACHE_PROPS)

        def remote_writer():
            point("remote.write")
            raw = sqlite3.connect(db)
            raw.execute("insert into rt values (2)")
            raw.commit()
            raw.close()
            point("remote.bump")
            member.fold_bump({"origin": "coord-a", "seq": 1,
                              "connectorId": "fleetdb", "table": "rt"})

        def check():
            got = r.execute(sql, properties=CACHE_PROPS).rows
            want = r.execute(sql, properties={
                "plan_template_cache": False,
                "result_cache": False}).rows
            if got != want:
                return f"stale cached rows {got} vs truth {want}"
            return None

        return [reader, remote_writer], check

    with failpoints_as_points(["plancache.plan", "resultcache.stamp"]):
        ex = explore(make, max_schedules=48, preemption_bound=2)
    assert ex.schedules, "explorer executed no schedules"
    ex.assert_clean()


def _heartbeat(origin, url, leaving=False):
    return {"origin": origin, "url": url, "leaving": leaving,
            "groups": {"serving": {"running": 7, "memory": 0}}}


def test_explicit_deregister_beats_the_staleness_grace():
    """A drained coordinator leaves the survivor's peers and federated
    counts the moment its ``leaving`` heartbeat folds, and is never
    declared lost; a killed one holds its share until the grace expires,
    then is declared lost exactly once."""
    survivor = FleetMember("coord-0", "http://127.0.0.1:9100",
                           staleness_grace_s=3600.0)
    lost0 = _metric("coordinator_lost_total")
    survivor.fold_heartbeat(_heartbeat("coord-drain",
                                       "http://127.0.0.1:9101"))
    survivor.fold_heartbeat(_heartbeat("coord-kill",
                                       "http://127.0.0.1:9102"))
    assert survivor.remote_running("serving") == 14
    assert set(survivor.peers()) == {"http://127.0.0.1:9101",
                                     "http://127.0.0.1:9102"}
    survivor.fold_heartbeat(_heartbeat("coord-drain",
                                       "http://127.0.0.1:9101",
                                       leaving=True))
    st = survivor.status()
    assert survivor.remote_running("serving") == 7
    assert st["peers"] == ["http://127.0.0.1:9102"]
    assert "coord-drain" not in st["remote"]
    assert st["lost"] == []
    assert _metric("coordinator_lost_total") == lost0
    survivor._sweep_lost()
    assert survivor.remote_running("serving") == 7
    assert "coord-kill" in survivor.status()["remote"]
    survivor.staleness_grace_s = 0.0
    survivor._sweep_lost()
    survivor._sweep_lost()
    st = survivor.status()
    assert st["lost"] == ["coord-kill"]
    assert survivor.remote_running("serving") == 0
    assert _metric("coordinator_lost_total") == lost0 + 1


def test_fleet_status_heartbeat_and_federated_admission(fleet_pair):
    """GET /v1/fleet lists the peer; a heartbeat carries B's per-group
    counts to A, whose admission sums them into the limit."""
    import json
    import urllib.request
    servers, urls = fleet_pair
    a, b = servers
    doc = json.loads(urllib.request.urlopen(f"{urls[0]}/v1/fleet",
                                            timeout=10).read())
    assert doc["nodeId"] == "coord-0" and doc["peers"] == [urls[1]]
    info = json.loads(urllib.request.urlopen(f"{urls[1]}/v1/info",
                                             timeout=10).read())
    assert info["nodeId"] == "coord-1"
    grp = b.resource_groups.roots["global"]
    adm = b.resource_groups.submit()
    try:
        assert adm.wait(5)
        b.fleet.heartbeat_once()
        assert a.fleet.remote_running("global") == 1
        assert a.fleet.status()["remote"]["coord-1"]["groups"][
            "global"]["running"] == 1
        assert grp.running == 1
        # A's serial default group is full fleet-wide: its own query
        # queues until B's count is released and heartbeated
        q = a.create_query("select 1", {})
        assert not q.done.wait(0.3) and q.state == "QUEUED"
    finally:
        adm.release()
    b.fleet.heartbeat_once()
    assert q.done.wait(10) and q.state == "FINISHED"


def test_fleet_client_fails_over_a_killed_coordinator(fleet_pair):
    servers, urls = fleet_pair
    fc = FleetClient(urls, user="fleet-test")
    try:
        assert fc.execute("select 1 as one").rows == [[1]]
        servers[0].kill()
        for _ in range(4):
            assert fc.execute("select 2 as two").rows == [[2]]
        assert fc.failovers_total >= 1
    finally:
        fc.close()
