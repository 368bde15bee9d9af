"""Config-directory boot, discovery, plugins and the authenticators of
presto_tpu_torch against presto_tpu: the port's counterparts of
tests/test_config_discovery.py (the worker-announce case included),
tests/test_plugin.py and the authenticator
cases of tests/test_security.py, plus parity of the parsed node config,
of the loaded catalogs and of both authenticators' tokens. Values are
held exactly; the SQL results are integers."""
import json
import sys
import textwrap
import time
import urllib.request

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)


def _write_etc(tmp_path, catalog_props, extra=""):
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "node.id = test-node\n"
        "coordinator=true\n"
        "# a comment\n"
        "session.catalog = tiny\n"
        "session.schema = t\n"
        "session.scan_threads = 3\n" + extra)
    for name, props in catalog_props.items():
        (etc / "catalog" / f"{name}.properties").write_text(props)
    return str(etc)


# -- tests/test_config_discovery.py --------------------------------------------

def test_load_catalogs_and_config(tmp_path):
    from presto_tpu_torch.config import load_catalogs, load_node_config
    etc = _write_etc(tmp_path, {
        "tiny": "connector.name=tpch\ntpch.scale-factor=0.01\n",
        "mem": "connector.name=memory\n",
    })
    cfg = load_node_config(etc)
    assert cfg.node_id == "test-node" and cfg.coordinator
    assert cfg.catalog == "tiny"
    assert cfg.session_defaults["scan_threads"] == "3"
    catalogs = load_catalogs(etc, device="cpu")
    assert set(catalogs.names()) >= {"tiny", "mem", "system"}
    assert abs(catalogs.get("tiny").sf - 0.01) < 1e-12


def test_catalog_file_errors(tmp_path):
    from presto_tpu_torch.config import load_catalogs
    etc = _write_etc(tmp_path, {"bad": "no_connector_name=1\n"})
    with pytest.raises(ValueError, match="missing connector.name"):
        load_catalogs(etc, device="cpu")
    etc2 = _write_etc(tmp_path / "b", {"odd": "connector.name=nope\n"})
    with pytest.raises(ValueError, match="unknown connector.name"):
        load_catalogs(etc2, device="cpu")


def test_orc_catalog_from_properties(tmp_path):
    from presto_tpu_torch.config import load_catalogs
    (tmp_path / "wh").mkdir()
    etc = _write_etc(tmp_path, {
        "warehouse": f"connector.name=orc\norc.root={tmp_path}/wh\n"})
    catalogs = load_catalogs(etc, device="cpu")
    assert catalogs.get("warehouse").root == f"{tmp_path}/wh"


def test_catalogs_of_every_factory_equal_reference(tmp_path):
    """The six factories mount the same catalogs, of the same kind and
    settings, in both packages."""
    from presto_tpu.config import load_catalogs as jload
    from presto_tpu_torch.config import CONNECTOR_FACTORIES, load_catalogs
    (tmp_path / "wh").mkdir()
    (tmp_path / "pq").mkdir()
    etc = _write_etc(tmp_path, {
        "tiny": "connector.name=tpch\ntpch.scale-factor=0.01\n",
        "ds": "connector.name=tpcds\ntpcds.scale-factor=0.01\n",
        "mem": "connector.name=memory\n",
        "wh": f"connector.name=orc\norc.root={tmp_path}/wh\n",
        "pq": f"connector.name=parquet\nparquet.root={tmp_path}/pq\n",
        "db": f"connector.name=sqlite\nsqlite.path={tmp_path}/x.db\n",
    })
    assert set(CONNECTOR_FACTORIES) >= {"tpch", "tpcds", "memory", "orc",
                                        "parquet", "sqlite"}
    got, want = load_catalogs(etc, device="cpu"), jload(etc)
    assert sorted(got.names()) == sorted(want.names())
    for name in got.names():
        assert type(got.get(name)).__name__ == \
            type(want.get(name)).__name__, name
    assert got.get("ds").sf == want.get("ds").sf == 0.01
    assert got.get("pq").root == want.get("pq").root


def test_query_via_config_loaded_runner(tmp_path):
    from presto_tpu_torch.config import load_catalogs, load_node_config
    from presto_tpu_torch.exec.runner import LocalRunner
    etc = _write_etc(tmp_path, {
        "tiny": "connector.name=tpch\ntpch.scale-factor=0.01\n"})
    cfg = load_node_config(etc)
    r = LocalRunner(catalogs=load_catalogs(etc, device="cpu"),
                    catalog=cfg.catalog, schema=cfg.schema, device="cpu")
    r.session.properties.update(cfg.session_defaults)
    assert r.execute("select count(*) from nation").rows == [(25,)]


ALL_KEYS = textwrap.dedent("""
    http-server.http.port=8123
    discovery.uri=http://127.0.0.1:9
    scan-cache.max-bytes=1000000
    result-cache.max-bytes=2000000
    spool.dir=/tmp/spool
    spool.max-bytes=300
    spool.backend=object
    spool.object.dir=/tmp/obj
    spool.object.put-latency-ms=5
    spool.object.get-latency-ms=7
    spool.object.bandwidth-mbps=100
    autoscale.enabled=true
    autoscale.min-workers=0
    autoscale.max-workers=3
    autoscale.scale-step=2
    autoscale.cooldown-s=1.5
    autoscale.interval-s=0.5
    failpoints=scan.decode=error
    timeseries.sample-interval-s=2
    timeseries.retention-points=10
    session.dense_grouping=false
""")


def test_node_config_parses_every_reference_key(tmp_path):
    from presto_tpu.config import load_node_config as jload
    from presto_tpu_torch.config import load_node_config
    etc = _write_etc(tmp_path, {}, extra=ALL_KEYS)
    got, want = vars(load_node_config(etc)), vars(jload(etc))
    assert got == want
    empty = tmp_path / "empty"
    empty.mkdir()
    assert vars(load_node_config(str(empty))) == vars(jload(str(empty)))


@pytest.mark.parametrize("key", ["spool.dir=/tmp/spool",
                                 "spool.max-bytes=300",
                                 "autoscale.enabled=true"])
def test_server_from_etc_refuses_unported_keys(tmp_path, key):
    """No key of the config is refused as unported any more. The
    ``spool.*`` keys configure exec/spool.py: the boot applies them to
    the process-wide store (restored afterwards, so later tests of this
    process see the default store). ``autoscale.enabled=true`` attaches
    and starts an ``AutoscaleController`` (exec/autoscale.py) whose
    policy is read from the ``autoscale.*`` keys and whose subprocess
    provider runs workers on the boot's device from the same etc
    directory, announcing to this server, whose runner is a
    ``ClusterRunner`` over the server's discovery (``min-workers=0``
    here: the boot seats no worker); ``GET /v1/autoscale`` returns its
    ``status()``."""
    from presto_tpu_torch.config import server_from_etc
    from presto_tpu_torch.exec.spool import SPOOL
    spool_dir = str(tmp_path / "spool")
    extra = key.replace("/tmp/spool", spool_dir) + "\n"
    if key.startswith("autoscale"):
        extra += ("autoscale.min-workers=0\nautoscale.max-workers=3\n"
                  "autoscale.scale-step=2\nautoscale.cooldown-s=1.5\n"
                  "autoscale.interval-s=30\n")
    etc = _write_etc(tmp_path, {
        "tiny": "connector.name=tpch\ntpch.scale-factor=0.01\n"},
        extra=extra)
    if key.startswith("autoscale"):
        from presto_tpu_torch.exec.autoscale import (AutoscaleController,
                                                     LocalProcessProvider)
        from presto_tpu_torch.exec.cluster import ClusterRunner
        srv, _ = server_from_etc(etc, port=0, device="cpu")
        srv.start()
        try:
            assert isinstance(srv.runner, ClusterRunner)
            assert srv.runner.discovery is srv.discovery
            assert srv.runner.device.type == "cpu"
            ctl = srv.autoscaler
            assert isinstance(ctl, AutoscaleController)
            assert isinstance(ctl.provider, LocalProcessProvider)
            assert ctl.provider.device.type == "cpu"
            assert ctl.provider.etc_dir == etc
            assert ctl.provider.coordinator_urls == [
                f"http://127.0.0.1:{srv.port}"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/v1/autoscale",
                    timeout=30) as resp:
                doc = json.loads(resp.read())
            assert doc["running"] is True
            assert doc["policy"] == {
                "minWorkers": 0, "maxWorkers": 3, "scaleStep": 2,
                "cooldownS": 1.5, "confirmEvals": 2, "intervalS": 30.0}
            assert doc["workers"] == [] and doc["streaks"] == {}
        finally:
            srv.stop()
            srv.runner.detector.stop()
        assert ctl.status()["running"] is False
        return
    local = SPOOL.local_store
    saved = (local._dir, local.max_bytes, SPOOL.object_store.max_bytes)
    try:
        srv, _ = server_from_etc(etc, port=0, device="cpu")
        srv.stop()
        if key.startswith("spool.dir"):
            assert SPOOL.local_store.directory == spool_dir
        else:
            assert SPOOL.usage()["max_bytes"] == 300
    finally:
        local._dir, local.max_bytes, SPOOL.object_store.max_bytes = saved


def test_server_from_etc(tmp_path):
    """Full coordinator bootstrap from a config directory: catalogs,
    session defaults, resource groups, the device of the runner."""
    etc = _write_etc(tmp_path, {
        "tiny": "connector.name=tpch\ntpch.scale-factor=0.01\n"},
        extra="autoscale.enabled=false\n")
    (tmp_path / "etc" / "resource-groups.json").write_text(json.dumps({
        "rootGroups": [{"name": "global", "hardConcurrencyLimit": 4,
                        "maxQueued": 10}],
        "selectors": [{"group": "global"}],
    }))
    from presto_tpu_torch.config import server_from_etc
    srv, cfg = server_from_etc(str(etc), device="cpu")
    assert srv.runner.device.type == "cpu"
    assert srv.runner.session.properties["scan_threads"] == 3
    assert srv.resource_groups.roots["global"].hard_concurrency_limit == 4
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/statement",
            data=b"select count(*) from nation", method="POST",
            headers={"X-Presto-User": "t"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            doc = json.loads(resp.read())
        data = doc.get("data")
        while doc.get("nextUri"):
            with urllib.request.urlopen(doc["nextUri"], timeout=30) as r:
                doc = json.loads(r.read())
            data = data or doc.get("data")
        assert data == [[25]]
    finally:
        srv.stop()


def test_announce_and_ttl():
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    d = DiscoveryNodeManager(ttl_s=0.2)
    d.announce("w1", "http://h1:1")
    d.announce("w2", "http://h2:2")
    assert d.active_urls() == ["http://h1:1", "http://h2:2"]
    time.sleep(0.3)
    d.announce("w2", "http://h2:2")
    assert d.active_urls() == ["http://h2:2"]
    infos = {n["nodeId"]: n for n in d.nodes()}
    assert infos["w1"]["active"] is False
    assert infos["w2"]["active"] is True


def test_discovery_roles_and_states_equal_reference():
    """The same announcement script through both packages' managers
    gives the same worker URLs, peers, states and node documents (ages
    aside)."""
    from presto_tpu.exec.discovery import DiscoveryNodeManager as J
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager as T
    script = [("w1", "http://h1:1", "ACTIVE", "worker"),
              ("c1", "http://c1:1", "ACTIVE", "coordinator"),
              ("w2", "http://h2:2", "SHUTTING_DOWN", "worker"),
              ("c2", "http://c2:2", "ACTIVE", "coordinator"),
              ("w3", "http://h3:3", "ACTIVE", "worker"),
              ("w3", "http://h3:3", "GONE", "worker")]
    out = []
    for mgr in (J(), T()):
        for args in script:
            mgr.announce(*args)
        out.append((mgr.active_urls(), mgr.peer_urls("http://c1:1"),
                    mgr.states(),
                    [{k: v for k, v in n.items() if k != "age_s"}
                     for n in mgr.nodes()]))
    assert out[0] == out[1]


def test_announcer_joins_and_leaves_a_statement_server():
    """A node's Announcer posts to the port's statement server: the node
    joins its discovery, drains, and leaves at once on deregister."""
    from presto_tpu_torch.exec.discovery import Announcer
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.server import PrestoTpuServer
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"))
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        ann = Announcer([base, "http://127.0.0.1:9"], "w1",
                        "http://127.0.0.1:7001", interval_s=0.1)
        ann.start()
        try:
            assert srv.discovery.active_urls() == ["http://127.0.0.1:7001"]
            ann.set_state("SHUTTING_DOWN")
            assert srv.discovery.states() == {
                "http://127.0.0.1:7001": "SHUTTING_DOWN"}
            with urllib.request.urlopen(f"{base}/v1/service",
                                        timeout=10) as r:
                services = json.loads(r.read())["services"]
            assert [s["nodeId"] for s in services] == ["w1"]
        finally:
            ann.deregister()
        assert srv.discovery.active_urls() == []
    finally:
        srv.stop()


def test_worker_announces_to_statement_server():
    """End to end: a worker joins a coordinator by announcement and a
    discovery-fed ClusterRunner schedules on it, in both packages."""
    from presto_tpu.exec.cluster import ClusterRunner as JCluster
    from presto_tpu.server.protocol import PrestoTpuServer as JServer
    from presto_tpu.server.worker import WorkerServer as JWorker
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server.worker import WorkerServer
    rows = []
    for srv, worker, make_runner in (
            (PrestoTpuServer(LocalRunner(tpch_sf=0.01, device="cpu")),
             WorkerServer(tpch_sf=0.01, device="cpu"),
             lambda d: ClusterRunner(discovery=d, tpch_sf=0.01,
                                     heartbeat=False, device="cpu")),
            (JServer(), JWorker(tpch_sf=0.01),
             lambda d: JCluster(discovery=d, tpch_sf=0.01,
                                heartbeat=False))):
        srv.start()
        worker.start()
        try:
            worker.start_announcing(f"http://127.0.0.1:{srv.port}",
                                    interval_s=0.5)
            deadline = time.time() + 10
            while not srv.discovery.active_urls() \
                    and time.time() < deadline:
                time.sleep(0.05)
            assert srv.discovery.active_urls() == [
                f"http://127.0.0.1:{worker.port}"]
            rows.append(make_runner(srv.discovery).execute(
                "select count(*) from nation").rows)
        finally:
            worker.stop()
            srv.stop()
    assert rows[0] == rows[1] == [(25,)]


# -- tests/test_plugin.py ------------------------------------------------------

PLUGIN_SOURCE = '''
import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Schema
from presto_tpu_torch.connectors.spi import (
    Connector, ConnectorMetadata, ConnectorSplitManager, PageSource,
    Split, TableStats,
)
from presto_tpu_torch.expr.functions import Val
from presto_tpu_torch.plugin import Plugin


class _Meta(ConnectorMetadata):
    def list_tables(self):
        return ["numbers"]

    def table_schema(self, table):
        return Schema([("n", T.BIGINT), ("squared", T.BIGINT)])

    def table_stats(self, table):
        return TableStats(row_count=100.0)


class _Splits(ConnectorSplitManager):
    def splits(self, table, desired=1):
        return [Split(table, (0, 100))]


class _PS(PageSource):
    def __init__(self, columns, rows, device):
        self.columns = columns
        self.rows = rows
        self.device = device

    def batches(self):
        n = np.arange(1, self.rows + 1, dtype=np.int64)
        cols = {"n": n, "squared": n * n}
        yield Batch.from_pydict(
            {c: (T.BIGINT, cols[c].tolist()) for c in self.columns},
            device=self.device)


class NumbersConnector(Connector):
    name = "numbers"

    def __init__(self):
        self._meta = _Meta()
        self._splits = _Splits()

    @property
    def metadata(self):
        return self._meta

    @property
    def split_manager(self):
        return self._splits

    def page_source(self, split, columns, pushdown=None,
                    rows_per_batch=1 << 17, *, device=None):
        return _PS(list(columns), split.info[1], device)


def _double_it(args, out_type):
    (a,) = args
    return Val(a.data * 2, a.valid, out_type)


class NumbersPlugin(Plugin):
    def get_connector_factories(self):
        return [("numbers", lambda props: NumbersConnector())]

    def get_scalar_functions(self):
        return [("double_it", _double_it, lambda arg_types: arg_types[0])]


PLUGIN = NumbersPlugin()
'''


@pytest.fixture()
def etc_with_plugin(tmp_path):
    plug_dir = tmp_path / "plugin"
    plug_dir.mkdir()
    (plug_dir / "torch_numbers_plugin.py").write_text(PLUGIN_SOURCE)
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(textwrap.dedent(f"""
        coordinator=true
        http-server.http.port=0
        plugin.dir={plug_dir}
    """))
    (etc / "catalog" / "nums.properties").write_text(
        "connector.name=numbers\n")
    (etc / "catalog" / "tiny.properties").write_text(
        "connector.name=tpch\ntpch.scale-factor=0.001\n")
    yield str(etc)
    if str(plug_dir) in sys.path:
        sys.path.remove(str(plug_dir))
    sys.modules.pop("torch_numbers_plugin", None)


def test_plugin_connector_and_function(etc_with_plugin):
    from presto_tpu_torch.config import load_catalogs, load_node_config
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.plugin import GLOBAL, load_plugins_from_config
    cfg = load_node_config(etc_with_plugin)
    plugins = load_plugins_from_config(cfg.props)
    assert len(plugins) == 1
    assert GLOBAL.installed[-1] == "torch_numbers_plugin:NumbersPlugin"
    catalogs = load_catalogs(etc_with_plugin, device="cpu")
    assert "nums" in catalogs.names()
    runner = LocalRunner(catalogs=catalogs, catalog="nums", device="cpu")
    rows = runner.execute(
        "select n, squared, double_it(n) d from nums.default.numbers "
        "where n <= 3 order by n").rows
    assert [tuple(int(v) for v in r) for r in rows] == [
        (1, 1, 2), (2, 4, 4), (3, 9, 6)]
    total = runner.execute(
        "select sum(double_it(n)) from nums.default.numbers").rows
    assert int(total[0][0]) == 2 * 100 * 101 // 2


def test_plugin_via_server_boot(etc_with_plugin):
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.config import server_from_etc
    srv, cfg = server_from_etc(etc_with_plugin, device="cpu")
    srv.start()
    try:
        c = StatementClient(f"http://127.0.0.1:{srv.port}")
        res = c.execute("select double_it(squared) from "
                        "nums.default.numbers where n = 5")
        assert res.rows[0][0] == 50
    finally:
        srv.stop()


def test_plugin_module_without_contract_rejected(tmp_path):
    from presto_tpu_torch.plugin import PluginManager
    (tmp_path / "torch_empty_mod.py").write_text("x = 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        with pytest.raises(ValueError, match="exposes no plugin"):
            PluginManager().load_module("torch_empty_mod")
    finally:
        sys.path.remove(str(tmp_path))


def test_plugin_discovery_forms(tmp_path):
    """get_plugin() and bare Plugin subclasses are found as in the
    reference; plugin.modules loads by module name."""
    from presto_tpu_torch.plugin import Plugin, PluginManager
    (tmp_path / "torch_factory_mod.py").write_text(
        "from presto_tpu_torch.plugin import Plugin\n"
        "class P(Plugin):\n    pass\n"
        "def get_plugin():\n    return P()\n")
    (tmp_path / "torch_subclass_mod.py").write_text(
        "from presto_tpu_torch.plugin import Plugin\n"
        "class A(Plugin):\n    pass\n"
        "class B(Plugin):\n    pass\n")
    sys.path.insert(0, str(tmp_path))
    try:
        pm = PluginManager()
        assert [type(p).__name__ for p in
                pm.load_module("torch_factory_mod")] == ["P"]
        got = pm.load_module("torch_subclass_mod")
        assert sorted(type(p).__name__ for p in got) == ["A", "B"]
        assert all(isinstance(p, Plugin) for p in got)
        assert pm.installed == ["torch_factory_mod:P",
                                "torch_subclass_mod:A",
                                "torch_subclass_mod:B"]
    finally:
        sys.path.remove(str(tmp_path))


# -- the authenticator cases of tests/test_security.py -------------------------

def test_password_authenticator(tmp_path):
    from presto_tpu_torch.server.security import PasswordAuthenticator
    auth = PasswordAuthenticator({"alice": "secret"})
    assert auth.authenticate("alice", "secret")
    assert not auth.authenticate("alice", "wrong")
    assert not auth.authenticate("bob", "secret")
    path = tmp_path / "passwords"
    path.write_text("# users\nbob:b:colon\n\ncarol:c\n")
    auth = PasswordAuthenticator(path=str(path))
    assert auth.users == {"bob": "b:colon", "carol": "c"}
    assert auth.authenticate("bob", "b:colon")


def test_jwt_authenticator_unit():
    from presto_tpu_torch.server.security import JwtAuthenticator
    tok = JwtAuthenticator.issue("s3cret", "dave", exp=time.time() + 60)
    auth = JwtAuthenticator("s3cret")
    assert auth.authenticate(tok) == "dave"
    assert auth.authenticate(tok + "x") is None
    assert JwtAuthenticator("other").authenticate(tok) is None
    expired = JwtAuthenticator.issue("s3cret", "dave", exp=time.time() - 1)
    assert auth.authenticate(expired) is None
    aud = JwtAuthenticator.issue("s3cret", "dave", aud="presto")
    assert JwtAuthenticator("s3cret", "presto").authenticate(aud) == "dave"
    assert JwtAuthenticator("s3cret", "nope").authenticate(aud) is None


def test_jwt_tokens_equal_reference():
    """Both packages mint the same token bytes and accept each other's."""
    from presto_tpu.server.security import JwtAuthenticator as J
    from presto_tpu_torch.server.security import JwtAuthenticator as T
    exp = 4102444800.0
    for args in (("k", "erin", exp, ""), ("k2", "dave", None, "presto")):
        tok = T.issue(*args)
        assert tok == J.issue(*args)
        aud = args[3]
        assert T(args[0], aud).authenticate(tok) == \
            J(args[0], aud).authenticate(tok) == args[1]
    none_alg = T.issue("k", "x").replace(
        T.issue("k", "x").split(".")[0], "eyJhbGciOiAibm9uZSJ9")
    assert T("k").authenticate(none_alg) is None
    assert J("k").authenticate(none_alg) is None
