"""The port's static-analysis plane (presto_tpu_torch/_devtools/analyze/):
the port's tree is green under its committed baseline, every baseline
entry has a reason and none is stale, a full scan stays inside the
reference's 30 s budget (tests/test_analyze.py), and each checker family
catches a bad fixture the test writes to ``tmp_path``. Last, the two
thread faults the lock checker found in the port, repaired: a worker's
announcer and a fleet member's heartbeat loop could land a beat after
their farewell."""
import json
import os
import textwrap
import threading
import time

import pytest

from presto_tpu_torch._devtools.analyze import (
    BASELINE_PATH, CHECKERS, caches, locks, registries, run, run_changed,
    tracing,
)
from presto_tpu_torch._devtools.analyze.base import (
    REPO, apply_baseline, load_baseline,
)


def _rules(findings):
    return {f.rule for f in findings}


def _write(root, rel, text):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return path


# -- the port's tree ----------------------------------------------------------

@pytest.fixture(scope="module")
def full_scan():
    """One full scan of the port's tree and its seconds."""
    t0 = time.monotonic()
    out = run(root=REPO)
    return out, time.monotonic() - t0


def test_port_tree_is_green_under_its_baseline(full_scan):
    (findings, suppressed, stale), _ = full_scan
    assert not findings, "\n" + "\n".join(f.render() for f in findings)
    assert not stale, f"stale baseline suppressions: {stale}"
    assert {f.ident for f in suppressed} == \
        set(load_baseline(BASELINE_PATH))


def test_every_baseline_entry_has_a_reason():
    with open(BASELINE_PATH) as f:
        doc = json.load(f)
    ids = [e["id"] for e in doc["suppressions"]]
    assert len(ids) == len(set(ids))
    for e in doc["suppressions"]:
        assert len(e.get("reason", "").split()) >= 8, e
        assert e["id"].split(":")[2].startswith("presto_tpu_torch/"), e


def test_cli_exits_zero_and_json_shape(capsys):
    from presto_tpu_torch._devtools.analyze.__main__ import main
    from presto_tpu_torch._devtools.analyze.metric_names import \
        main as metric_main
    assert main(["--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["findings"] == [] and doc["mode"] == "full"
    assert doc["suppressed"] >= len(load_baseline(BASELINE_PATH))
    assert doc["stale_suppressions"] == []
    assert metric_main([]) == 0


def test_checker_families_and_scopes():
    assert set(CHECKERS) == {"tracing", "locks", "registries", "caches"}
    scopes = (list(tracing.SCOPE) + list(locks.SCOPE)
              + [s.module for s in caches.SPECS]
              + list(caches.SWEEP_SCOPE) + list(caches.CONNECTOR_SCOPE)
              + [caches.FLEET_MODULE, registries.CONFIG_PY,
                 registries.FAILPOINTS_PY, registries.SLO_PY])
    for s in scopes:
        assert s.startswith("presto_tpu_torch/"), s
        assert os.path.exists(os.path.join(REPO, s)), s
    # the threaded modules of the cluster, spool, fleet and autoscaler
    for m in ("exec/spool.py", "exec/autoscale.py", "serving/fleet.py",
              "server/worker.py", "exec/discovery.py", "exec/cluster.py"):
        assert f"presto_tpu_torch/{m}" in locks.SCOPE, m
    assert {s.name for s in caches.SPECS} >= {
        "scancache", "plancache", "templates", "resultcache", "spool"}


def test_full_scan_stays_fast(full_scan):
    _, seconds = full_scan
    assert seconds < 30.0


# -- each checker catches its bad fixture -------------------------------------

def test_tracing_catches_unbracketed_syncs(tmp_path):
    path = _write(tmp_path, "presto_tpu_torch/ops/bad.py", '''
        import torch
        from ..obs import profiler
        from ..obs.trace import TRACER

        def bad(x, y, z):
            n = x.sum().item()
            rows = y.tolist()
            host = z.cpu()
            torch.cuda.synchronize()
            return n, rows, host

        def good(x):
            with TRACER.span("device-sync", what="count"):
                n = x.sum().item()
            with _sync_record("quota"):
                m = x.max().item()
            with profiler.blocking():
                torch.cuda.synchronize()
            return n, m, x.cpu(non_blocking=True)
        ''')
    fs = tracing.check_paths([path], str(tmp_path))
    assert _rules(fs) == {"unbracketed-sync"}
    assert sorted(f.symbol for f in fs) == [
        "bad.cpu", "bad.item", "bad.tolist", "bad.torch.cuda.synchronize"]
    assert tracing.check(str(tmp_path)) == fs


def test_locks_catch_cycle_unjoined_thread_and_global_write(tmp_path):
    path = _write(tmp_path, "presto_tpu_torch/exec/bad.py", '''
        import threading
        from .._devtools.lockcheck import checked_lock

        REGISTRY = {}

        class A:
            def __init__(self):
                self._a = checked_lock("bad.a")
                self._b = checked_lock("bad.b")
                self._thread = threading.Thread(target=self.loop)
                self._thread.start()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass

            def loop(self):
                pass

        def spawn():
            t = threading.Thread(target=print)
            t.start()

        def record(k, v):
            REGISTRY[k] = v
        ''')
    fs = locks.check_paths([path], str(tmp_path))
    assert _rules(fs) == {"lock-cycle", "unjoined-thread",
                          "unlocked-global-write"}
    cyc = [f for f in fs if f.rule == "lock-cycle"]
    assert [f.symbol for f in cyc] == ["bad.a->bad.b"]
    assert sorted(f.symbol for f in fs if f.rule == "unjoined-thread") \
        == ["A.__init__._thread", "spawn.t"]


def _registry_tree(root):
    _write(root, "presto_tpu_torch/config.py", '''
        def _sp(name, type_, default, doc):
            pass

        _sp("known_prop", "boolean", True, "read below")
        _sp("unused_prop", "boolean", True, "never read")

        CONFIG_KEYS = {"node.id": "id"}
        ENV_VARS = {"PRESTO_TPU_TORCH_KNOWN": "read below",
                    "PRESTO_TPU_TORCH_UNUSED": "never read"}

        def load(props):
            return props.get("node.id"), props.get("nodeid.typo")
        ''')
    _write(root, "presto_tpu_torch/exec/failpoints.py", '''
        SITES = {"scan.split": "a split", "unhit.site": "no hit"}
        ''')
    _write(root, "presto_tpu_torch/obs/slo.py", '''
        ALERT_RULES = {"latency_burn": "used", "unused_burn": "not"}

        def alert_rule(name):
            return name

        RULE = alert_rule("latency_burn")
        TYPO = alert_rule("latency_brun")
        ''')
    _write(root, "presto_tpu_torch/exec/user.py", '''
        import os
        from ..obs.metrics import REGISTRY
        from .failpoints import FAILPOINTS

        GOOD = REGISTRY.counter("good_total")
        NO_UNIT = REGISTRY.counter("queries_done")
        CLASH = REGISTRY.gauge("good_total")

        def f(session):
            a = session.properties.get("known_prop")
            b = session.properties.get("typo_prop")
            FAILPOINTS.hit("scan.split")
            FAILPOINTS.hit("scan.spilt")
            os.environ.get("PRESTO_TPU_TORCH_KNOWN")
            os.environ.get("PRESTO_TPU_TORCH_TYPO")
            return a, b
        ''')
    _write(root, "docs/torch_observability.md", '''
        # doc
        `good_total` and `documented_only_total`.

        ## Alert rules

        | Rule | Meaning |
        |---|---|
        | `latency_burn` | x |
        | `unused_burn` | x |
        ''')
    _write(root, "docs/torch_static_analysis.md", '''
        # doc

        ## Session-property table

        | Property | x |
        |---|---|
        | `known_prop` | x |

        ## Failpoint catalog

        | Site | x |
        |---|---|
        | `scan.split` | x |
        | `unhit.site` | x |

        ## Environment-variable table

        | Variable | x |
        |---|---|
        | `PRESTO_TPU_TORCH_KNOWN` | x |
        | `PRESTO_TPU_TORCH_UNUSED` | x |
        | `PRESTO_TPU_TORCH_GONE` | x |
        ''')


def test_registries_catch_every_drift(tmp_path):
    _registry_tree(tmp_path)
    fs = registries.check(str(tmp_path))
    got = {(f.rule, f.symbol) for f in fs}
    assert got == {
        ("bad-metric-name", "queries_done"),
        ("metric-type-conflict", "good_total"),
        ("metric-doc-drift", "documented_only_total"),
        ("unknown-session-prop", "typo_prop"),
        ("unused-session-prop", "unused_prop"),
        ("session-prop-doc-drift", "unused_prop"),
        ("unknown-failpoint-site", "scan.spilt"),
        ("unhit-failpoint-site", "unhit.site"),
        ("unknown-alert-rule", "latency_brun"),
        ("unused-alert-rule", "unused_burn"),
        ("unknown-config-key", "nodeid.typo"),
        ("unknown-env-var", "PRESTO_TPU_TORCH_TYPO"),
        ("unused-env-var", "PRESTO_TPU_TORCH_UNUSED"),
        ("env-var-doc-drift", "PRESTO_TPU_TORCH_GONE"),
    }, sorted(got)


_BAD_CACHE = '''
    import threading
    from collections import OrderedDict

    class BadCache:
        def __init__(self):
            self._entries = OrderedDict()
            self._epoch = 0
            self._lock = threading.Lock()

        @staticmethod
        def key(conn, table, columns, version):
            return (id(conn), table, tuple(columns))

        def put(self, key, value, epoch=None):
            with self._lock:
                self._entries[key] = value

    def cached_value(cache, stmt):
        plan = build_plan(stmt)
        epoch = cache.epoch()
        cache.put(("k",), plan, epoch=epoch)

    def build_plan(stmt):
        return stmt
    '''


def test_caches_catch_every_contract_violation(tmp_path):
    _write(tmp_path, "presto_tpu_torch/serving/bad.py", _BAD_CACHE)
    spec = caches.CacheSpec(
        name="bad", module="presto_tpu_torch/serving/bad.py",
        cache_class="BadCache", versions="key", key_fn="key",
        version_recheck_in=("put",), epoch_veto_in=("put",),
        orchestrations={"cached_value": ("build_plan",)},
        bounded_in=("put",))
    fs = caches.check_specs([spec], str(tmp_path))
    assert _rules(fs) == {
        "cache-plain-lock", "cache-key-missing-version",
        "cache-missing-version-recheck", "cache-missing-epoch-veto",
        "cache-epoch-after-deps", "cache-missing-invalidation-hook",
        "cache-unbounded"}
    # a cache-shaped class nobody declared
    und = caches._undeclared_findings(str(tmp_path), caches.SPECS)
    assert [(f.rule, f.symbol) for f in und] == [
        ("undeclared-cache", "BadCache")]


def test_caches_catch_silent_connector_writes_and_fleet_folds(tmp_path):
    _write(tmp_path, "presto_tpu_torch/connectors/bad.py", '''
        def notify_data_change(conn, table):
            pass

        class BadConnector:
            def data_version(self, table):
                return 0

            def _note(self, table):
                notify_data_change(self, table)

            def create_table(self, name, schema):
                self._note(name)

            def append(self, name, batch):
                pass
        ''')
    fs = caches.connector_findings(str(tmp_path))
    assert [(f.rule, f.symbol) for f in fs] == [
        ("connector-write-no-notify", "BadConnector.append")]
    _write(tmp_path, caches.FLEET_MODULE, '''
        class Member:
            def fold_bump(self, doc):
                self._seen[doc["k"]] = doc["seq"]
                self.spi.notify_data_change(None, doc["table"])

            def nudge(self, table):
                self.cache.invalidate(table)
        ''')
    fs = caches.fleet_findings(str(tmp_path))
    assert _rules(fs) == {"fleet-fold-seq-order", "fleet-fold-bypass"}


def test_baseline_suppresses_and_goes_stale(tmp_path):
    _write(tmp_path, "presto_tpu_torch/ops/bad.py", '''
        def f(x):
            return x.item()
        ''')
    fs = tracing.check(str(tmp_path))
    ident = fs[0].ident
    keep, dropped, stale = apply_baseline(fs, {ident: "accepted"})
    assert (keep, [d.ident for d in dropped], stale) == ([], [ident], [])
    keep, _, stale = apply_baseline([], {ident: "accepted"})
    assert stale == [ident]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"id": ident, "reason": "accepted"}]}))
    assert load_baseline(str(base)) == {ident: "accepted"}


def test_run_changed_scopes_to_the_given_files(tmp_path):
    """A changed file inside a scope is checked, one outside is not, and
    a changed declaring input falls back to the full scan."""
    keep, _, stale = run_changed(["presto_tpu_torch/exec/local.py"])
    assert keep == [] and stale == []
    _registry_tree(tmp_path)
    _write(tmp_path, "presto_tpu_torch/exec/local.py", '''
        def f(x):
            return x.item()
        ''')
    keep, _, _ = run_changed(["presto_tpu_torch/exec/local.py",
                              "README.md"], root=str(tmp_path),
                             baseline_path=os.devnull)
    assert [(f.rule, f.path) for f in keep] == [
        ("unbracketed-sync", "presto_tpu_torch/exec/local.py")]
    # a declaring input changed: the full two-way scan, the registry
    # tree's drift included
    keep, _, _ = run_changed([registries.CONFIG_PY], root=str(tmp_path),
                             baseline_path=os.devnull)
    assert "unused-session-prop" in _rules(keep)
    assert "unbracketed-sync" in _rules(keep)


# -- the thread faults the lock checker found, repaired -----------------------

def test_announcer_deregister_lands_after_the_last_beat(monkeypatch):
    """``deregister`` joins the announce loop before its ``GONE``: a beat
    in flight (captured ACTIVE, still sending) can no longer land after
    the farewell and announce the node back. Before the repair the loop
    thread was never joined and the last state a coordinator heard here
    was ACTIVE."""
    from presto_tpu_torch.exec.discovery import Announcer
    heard = []
    in_flight = threading.Event()

    def announce_once(self):
        state = self.state
        if state == "ACTIVE" and threading.current_thread() is \
                self._thread:
            in_flight.set()
            time.sleep(0.3)            # a slow coordinator
        heard.append(state)
        return True

    monkeypatch.setattr(Announcer, "announce_once", announce_once)
    a = Announcer("http://127.0.0.1:1", "w1", "http://127.0.0.1:2",
                  interval_s=0.01)
    a.start()
    assert in_flight.wait(timeout=10)
    a.deregister()
    assert heard[-1] == "GONE" and not a._thread.is_alive()
    time.sleep(0.4)
    assert heard[-1] == "GONE"


def test_fleet_leave_lands_after_the_last_heartbeat(monkeypatch):
    """``leave`` stops (and joins) the heartbeat loop before its
    ``leaving`` farewell, so peers never see a beat after it and count
    the member back in. Before the repair the farewell went first and
    the loop's beat in flight followed it."""
    from presto_tpu_torch.serving.fleet import FleetMember
    sent = []
    in_flight = threading.Event()

    def heartbeat_once(self, leaving=False):
        if not leaving:
            in_flight.set()
            time.sleep(0.3)
        sent.append("leaving" if leaving else "beat")

    monkeypatch.setattr(FleetMember, "heartbeat_once", heartbeat_once)
    m = FleetMember("c0", "http://127.0.0.1:1", peers=[],
                    heartbeat_s=0.01)
    m.start()
    assert in_flight.wait(timeout=10)
    m.leave()
    assert sent[-1] == "leaving" and not m._hb_thread.is_alive()
    time.sleep(0.4)
    assert sent[-1] == "leaving"
