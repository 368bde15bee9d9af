"""The port's elasticity control loop (presto_tpu_torch/exec/autoscale.py)
against presto_tpu's.

The 17 tests of tests/test_autoscale.py run on both packages, with the
same injected signals and fake providers: rule-registry parity with the
watcher, hysteresis, cooldown, bounded steps, the PAGE-never-scale-down
invariant re-checked at apply time, drain-never-kill scale-down,
launch-before-drain node replacement and coordinator-tier routing for
admission-bound groups. Then parity: ``decide(demo_signals())`` of both
packages gives equal decision lists, and both controllers driven tick by
tick through one seeded sequence of 40 snapshots apply and block the
same actions, call their providers the same way and end with equal
``status()``. Last the port's providers on the CPU: in-process workers
launched, drained and terminated, and one real subprocess worker
(``--device cpu``) that announces, drains and exits by itself."""
import importlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

PACKAGES = ("presto_tpu", "presto_tpu_torch")


class _Pkg:
    """One package's autoscale and signals modules."""

    def __init__(self, name: str):
        self.name = name
        self.autoscale = importlib.import_module(f"{name}.exec.autoscale")
        self.signals = importlib.import_module(f"{name}.obs.signals")
        self.metrics = importlib.import_module(f"{name}.obs.metrics")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _Pkg(request.param)


def _fake_provider(pkg, n: int = 1):
    """Ledger provider: every controller call is recorded, drains can be
    forced to fail, nothing real happens."""
    A = pkg.autoscale

    class FakeProvider(A.NodeProvider):
        def __init__(self):
            self._seq = 0
            self._handles = []
            self.calls = []
            self.drain_ok = True
            for _ in range(n):
                self.launch()
                self.calls.clear()

        def launch(self):
            self._seq += 1
            h = A.NodeHandle(f"w{self._seq}",
                             f"http://127.0.0.1:{7000 + self._seq}")
            self._handles.append(h)
            self.calls.append(("launch", h.node_id))
            return h

        def nodes(self):
            return list(self._handles)

        def drain(self, handle, timeout_s: float = 30.0):
            self.calls.append(("drain", handle.node_id))
            if self.drain_ok:
                self._handles.remove(handle)
            return self.drain_ok

        def terminate(self, handle):
            self.calls.append(("terminate", handle.node_id))
            if handle in self._handles:
                self._handles.remove(handle)

    return FakeProvider()


def _signals(pkg, groups=(), nodes=(), caches=None):
    S = pkg.signals
    return S.ClusterSignals(ts=0.0, groups=tuple(groups),
                            nodes=tuple(nodes),
                            caches=caches or S.CacheSignals())


def _busy(pkg, group="serving", queued=40, running=8, limit=8,
          alert="OK"):
    return pkg.signals.GroupSignals(
        group=group, state="FULL", running=running, queued=queued,
        hard_concurrency_limit=limit, alert_state=alert)


def _idle(pkg, group="batch", alert="OK"):
    return pkg.signals.GroupSignals(
        group=group, state="CAN_RUN", running=0, queued=0,
        hard_concurrency_limit=16, error_budget_remaining=1.0,
        alert_state=alert)


def _node(pkg, node_id, age, active):
    return pkg.signals.NodeSignals(node_id, "active", age, active)


def _controller(pkg, provider, **policy):
    A = pkg.autoscale
    policy.setdefault("confirm_evals", 2)
    policy.setdefault("cooldown_s", 30.0)
    return A.AutoscaleController(provider, A.AutoscalePolicy(**policy),
                                 signals_fn=lambda: _signals(pkg))


# -- the watcher is a shim over the rule registry ----------------------------

def test_watcher_is_a_shim_over_the_controller_rules():
    from presto_tpu_torch._devtools import autoscale_watch as watch
    from presto_tpu_torch.exec import autoscale
    assert watch.decide is autoscale.decide
    assert watch.demo_signals is autoscale.demo_signals
    assert watch.RULES is autoscale.RULES


def test_watcher_demo_cli(capsys):
    from presto_tpu_torch._devtools import autoscale_watch as watch
    assert watch.main(["--demo"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert (doc["groups"], doc["nodes"]) == (3, 2)
    assert [d["action"] for d in doc["decisions"]] == [
        "scale_up", "scale_up", "scale_down", "replace_node",
        "grow_cache"]


def test_rules_registry_covers_every_action(pkg):
    assert sorted(pkg.autoscale.RULES) == [
        "grow_cache", "replace_node", "scale_coordinator",
        "scale_down", "scale_up"]


def test_demo_signals_decision_contract(pkg):
    A = pkg.autoscale
    by_action = {}
    for d in A.decide(A.demo_signals()):
        by_action.setdefault(d["action"], []).append(d["target"])
    assert by_action["scale_up"] == ["serving.dash", "serving.adhoc"]
    assert by_action["scale_down"] == ["batch"]
    assert by_action["replace_node"] == ["w1"]
    assert by_action["grow_cache"] == ["scan_cache"]
    assert "serving.adhoc" not in by_action["scale_down"]


def test_demo_decisions_equal_the_reference():
    from presto_tpu.exec import autoscale as ref
    from presto_tpu_torch.exec import autoscale as port
    want = ref.decide(ref.demo_signals())
    got = port.decide(port.demo_signals())
    assert got == want
    assert [d["action"] for d in got] == [
        "scale_up", "scale_up", "scale_down", "replace_node",
        "grow_cache"]
    assert port.DEFAULT_RULE_CONFIG == ref.DEFAULT_RULE_CONFIG


# -- hysteresis / cooldown / bounds ------------------------------------------

def test_hysteresis_one_snapshot_moves_nothing(pkg):
    prov = _fake_provider(pkg, n=1)
    ctl = _controller(pkg, prov, confirm_evals=3)
    sig = _signals(pkg, groups=[_busy(pkg)],
                   nodes=[_node(pkg, "w1", 1.0, 4)])
    for tick in range(2):
        rep = ctl.evaluate(signals=sig, now=float(tick))
        assert rep["applied"] == []
        assert rep["blocked"][0]["blocked"] == "hysteresis"
        assert prov.calls == []
    rep = ctl.evaluate(signals=sig, now=2.0)
    assert [a["action"] for a in rep["applied"]] == ["scale_up"]
    assert ("launch", "w2") in prov.calls


def test_streak_resets_when_recommendation_stops(pkg):
    prov = _fake_provider(pkg, n=1)
    ctl = _controller(pkg, prov, confirm_evals=2)
    busy = _signals(pkg, groups=[_busy(pkg)])
    calm = _signals(pkg, groups=[_busy(pkg, queued=0, running=1)])
    ctl.evaluate(signals=busy, now=0.0)
    ctl.evaluate(signals=calm, now=1.0)
    rep = ctl.evaluate(signals=busy, now=2.0)
    assert rep["applied"] == []
    assert prov.calls == []


def test_cooldown_spaces_applied_actions(pkg):
    prov = _fake_provider(pkg, n=1)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=30.0,
                      max_workers=8)
    sig = _signals(pkg, groups=[_busy(pkg)])
    assert ctl.evaluate(signals=sig, now=0.0)["applied"]
    rep = ctl.evaluate(signals=sig, now=5.0)
    assert rep["applied"] == []
    assert rep["blocked"][0]["blocked"] == "cooldown"
    assert ctl.evaluate(signals=sig, now=31.0)["applied"]


def test_bounds_clamp_scale_up_and_down(pkg):
    prov = _fake_provider(pkg, n=2)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0,
                      min_workers=2, max_workers=2)
    rep = ctl.evaluate(signals=_signals(pkg, groups=[_busy(pkg)]),
                       now=0.0)
    assert rep["blocked"][0]["blocked"] == "bounds"
    rep = ctl.evaluate(signals=_signals(pkg, groups=[_idle(pkg)]),
                       now=1.0)
    assert rep["blocked"][0]["blocked"] == "bounds"
    assert prov.calls == []
    assert len(prov.nodes()) == 2


# -- the invariants -----------------------------------------------------------

def test_page_anywhere_holds_every_scale_down(pkg):
    prov = _fake_provider(pkg, n=3)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0)
    sig = _signals(pkg, groups=[_idle(pkg, "batch"),
                                _busy(pkg, "dash", alert="PAGE")])
    for tick in range(3):
        rep = ctl.evaluate(signals=sig, now=float(tick))
        down = [b for b in rep["blocked"]
                if b["action"] == "scale_down"]
        assert down and down[0]["blocked"] == "page-held"
    assert ("drain", "w1") not in prov.calls
    assert ("drain", "w2") not in prov.calls
    assert len(prov.nodes()) >= 3


def test_scale_down_is_always_a_drain_never_a_kill(pkg):
    prov = _fake_provider(pkg, n=3)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0)
    rep = ctl.evaluate(signals=_signals(pkg, groups=[_idle(pkg)]),
                       now=0.0)
    assert [a["action"] for a in rep["applied"]] == ["scale_down"]
    assert {c[0] for c in prov.calls} == {"drain"}, prov.calls


def test_stuck_drain_blocks_instead_of_escalating(pkg):
    prov = _fake_provider(pkg, n=3)
    prov.drain_ok = False
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0)
    rep = ctl.evaluate(signals=_signals(pkg, groups=[_idle(pkg)]),
                       now=0.0)
    assert rep["applied"] == []
    assert rep["blocked"][0]["blocked"] == "drain-failed"
    assert ("terminate", "w1") not in prov.calls
    assert len(prov.nodes()) == 3


def test_replace_node_launches_capacity_first(pkg):
    prov = _fake_provider(pkg, n=2)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0,
                      max_workers=8)
    sig = _signals(pkg, nodes=[_node(pkg, "w1", 120.0, 0)])
    rep = ctl.evaluate(signals=sig, now=0.0)
    assert [a["action"] for a in rep["applied"]] == ["replace_node"]
    assert prov.calls.index(("launch", "w3")) \
        < prov.calls.index(("drain", "w1"))


def test_replace_node_terminates_only_a_corpse(pkg):
    prov = _fake_provider(pkg, n=2)
    prov.drain_ok = False
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0)
    ctl.evaluate(signals=_signals(pkg, nodes=[_node(pkg, "w1", 120.0, 0)]),
                 now=0.0)
    assert ("terminate", "w1") in prov.calls


def test_victim_selection_prefers_idle_nodes(pkg):
    prov = _fake_provider(pkg, n=3)
    ctl = _controller(pkg, prov, confirm_evals=1, cooldown_s=0.0)
    sig = _signals(pkg, groups=[_idle(pkg)],
                   nodes=[_node(pkg, "w1", 1.0, 5),
                          _node(pkg, "w2", 1.0, 0),
                          _node(pkg, "w3", 1.0, 2)])
    ctl.evaluate(signals=sig, now=0.0)
    assert ("drain", "w2") in prov.calls
    assert ("drain", "w1") not in prov.calls


# -- coordinator-tier routing -------------------------------------------------

def _admission_bound(pkg):
    return _signals(pkg, groups=[_busy(pkg, queued=40, running=8, limit=8)],
                    nodes=[_node(pkg, "w1", 1.0, 0),
                           _node(pkg, "w2", 1.0, 1)])


def test_admission_bound_routes_to_coordinator_scaler(pkg):
    A = pkg.autoscale

    class Scaler:
        def __init__(self):
            self.reasons = []

        def scale_up(self, reason):
            self.reasons.append(reason)
            return True

    scaler = Scaler()
    ctl = A.AutoscaleController(
        _fake_provider(pkg, n=2),
        A.AutoscalePolicy(confirm_evals=1, cooldown_s=0.0, max_workers=2),
        signals_fn=lambda: _signals(pkg), coordinator_scaler=scaler)
    rep = ctl.evaluate(signals=_admission_bound(pkg), now=0.0)
    assert "scale_coordinator" in {a["action"] for a in rep["applied"]}
    assert scaler.reasons and "admission-bound" in scaler.reasons[0]


def test_admission_bound_without_scaler_blocks(pkg):
    ctl = _controller(pkg, _fake_provider(pkg, n=2), confirm_evals=1,
                      cooldown_s=0.0, max_workers=2)
    rep = ctl.evaluate(signals=_admission_bound(pkg), now=0.0)
    blocked = {b["action"]: b["blocked"] for b in rep["blocked"]}
    assert blocked["scale_coordinator"] == "no-scaler"


# -- observability ------------------------------------------------------------

def test_status_surface_reports_policy_and_streaks(pkg):
    ctl = _controller(pkg, _fake_provider(pkg, n=1), confirm_evals=3)
    ctl.evaluate(signals=_signals(pkg, groups=[_busy(pkg)]), now=0.0)
    st = ctl.status()
    assert st["running"] is False
    assert st["policy"]["confirmEvals"] == 3
    assert st["streaks"].get("scale_up:serving") == 1
    assert st["workers"][0]["nodeId"] == "w1"


def test_controller_actions_are_counted(pkg):
    reg = pkg.metrics.REGISTRY
    ctl = _controller(pkg, _fake_provider(pkg, n=1), confirm_evals=1,
                      cooldown_s=0.0, max_workers=8)
    name = "autoscale_actions_total.scale_up"
    before = reg.counter(name).value
    e0 = reg.counter("autoscale_evaluations_total").value
    ctl.evaluate(signals=_signals(pkg, groups=[_busy(pkg)]), now=0.0)
    assert reg.counter(name).value == before + 1
    assert reg.counter("autoscale_evaluations_total").value == e0 + 1


# -- the two controllers through one seeded sequence -------------------------

def _snapshot_specs(seed: int, ticks: int):
    """``ticks`` snapshot descriptions from one seed, in regimes of 1-4
    equal ticks. Each regime is a busy, admission-bound, idle or paging
    cluster with drawn sizes, and may add a stale node (named like the
    providers' handles) or a hot scan cache."""
    rng = np.random.default_rng(seed)
    specs = []
    while len(specs) < ticks:
        kind = str(rng.choice(["busy", "admission", "idle", "paging"]))
        limit = int(rng.choice([1, 4, 8]))
        n_nodes = int(rng.integers(1, 4))
        group = dict(group="serving.dash", state="FULL", running=limit,
                     queued=int(rng.integers(2, 4)) * limit,
                     hard_concurrency_limit=limit,
                     error_budget_remaining=None, alert_state="OK")
        active = int(rng.integers(2, 5))
        groups = [group]
        if kind == "admission":
            group["queued"] = int(rng.integers(4, 7)) * limit
            active = 0
        elif kind == "idle":
            group.update(state="CAN_RUN", running=0, queued=0,
                         error_budget_remaining=float(
                             rng.choice([1.0, 0.7, 0.2])))
        elif kind == "paging":
            group.update(queued=0, alert_state="PAGE")
            groups.append(dict(group="batch", state="CAN_RUN", running=0,
                               queued=0, hard_concurrency_limit=16,
                               error_budget_remaining=None,
                               alert_state="OK"))
        nodes = [dict(node_id=f"w{i + 1}", state="active",
                      heartbeat_age_s=1.0, active_tasks=active)
                 for i in range(n_nodes)]
        if rng.random() < 0.25:
            nodes[-1]["heartbeat_age_s"] = 95.0
        caches = dict(scan_cache_resident_bytes=int(
                          rng.choice([100, 950], p=[0.7, 0.3])),
                      scan_cache_limit_bytes=1000)
        spec = dict(groups=groups, nodes=nodes, caches=caches,
                    drain_ok=bool(rng.random() < 0.6))
        specs.extend([spec] * int(rng.integers(1, 5)))
    return specs[:ticks]


def _build(pkg, spec):
    S = pkg.signals
    return S.ClusterSignals(
        ts=0.0,
        groups=tuple(S.GroupSignals(**g) for g in spec["groups"]),
        nodes=tuple(S.NodeSignals(**n) for n in spec["nodes"]),
        caches=S.CacheSignals(**spec["caches"]))


def test_controllers_agree_tick_by_tick():
    """Both packages' controllers through one seeded sequence of 40
    snapshots (hysteresis 2, cooldown 3 ticks, bounds 1..4, a coordinator
    scaler that refuses every other call): equal reports every tick,
    equal provider calls and equal final status."""
    specs = _snapshot_specs(seed=20261024, ticks=40)
    runs = {}
    for name in PACKAGES:
        pkg = _Pkg(name)
        A = pkg.autoscale

        class Scaler:
            def __init__(self):
                self.calls = 0

            def scale_up(self, reason):
                self.calls += 1
                return self.calls % 2 == 0

        grown = []
        prov = _fake_provider(pkg, n=2)
        ctl = A.AutoscaleController(
            prov, A.AutoscalePolicy(min_workers=1, max_workers=4,
                                    scale_step=2, cooldown_s=3.0,
                                    confirm_evals=2),
            signals_fn=lambda: None, coordinator_scaler=Scaler(),
            on_grow_cache=grown.append)
        reports = []
        for tick, spec in enumerate(specs):
            prov.drain_ok = spec["drain_ok"]
            reports.append(ctl.evaluate(signals=_build(pkg, spec),
                                        now=float(tick)))
        runs[name] = (reports, prov.calls, ctl.status(), grown)
    ref, port = runs["presto_tpu"], runs["presto_tpu_torch"]
    for tick, (want, got) in enumerate(zip(ref[0], port[0])):
        assert got == want, tick
    assert port[1:] == ref[1:]
    applied = [a["action"] for r in port[0] for a in r["applied"]]
    blocked = {b["blocked"] for r in port[0] for b in r["blocked"]}
    # the sequence reaches every gate
    assert {"scale_up", "scale_down", "replace_node", "scale_coordinator",
            "grow_cache"} <= set(applied), applied
    assert {"hysteresis", "cooldown", "bounds", "page-held",
            "scaler-refused", "drain-failed"} <= blocked, blocked


# -- the port's providers on the CPU ------------------------------------------

def test_in_process_provider_launch_drain_terminate():
    from presto_tpu_torch.exec.autoscale import InProcessProvider
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    prov = InProcessProvider(discovery, tpch_sf=0.001, device="cpu")
    a, b = prov.launch(), prov.launch()
    try:
        assert a.server.device.type == "cpu"
        assert sorted(discovery.active_urls()) == sorted([a.url, b.url])
        assert prov.drain(a, timeout_s=30.0)
        assert a.server.stopped.is_set()
        assert discovery.active_urls() == [b.url]
        prov.terminate(b)
        assert prov.nodes() == [] and discovery.active_urls() == []
    finally:
        prov.stop_all()


def test_local_process_provider_worker_announces_drains_and_exits():
    """One real ``--device cpu`` subprocess worker: it announces to a
    statement server, serves a query through a ClusterRunner over that
    server's discovery, and after the drain its process exits by itself
    (code 0): the provider never kills it."""
    from presto_tpu_torch.exec.autoscale import LocalProcessProvider
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    from presto_tpu_torch.server import PrestoTpuServer
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    runner = ClusterRunner(tpch_sf=0.001, heartbeat=False,
                           discovery=discovery, device="cpu")
    srv = PrestoTpuServer(runner, discovery=discovery)
    srv.start()
    prov = LocalProcessProvider([f"http://127.0.0.1:{srv.port}"],
                                tpch_sf=0.001, device="cpu")
    try:
        h = prov.launch()
        assert "--device" in h.proc.args \
            and h.proc.args[h.proc.args.index("--device") + 1] == "cpu"
        deadline = time.time() + 60
        while h.url not in discovery.active_urls():
            assert time.time() < deadline and h.proc.poll() is None
            time.sleep(0.05)
        assert [n.node_id for n in prov.nodes()] == [h.node_id]
        assert runner.execute("select count(*) from nation").rows \
            == [(25,)]
        with urllib.request.urlopen(f"{h.url}/v1/info", timeout=10) as r:
            assert json.loads(r.read())["nodeId"] == h.node_id
        assert prov.drain(h, timeout_s=60.0)
        assert h.proc.returncode == 0
        assert prov.nodes() == []
        deadline = time.time() + 10
        while discovery.active_urls():
            assert time.time() < deadline, discovery.nodes()
            time.sleep(0.05)
    finally:
        prov.stop_all()
        srv.stop()
        runner.detector.stop()


def test_fleet_handle_is_the_coordinator_scaler(monkeypatch):
    """``_devtools/fleet.py`` on the CPU: two coordinator processes and a
    worker process (``--device cpu``) serve a statement through
    ``FleetClient``; an admission-bound snapshot makes the controller's
    ``scale_coordinator`` call the fleet's ``scale_up``, which spawns a
    third coordinator that peers in with the incumbents; ``scale_down``
    drains it back out (its process exits) and refuses to go below
    two."""
    from presto_tpu_torch._devtools.fleet import launch_fleet
    from presto_tpu_torch.client import FleetClient
    from presto_tpu_torch.exec import autoscale as A
    from presto_tpu_torch.obs import signals as S
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fleet = launch_fleet(n_coordinators=2, sf=0.001, workers=1,
                         heartbeat_s=0.2, device="cpu",
                         ready_timeout_s=120.0)
    try:
        assert [c["node_id"] for c in fleet.coordinators] == [
            "coord-0", "coord-1"]
        sql = "select count(*) from nation"
        fc = FleetClient(fleet.urls, user="fleet")
        assert fc.execute(sql).rows == [[25]]
        fc.close()
        ctl = A.AutoscaleController(
            _fake_provider(_Pkg("presto_tpu_torch"), n=2),
            A.AutoscalePolicy(confirm_evals=1, cooldown_s=0.0,
                              max_workers=2),
            signals_fn=lambda: None, coordinator_scaler=fleet)
        sig = S.ClusterSignals(
            ts=0.0, groups=(S.GroupSignals(
                group="serving.adhoc", state="FULL", running=8,
                queued=40, hard_concurrency_limit=8),),
            nodes=(S.NodeSignals("w1", "active", 1.0, 0),))
        # the controller ticks on its own thread: the scaler's launch
        # must work off the main thread
        reps = []
        t = threading.Thread(target=lambda: reps.append(
            ctl.evaluate(signals=sig, now=0.0)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and reps
        assert [a["action"] for a in reps[0]["applied"]] == \
            ["scale_coordinator"]
        assert len(fleet.live_urls()) == 3
        new = fleet.coordinators[-1]
        assert new["node_id"] == "coord-2"
        # the newcomer joins the fleet: its first heartbeats teach the
        # incumbents its URL
        deadline = time.time() + 60
        while not all(new["url"] in fleet.fleet_status(i)["peers"]
                      for i in (0, 1)):
            assert time.time() < deadline, fleet.fleet_status(0)
            time.sleep(0.1)
        assert sorted(fleet.fleet_status(2)["peers"]) == sorted(
            fleet.urls[:2])
        assert fleet.metrics(2)          # its /v1/metrics parses back
        assert fleet.scale_down("idle") is True
        assert new["proc"].returncode is not None
        assert len(fleet.live_urls()) == 2
        assert fleet.scale_down("idle") is False
    finally:
        fleet.stop()
    assert all(c["proc"].returncode is not None
               for c in fleet.coordinators + fleet.workers)


# -- faults of the reference that the port repairs ----------------------------

def _newcomer_sees(fleet, timeout_s):
    """Seconds until the last-added coordinator lists a worker in its
    ``/v1/fleet``, or None when it never does within ``timeout_s``."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if fleet.fleet_status(len(fleet.coordinators) - 1)["workers"]:
            return time.monotonic() - t0
        time.sleep(0.05)
    return None


def test_added_coordinator_sees_the_workers(monkeypatch):
    """A coordinator added by ``scale_up`` after the workers started:
    the port's workers follow the fleet's membership, so within the
    fleet's staleness grace the newcomer lists the worker and a SELECT
    sent to it returns the single-device rows. The reference's workers
    announce only to the coordinators named at their launch: its
    newcomer lists no worker for the same grace, and its SELECT fails."""
    import tools.fleet as jfleet
    from presto_tpu_torch._devtools.fleet import launch_fleet
    from presto_tpu_torch.client import QueryFailed, StatementClient
    from presto_tpu_torch.exec.runner import LocalRunner
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sql = "select n_regionkey, count(*) from nation group by 1 order by 1"
    want = [list(r) for r in
            LocalRunner(tpch_sf=0.001, device="cpu").execute(sql).rows]
    grace = 5.0
    jf = jfleet.launch_fleet(n_coordinators=2, sf=0.001, workers=1,
                             heartbeat_s=0.5, staleness_grace_s=grace,
                             ready_timeout_s=120.0)
    try:
        jf.scale_up("test")
        assert _newcomer_sees(jf, grace) is None       # the reference
        with pytest.raises(QueryFailed):
            StatementClient(jf.coordinators[-1]["url"]).execute(sql)
    finally:
        jf.stop()
    tf = launch_fleet(n_coordinators=2, sf=0.001, workers=1,
                      heartbeat_s=0.5, staleness_grace_s=grace,
                      device="cpu", ready_timeout_s=120.0)
    try:
        tf.scale_up("test")
        seen = _newcomer_sees(tf, grace)
        assert seen is not None and seen < grace
        assert StatementClient(tf.coordinators[-1]["url"]).execute(
            sql).rows == want
    finally:
        tf.stop()


def _etc_with_node_id_and_port(root, port):
    etc = root / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        f"node.id=etc-worker\nhttp-server.http.port={port}\n")
    (etc / "catalog" / "tpch.properties").write_text(
        "connector.name=tpch\ntpch.scale-factor=0.001\n")
    return str(etc)


def test_workers_from_one_etc_directory_get_their_own_id_and_port(
        tmp_path, monkeypatch):
    """Two workers launched by ``LocalProcessProvider`` from one etc
    directory that sets ``node.id`` and ``http-server.http.port``: the
    port names each worker and keeps the provider's ``--port 0``
    ephemeral, so both come up in discovery under distinct ids and
    ports. The reference's workers take the directory's id and, as
    ``0 or port`` drops the 0, its port: the first binds it under
    ``etc-worker`` and the second cannot start."""
    from presto_tpu.exec import autoscale as JA
    from presto_tpu_torch._devtools.fleet import _free_ports
    from presto_tpu_torch.exec.autoscale import LocalProcessProvider
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.server import PrestoTpuServer
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (port,) = _free_ports(1)
    etc = _etc_with_node_id_and_port(tmp_path, port)
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"),
                          discovery=discovery)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    jprov = JA.LocalProcessProvider([url], tpch_sf=0.001, etc_dir=etc,
                                    ready_timeout_s=60.0)
    try:
        first = jprov.launch()                         # the reference
        assert (first.node_id, first.url) == (
            "etc-worker", f"http://127.0.0.1:{port}")
        with pytest.raises(Exception):
            jprov.launch()
    finally:
        jprov.stop_all()
    prov = LocalProcessProvider([url], tpch_sf=0.001, etc_dir=etc,
                                device="cpu", ready_timeout_s=60.0)
    try:
        handles = [prov.launch(), prov.launch()]
        ids = {h.node_id for h in handles}
        urls = {h.url for h in handles}
        assert len(ids) == 2 and "etc-worker" not in ids
        assert len(urls) == 2 and f"http://127.0.0.1:{port}" not in urls
        deadline = time.time() + 60
        while not urls <= set(discovery.active_urls()):
            assert time.time() < deadline, discovery.nodes()
            time.sleep(0.05)
    finally:
        prov.stop_all()
        srv.stop()
