"""Resource groups of presto_tpu_torch (server/resource_groups.py)
against presto_tpu: the cases of tests/test_resource_groups.py but the
statement server's (in tests/test_torch_protocol.py), each run on both
packages' managers, and the same
admission script holding every grant and every ``info()`` document
equal to the reference's (reference
execution/resourcegroups/InternalResourceGroup.java)."""
import importlib

import pytest

PKGS = ["presto_tpu_torch", "presto_tpu"]


def _rg(pkg):
    return importlib.import_module(f"{pkg}.server.resource_groups")


@pytest.fixture(params=PKGS)
def rg(request):
    return _rg(request.param)


def test_serial_default(rg):
    m = rg.ResourceGroupManager()
    a = m.submit(user="alice")
    b = m.submit(user="bob")
    assert a.granted and not b.granted
    a.release()
    assert b.granted
    b.release()


def test_concurrency_limit_and_queue(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 2,
                        "maxQueued": 2}],
        "selectors": [{"group": "g"}]})
    adms = [m.submit() for _ in range(4)]
    assert [a.granted for a in adms] == [True, True, False, False]
    with pytest.raises(rg.QueryQueueFullError):
        m.submit()
    adms[0].release()
    assert adms[2].granted and not adms[3].granted
    for a in adms[1:3]:
        a.release()
    assert adms[3].granted
    adms[3].release()


def test_parent_limit_gates_children(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "root", "hardConcurrencyLimit": 1,
                        "maxQueued": 10,
                        "subGroups": [
                            {"name": "a", "hardConcurrencyLimit": 5},
                            {"name": "b", "hardConcurrencyLimit": 5}]}],
        "selectors": [{"user": "a.*", "group": "root.a"},
                      {"group": "root.b"}]})
    a1 = m.submit(user="alice")
    b1 = m.submit(user="bob")
    assert a1.granted and not b1.granted   # root caps total at 1
    a1.release()
    assert b1.granted
    b1.release()


def test_weighted_fair_prefers_underweighted(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "root", "hardConcurrencyLimit": 2,
                        "maxQueued": 10,
                        "subGroups": [
                            {"name": "small", "hardConcurrencyLimit": 2,
                             "schedulingWeight": 1},
                            {"name": "big", "hardConcurrencyLimit": 2,
                             "schedulingWeight": 3}]}],
        "selectors": [{"source": "s", "group": "root.small"},
                      {"group": "root.big"}]})
    s1 = m.submit(source="s")
    g1 = m.submit()
    assert s1.granted and g1.granted
    s2 = m.submit(source="s")
    g2 = m.submit()
    # small releases -> small 0/1 is further below its share than big
    # 1/3, so its queued query gets the freed slot
    s1.release()
    assert s2.granted and not g2.granted
    g1.release()
    assert g2.granted
    for a in (s2, g2):
        a.release()


def test_selector_matching(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "r", "hardConcurrencyLimit": 10,
                        "subGroups": [
                            {"name": "etl", "hardConcurrencyLimit": 5},
                            {"name": "adhoc", "hardConcurrencyLimit": 5}]}],
        "selectors": [{"user": "etl-.*", "group": "r.etl"},
                      {"group": "r.adhoc"}]})
    a = m.submit(user="etl-nightly")
    b = m.submit(user="jane")
    assert a.group.path == "r.etl"
    assert b.group.path == "r.adhoc"
    a.release()
    b.release()


def test_release_of_queued_admission_frees_no_slot(rg):
    """Cancelling a QUEUED query removes it from the queue without
    granting (and leaking) a run slot."""
    m = rg.ResourceGroupManager()
    a = m.submit()
    b = m.submit()
    assert a.granted and not b.granted
    b.release()
    a.release()
    c = m.submit()
    assert c.granted
    c.release()
    info = m.info()[0]
    assert info["numRunning"] == 0 and info["numQueued"] == 0


def test_group_config_parses_serving_keys(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 4,
                        "softMemoryLimit": 1 << 30,
                        "hardMemoryLimit": 2 << 30,
                        "queryQueuedTimeout": "1.5s"}],
        "selectors": [{"group": "g"}]})
    g = m.roots["g"]
    assert g.soft_memory_limit == 1 << 30
    assert g.hard_memory_limit == 2 << 30
    assert g.query_queued_timeout == 1.5
    info = m.info()[0]
    assert info["softMemoryLimitBytes"] == 1 << 30
    assert info["memoryReservedBytes"] == 0
    assert info["state"] == "CAN_RUN"


def test_over_soft_memory_queues_until_release(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 8,
                        "softMemoryLimit": 100}],
        "selectors": [{"group": "g"}]})
    g = m.roots["g"]
    a = m.submit()
    assert a.granted
    with m.memory_lock:
        g.memory_reserved = 150
    assert m.info()[0]["state"] == "OVER_SOFT_MEMORY_LIMIT"
    b = m.submit()
    assert not b.granted
    with m.memory_lock:
        g.memory_reserved = 0
    m._dispatch()
    assert b.granted
    b.release()
    a.release()


def test_queued_timeout_and_duration_parsing(rg):
    """A queued admission past its deadline times out and frees its
    queue slot; durations parse as the reference's
    ``parse_duration_s``."""
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 1,
                        "queryQueuedTimeout": "20ms"}],
        "selectors": [{"group": "g"}]})
    a = m.submit()
    b = m.submit()
    assert b.queued_timeout_s() == pytest.approx(0.02)
    assert b.queued_timeout_s("2m") == 120.0
    assert not b.wait(b.queued_timeout_s())
    b.time_out()
    assert m.info()[0]["numQueued"] == 0
    a.release()
    with pytest.raises(ValueError):
        rg.ResourceGroupManager({"rootGroups": [
            {"name": "g", "queryQueuedTimeout": "soon"}]})


def test_slo_block_validation(rg):
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 2,
                        "slo": {"latencyTargetMs": 500,
                                "latencyObjective": 0.95,
                                "windows": [3600, 300]}}],
        "selectors": [{"group": "g"}]})
    assert m.info()[0]["slo"] == {"latencyObjective": 0.95,
                                  "latencyTargetMs": 500.0,
                                  "windows": [300.0, 3600.0]}
    for bad in ({"latencyObjective": 0.9},
                {"availabilityObjective": 1.5}, {}, {"windows": [1]}):
        with pytest.raises(ValueError):
            rg.ResourceGroupManager({"rootGroups": [
                {"name": "g", "slo": bad}]})


def _script(pkg):
    """One admission script: grants after each step and every info()."""
    rg = _rg(pkg)
    m = rg.ResourceGroupManager({
        "rootGroups": [{"name": "root", "hardConcurrencyLimit": 3,
                        "maxQueued": 20, "softMemoryLimit": 1000,
                        "subGroups": [
                            {"name": "dash", "hardConcurrencyLimit": 2,
                             "schedulingWeight": 2},
                            {"name": "etl", "hardConcurrencyLimit": 2,
                             "schedulingWeight": 1,
                             "hardMemoryLimit": 800}]}],
        "selectors": [{"user": "etl-.*", "group": "root.etl"},
                      {"group": "root.dash"}]})
    trace = []
    adms = []
    for i, user in enumerate(["etl-a", "bob", "etl-b", "carol", "etl-c",
                              "dave", "erin"]):
        adms.append(m.submit(user=user))
        trace.append([a.granted for a in adms])
    for i in (1, 0, 3, 2):
        adms[i].release()
        trace.append([a.granted for a in adms])
        trace.append(m.info())
    for a in adms:
        a.release()
    trace.append(m.info())
    return trace


def test_admission_script_equals_reference():
    assert _script("presto_tpu_torch") == _script("presto_tpu")
