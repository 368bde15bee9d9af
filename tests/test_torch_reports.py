"""The port's SLO and mesh reports (presto_tpu_torch/_devtools/slo_report.py,
mesh_report.py) against the JAX package's tools/slo_report.py and
tools/mesh_report.py: their constants equal each other's and the port's
engine (obs/slo.py, obs/flight.py); both give the same verdicts, exit codes
and violation lists on every pinned SERVING_r*.json and MULTICHIP_r*.json
and on a corrupted copy of one of each; and the port's live blocks (a
statement server's ``GET /v1/slo``, alone and merged over a fleet of two,
and a 4-slot mesh query's flight attribution) pass."""
import copy
import glob
import json
import os

import pytest

from presto_tpu_torch._devtools import mesh_report as M
from presto_tpu_torch._devtools import slo_report as S
from tools import mesh_report as JM
from tools import slo_report as JS

import torch_parity  # noqa: F401  (one torch thread per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_PINS = sorted(glob.glob(os.path.join(ROOT, "SERVING_r*.json")))
MULTICHIP_PINS = sorted(glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")))


def test_constants_equal_reference_and_engine():
    from presto_tpu_torch.obs import flight, slo
    assert S.STATES == JS.STATES
    assert S.STATES == tuple(sorted(slo._RANK, key=slo._RANK.get))
    assert S.RULES == JS.RULES
    assert sorted(S.RULES) == sorted(slo.ALERT_RULES)
    assert S.OBJECTIVES == JS.OBJECTIVES
    assert M.BUCKETS == JM.BUCKETS == flight.BUCKETS
    assert M.BUCKET_BUDGET_PCT == JM.BUCKET_BUDGET_PCT
    assert S._REQUIRED == JS._REQUIRED and M._REQUIRED == JM._REQUIRED


def _load_both(port, ref, path):
    """Both tools' flattened pin, or both tools' error class."""
    out = []
    for mod in (port, ref):
        try:
            out.append(mod.load_pin(path))
        except (OSError, ValueError) as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("path", SERVING_PINS,
                         ids=[os.path.basename(p) for p in SERVING_PINS])
def test_slo_verdicts_equal_reference(path, capsys):
    got, want = _load_both(S, JS, path)
    assert got == want
    if isinstance(want, dict):
        assert S.validate_slo_block(got) == JS.validate_slo_block(want)
        assert S.render(got, S.validate_slo_block(got)) == \
            JS.render(want, JS.validate_slo_block(want))
    assert S.main([path]) == JS.main([path])
    assert S.latest_pin() == JS.latest_pin()


@pytest.mark.parametrize("path", MULTICHIP_PINS,
                         ids=[os.path.basename(p) for p in MULTICHIP_PINS])
def test_mesh_verdicts_equal_reference(path, capsys):
    got, want = _load_both(M, JM, path)
    assert got == want
    if isinstance(want, dict):
        assert M.validate_attribution(got) == JM.validate_attribution(want)
    old = MULTICHIP_PINS[-1]
    assert M.main([old, path]) == JM.main([old, path])
    if isinstance(want, dict) and isinstance(_load_both(M, JM, old)[1],
                                             dict):
        assert M.diff_pins(M.load_pin(old), got) == \
            JM.diff_pins(JM.load_pin(old), want)


def _flat_with_slo(path):
    flat = JS.load_pin(path)
    return {k: v for k, v in flat.items() if v.get("slo") is not None}


def test_corrupted_slo_block_fails_in_both():
    """A copy of the newest pinned block with its timeline's p95 gone,
    an unknown alert rule and an untagged fleet row fails both tools with
    the same violations."""
    flat = _flat_with_slo(SERVING_PINS[-1])
    assert flat
    bad = copy.deepcopy(flat)
    blk = next(iter(bad.values()))["slo"]
    for pt in blk["timeline"]:
        pt.pop("p95_ms", None)
    blk["alerts"].append({"ts": 1.0, "rule": "typo_burn", "from": "OK",
                          "to": "WARN"})
    blk["objectives"][0].pop("coordinator", None)
    got, want = S.validate_slo_block(bad), JS.validate_slo_block(bad)
    assert got == want and not got["ok"]
    kinds = " ".join(v["detail"] for v in got["violations"])
    assert "typo_burn" in kinds and "p95_ms" in kinds
    assert "coordinator tag" in kinds


def test_corrupted_attribution_fails_in_both(tmp_path, capsys):
    """A copy of the newest MULTICHIP pin with one block's control_sync
    over its budget and another's buckets incomplete fails both tools
    with the same violations and exit code 1."""
    with open(MULTICHIP_PINS[-1]) as f:
        doc = json.load(f)
    flat = JM.load_pin(MULTICHIP_PINS[-1])
    with_attr = [m for m, r in flat.items() if r.get("attribution")]
    assert len(with_attr) >= 2
    inner = doc["parsed"] if "parsed" in doc else doc
    recs = [inner] + list(inner.get("sub_metrics") or ())
    by_metric = {r.get("metric"): r for r in recs if isinstance(r, dict)}
    a0 = by_metric[with_attr[0]]["attribution"]
    a0["buckets"]["control_sync"] = a0["wall_s"] * 0.5
    by_metric[with_attr[1]]["attribution"]["buckets"].pop("stall")
    path = tmp_path / "MULTICHIP_bad.json"
    path.write_text(json.dumps(doc))
    got = M.validate_attribution(M.load_pin(str(path)))
    want = JM.validate_attribution(JM.load_pin(str(path)))
    assert got == want and not got["ok"]
    assert {v["kind"] for v in got["violations"]} == {"budget", "schema"}
    assert M.main([MULTICHIP_PINS[-1], str(path)]) == \
        JM.main([MULTICHIP_PINS[-1], str(path)]) == 1


_SLO_GROUPS = {
    "rootGroups": [{"name": "rep", "hardConcurrencyLimit": 4,
                    "subGroups": [
                        {"name": "dash", "hardConcurrencyLimit": 2,
                         "slo": {"latencyTargetMs": 2000,
                                 "latencyObjective": 0.95,
                                 "availabilityObjective": 0.99}}]}],
    "selectors": [{"group": "rep.dash"}]}


@pytest.fixture
def health_plane(monkeypatch):
    """A fresh time-series store and SLO tracker, and a registry of live
    resource-group managers holding only this test's (servers left alive
    by other tests in the process would add their groups' objectives)."""
    import weakref

    from presto_tpu_torch.obs.slo import SLO
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.serving import groups
    monkeypatch.setattr(groups, "_MANAGERS", weakref.WeakSet())
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()
    yield TIMESERIES
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()


def _served_server(TIMESERIES):
    """A statement server on the CPU with one SLO'd group that has
    served three statements, the time series sampled before them."""
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.server import PrestoTpuServer
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.001, device="cpu"),
                          resource_groups=_SLO_GROUPS)
    REGISTRY.histogram("serving_latency_seconds.rep.dash")
    REGISTRY.counter("serving_requests_total.rep.dash")
    REGISTRY.counter("serving_errors_total.rep.dash")
    TIMESERIES.sample()
    srv.start()
    client = StatementClient(f"http://127.0.0.1:{srv.port}")
    for _ in range(3):
        assert client.execute("select count(*) from nation").rows == [[25]]
    return srv


def test_live_slo_blocks_pass(health_plane, capsys):
    """The live ``/v1/slo`` block of a server that served statements
    passes both tools' schema; so does the fleet form merged over two
    servers' blocks, and the command line reads them."""
    servers = [_served_server(health_plane)]
    try:
        url = f"http://127.0.0.1:{servers[0].port}"
        flat = S.live_pin([url])
        got = S.validate_slo_block(flat)
        assert got == JS.validate_slo_block(flat)
        assert got["ok"] and got["blocks"] == 1, got
        blk = flat["live"]["slo"]
        assert [o["group"] for o in blk["objectives"]] == [
            "rep.dash", "rep.dash"]
        assert any(p.get("p95_ms") is not None for p in blk["timeline"])
        servers.append(_served_server(health_plane))
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        merged = S.live_pin(urls)
        blk = merged["live"]["slo"]
        assert blk["coordinators"] == 2
        assert {o["coordinator"] for o in blk["objectives"]} == set(urls)
        got = S.validate_slo_block(merged)
        assert got == JS.validate_slo_block(merged) and got["ok"], got
        assert S.main(["--live", urls[0]]) == 0
        assert S.main(["--live", urls[0], "--live", urls[1]]) == 0
    finally:
        for s in servers:
            s.stop()
    assert S.live_block()["sample_interval_s"] > 0


def test_live_attribution_passes(monkeypatch, tmp_path, capsys):
    """A mesh query on 4 CPU slots finishes a flight attribution that
    passes both tools' schema and budgets; the profile document of
    ``profile_query --mesh 4`` reads as a pin too."""
    from presto_tpu_torch._devtools import profile_query as P
    from presto_tpu_torch.obs.flight import FLIGHTS
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    runner = P.make_runner("tpch", 0.01, 1 << 14, "cpu")
    doc = P.profile_query(runner, P.TPCH_Q3, mesh=4)
    attr = doc["mesh"]["attribution"]
    assert attr["n_devices"] == 4
    flat = M.profile_pin(doc)
    got = M.validate_attribution(flat)
    assert got == JM.validate_attribution(flat)
    assert got["ok"] and got["blocks"] == 1, got
    qid = attr["query_id"]
    live = M.live_pin()
    assert M.validate_attribution({qid: live[qid]})["ok"]
    assert live[qid]["attribution"] is next(
        f.attribution for f in FLIGHTS.snapshot()
        if f.attribution is not None and f.attribution["query_id"] == qid)
    path = tmp_path / "prof.json"
    path.write_text(json.dumps(doc))
    assert M.main([str(path), str(path)]) == 0

