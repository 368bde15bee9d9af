"""Mesh (SPMD) execution of presto_tpu_torch (exec/distributed.py) on the
CPU: the port's mesh of 2 and 8 CPU slots (``PRESTO_TPU_TORCH_MESH_SLOTS``)
against presto_tpu's LocalRunner and the port's own single-device run.

This file holds the routing tests of tests/test_mesh_default.py (auto
with one slot, ``off`` and the system catalog stay local; ``on`` raises
on a plan with no mesh form), the exchange control's greedy re-balance
against presto_tpu's on the same counts, ``EXECUTE ... USING`` on the
mesh, the DistributedRunner surface, and TPC-H q1-q7 at SF 0.01; the
other TPC-H queries are in test_torch_mesh_tpch.py and
test_torch_mesh_tpch_rest.py, q27 and TPC-DS in
test_torch_mesh_tpcds.py. Rows compare in order: integers, decimals and
strings exactly, doubles within rel 1e-9 (per-shard partial sums change
the summation order; presto_tpu's own mesh tests use the same bound)."""
import dataclasses
import threading

import numpy as np
import pytest

from presto_tpu.exec.distributed import _PartitionMap as JPartitionMap
from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.config import SessionPropertyError
from presto_tpu_torch.errors import QueryCancelledError
from presto_tpu_torch.exec import distributed as D
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.obs.history import HISTORY
from presto_tpu_torch.obs.metrics import REGISTRY

from torch_parity import assert_rows_match
from tpch_queries import Q as H

SF = 0.01
REL = 1e-9
SLOTS = [2, 8]
TPCH = {n: s for n, s, _ in H}
FIRST = ["q1", "q3", "q4", "q5", "q6", "q7"]


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    """One CPU seen as eight mesh slots (the port's counterpart of the
    eight virtual CPU devices of tests/conftest.py)."""
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")


def _selected():
    return REGISTRY.counter("mesh_path_selected_total").value


def mesh_props(n, **extra):
    return {"mesh_execution": "on", "mesh_devices": n, **extra}


class Parity:
    """presto_tpu's rows per query (computed once) against the port's
    single-device run and its mesh on n slots."""

    def __init__(self, catalog: str = "tpch", rows_per_batch: int = 1 << 12):
        self.jax = LocalRunner(tpch_sf=SF, catalog=catalog)
        self.port = TLocalRunner(tpch_sf=SF, catalog=catalog,
                                 device="cpu",
                                 rows_per_batch=rows_per_batch)
        self._want = {}
        self._local = {}

    def want(self, sql):
        if sql not in self._want:
            self._want[sql] = self.jax.execute(sql).rows
        return self._want[sql]

    def local(self, sql):
        if sql not in self._local:
            self._local[sql] = self.port.execute(
                sql, properties={"mesh_execution": "off"}).rows
        return self._local[sql]

    def check(self, sql, n, ordered=True, **extra):
        before = _selected()
        got = self.port.execute(sql, properties=mesh_props(n, **extra))
        assert _selected() == before + 1, "query did not run on the mesh"
        assert self.port.last_stats.mesh_flight.n_devices == n
        rows = got.rows
        for want in (self.want(sql), self.local(sql)):
            a, b = (rows, want) if ordered else \
                (_canonical(rows), _canonical(want))
            assert_rows_match(a, b, REL)
        return got


def _canonical(rows):
    """Rows sorted by value (for queries whose ORDER BY leaves ties)."""
    def key(r):
        return tuple((v is None, str(type(v).__name__),
                      round(float(v), 6) if isinstance(v, float) else v)
                     for v in (x.item() if hasattr(x, "item") else x
                               for x in r))
    return sorted(rows, key=key)


@pytest.fixture(scope="module")
def parity():
    return Parity()


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("name", FIRST)
def test_tpch_on_the_mesh(parity, name, n):
    parity.check(TPCH[name], n)


def test_partitioned_joins_and_classic_exchange(parity):
    """Hash-partitioned joins and semi joins (broadcast suppressed), on
    the default plane (counted, since the slots share the CPU), the fused
    plane forced on, and the counted plane forced, with the sort-path
    grouping."""
    for name in ("q3", "q4"):
        parity.check(TPCH[name], 4, broadcast_join_row_limit=1)
        parity.check(TPCH[name], 4, broadcast_join_row_limit=1,
                     mesh_fused_exchange=True)
        parity.check(TPCH[name], 4, broadcast_join_row_limit=1,
                     mesh_fused_exchange=False, dense_grouping=False)


def test_exchange_plane_follows_device_sharing(parity):
    """Under mesh_fused_exchange=auto (the default) slots sharing a
    device take the counted exchange (the fused plane's capacity-safe
    quota would put n^2 x C lanes on that device) and slots with a
    device each the fused one; true forces the fused ship, false the
    counted plane everywhere; the fused aggregation waves stay on unless
    false. The selection depends on the value, not on whether the
    property is set."""
    from presto_tpu_torch.parallel.mesh import Mesh
    import torch
    sess = parity.port.session
    cpu = torch.device("cpu")

    def ex(n, **props):
        return D.DistributedExecutor(
            dataclasses.replace(sess, properties=props), 1 << 12,
            Mesh("dp", (cpu,) * n))
    for props in ({}, {"mesh_fused_exchange": "auto"},
                  {"mesh_fused_exchange": "AUTO"}):
        shared = ex(4, **props)
        assert shared.shared_devices and not shared.fused_ship
        assert shared.fused_exchange
        assert not shared._repartitioner([0]).fused
        own = ex(1, **props)
        assert not own.shared_devices and own.fused_ship
    for value in (True, "true", "on"):
        forced = ex(4, mesh_fused_exchange=value)
        assert forced.fused_ship and forced._repartitioner([0]).fused
        assert forced.fused_exchange
    for value in (False, "false", "off"):
        for n in (1, 4):
            counted = ex(n, mesh_fused_exchange=value)
            assert not counted.fused_ship and not counted.fused_exchange


def test_mesh_follows_the_slots_variable(monkeypatch):
    """Each routing decision builds its mesh from
    PRESTO_TPU_TORCH_MESH_SLOTS as it stands then: on two cards, a mesh
    of 2 is (cuda:0, cuda:0) with 2 slots a card and (cuda:0, cuda:1)
    after the variable drops to 1 (the cards are simulated; no tensor is
    made)."""
    import torch
    from presto_tpu_torch.parallel import mesh as M
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(D, "_plan_mesh_verdict",
                        lambda plan: (True, True, ""))
    sess = dataclasses.replace(
        TLocalRunner(tpch_sf=SF, device="cpu").session,
        properties={"mesh_execution": "on", "mesh_devices": 2})
    cuda = [torch.device("cuda", i) for i in range(2)]
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "2")
    assert D.select_mesh(sess, None, "cuda").devices == (cuda[0],) * 2
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "1")
    assert D.select_mesh(sess, None, "cuda").devices == tuple(cuda)
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "2")
    assert D.select_mesh(sess, None, "cuda").devices == (cuda[0],) * 2


# -- routing (tests/test_mesh_default.py) --------------------------------------

def test_auto_with_one_slot_stays_local(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "1")
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    before = _selected()
    assert r.execute("select count(*) from nation",
                     properties={"mesh_execution": "auto"}).rows == [(25,)]
    assert _selected() == before
    assert r.last_stats.mesh_flight is None


def test_auto_meshes_with_several_slots():
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    before = _selected()
    r.execute("select count(*) from nation",
              properties={"mesh_execution": "auto"})
    assert _selected() == before + 1
    assert r.last_stats.mesh_flight.n_devices == 8


def test_off_and_mesh_devices_one_stay_local():
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    before = _selected()
    r.execute("set session mesh_execution = 'off'")
    assert r.execute("select count(*) from nation").rows == [(25,)]
    r.execute("reset session mesh_execution")
    r.execute("select count(*) from nation",
              properties={"mesh_execution": "auto", "mesh_devices": 1})
    assert _selected() == before


def test_system_catalog_stays_local():
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    before = _selected()
    res = r.execute("select name from system.runtime.metrics limit 1",
                    properties={"mesh_execution": "auto"})
    assert res.rows is not None
    assert _selected() == before


def test_on_raises_on_a_plan_with_no_mesh_form(monkeypatch):
    """mesh_execution=on never degrades to the local path: a plan the
    fragmenter cannot cut raises naming why; auto runs it locally."""
    from presto_tpu_torch.planner import fragmenter
    monkeypatch.setattr(fragmenter, "plan_mesh_stages",
                        lambda root: fragmenter.MeshPlan(
                            [], False, "cannot fragment Odd"))
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"no mesh form \(cannot fragment Odd\)"):
        r.execute("select count(*) from nation",
                  properties={"mesh_execution": "on"})
    before = _selected()
    assert r.execute("select count(*) from nation",
                     properties={"mesh_execution": "auto"}).rows == [(25,)]
    assert _selected() == before


def test_mesh_session_properties_validate():
    """SET SESSION accepts the mesh properties and fair_scheduling, with
    the reference's validation."""
    from presto_tpu.config import validate_session_property as jv
    from presto_tpu_torch.config import validate_session_property as tv
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    for stmt in ("set session mesh_execution = 'off'",
                 "set session mesh_devices = 4",
                 "set session mesh_fused_exchange = false",
                 "set session mesh_fused_exchange = 'auto'",
                 "set session mesh_fused_loop_rounds = 8",
                 "set session mesh_flight = false",
                 "set session fair_scheduling = true"):
        assert r.execute(stmt).rows == [(True,)]
    for name, value in (("mesh_execution", "AUTO"), ("mesh_devices", "4"),
                        ("mesh_fused_exchange", "false"),
                        ("mesh_fused_loop_rounds", "8"),
                        ("mesh_flight", "on"), ("fair_scheduling", "0")):
        assert tv(name, value) == jv(name, value)
    with pytest.raises(SessionPropertyError):
        tv("mesh_execution", "sideways")
    assert tv("mesh_fused_exchange", " Auto ") == "auto"
    assert tv("mesh_fused_exchange", True) is True
    with pytest.raises(SessionPropertyError):
        tv("mesh_fused_exchange", "sideways")
    with pytest.raises(SessionPropertyError):
        tv("mesh_execution", True)
    with pytest.raises(SessionPropertyError):
        r.execute("set session mesh_execution = 'sideways'")


def test_environment_default_routes(monkeypatch):
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_EXECUTION", "off")
    before = _selected()
    r.execute("select count(*) from region")
    assert _selected() == before
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_EXECUTION", "on")
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_FLIGHT", "off")
    r.execute("select count(*) from region")
    assert _selected() == before + 1
    assert r.last_stats.mesh_flight is None


# -- exchange control ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_partition_map_equals_reference(seed, n):
    """The same per-bucket counts drive both _PartitionMaps to the same
    assignments, epochs and totals (the greedy LPT re-balance, its skew
    verdict against the balanced load and the MAX_CHANGES cap)."""
    rng = np.random.default_rng(seed)
    got, want = D._PartitionMap(n, ratio=1.5), JPartitionMap(n, ratio=1.5)
    assert got.assign == want.assign
    for _ in range(4):
        counts = rng.integers(0, 50, (n, got.buckets)).astype(np.int64)
        hot = rng.integers(0, got.buckets)
        counts[:, hot] += rng.integers(0, 5000)
        got.observe(counts.copy())
        want.observe(counts.copy())
        assert (got.assign, got.epoch, got.changes) == \
            (want.assign, want.epoch, want.changes)
        np.testing.assert_array_equal(got._totals, want._totals)


def test_partition_map_rebalance_unit():
    pm = D._PartitionMap(2, ratio=1.5)
    counts = np.zeros((2, pm.buckets), dtype=np.int64)
    counts[0, 0] = 1000
    counts[0, 2] = 900
    counts[0, 1] = 10
    pm.observe(counts)
    assert pm.epoch == 1
    one_key = D._PartitionMap(2, ratio=1.5)
    hot = np.zeros((2, one_key.buckets), dtype=np.int64)
    hot[0, 0] = 10_000              # one hot bucket: nothing to split
    one_key.observe(hot)
    assert one_key.epoch == 0
    assert D._per_dest_quota(counts, pm.assign, 2) >= 10


def test_skewed_build_resplits_and_keeps_parity(parity):
    """A re-split mid-query (a low skew ratio forces it) re-ships the
    build under the new assignment: rows unchanged."""
    sql = ("select o_orderpriority, count(*) from orders, lineitem "
           "where o_orderkey = l_orderkey and l_linenumber = 1 "
           "group by 1 order by 1")
    resplits0 = REGISTRY.counter("mesh_repartition_resplit_total").value
    from presto_tpu_torch.exec.cluster import StageMonitor
    old = StageMonitor.skew_ratio
    StageMonitor.skew_ratio = 1.01
    try:
        parity.check(sql, 8, broadcast_join_row_limit=1)
    finally:
        StageMonitor.skew_ratio = old
    assert REGISTRY.counter("mesh_repartition_resplit_total").value \
        > resplits0


def test_long_decimal_distributed_sort(parity):
    """A full ORDER BY on a long decimal runs the range-partitioned sort
    (presto_tpu's mesh raises ValueError here: its sort program unpacks
    two operands from the three a long decimal gives); the port's mesh
    returns the reference's single-device rows."""
    sql = ("select cast(o_totalprice as decimal(30,2)) p, o_orderkey "
           "from orders order by p desc, o_orderkey")
    got = parity.check(sql, 8)
    assert len(got.rows) == 15000


# -- statements on the mesh ----------------------------------------------------

def test_execute_using_on_the_mesh(parity):
    r = parity.port
    r.execute("prepare mq from select l_returnflag, count(*), "
              "sum(l_extendedprice) from lineitem where l_quantity < ? "
              "and l_shipdate <= ? group by 1 order by 1")
    stmt = "execute mq using 24, date '1998-09-02'"
    local = r.execute(stmt, properties={"mesh_execution": "off"}).rows
    before = _selected()
    got = r.execute(stmt, properties=mesh_props(8)).rows
    assert _selected() == before + 1
    assert_rows_match(got, local, REL)
    want = parity.jax.execute(
        "select l_returnflag, count(*), sum(l_extendedprice) from lineitem "
        "where l_quantity < 24 and l_shipdate <= date '1998-09-02' "
        "group by 1 order by 1").rows
    assert_rows_match(got, want, REL)


def test_distributed_runner_surface(parity):
    dr = D.DistributedRunner(catalogs=parity.port.session.catalogs,
                             n_devices=2, rows_per_batch=1 << 11,
                             device="cpu")
    assert dr.mesh.size == 2
    res = dr.execute("select count(*) from nation",
                     properties={"dense_grouping": True}, user="audit")
    assert res.rows == [(25,)]
    rec = [h for h in HISTORY.snapshot() if h.get("mode") == "spmd"][-1]
    assert rec["user"] == "audit" and rec["state"] == "FINISHED"
    assert rec["mesh_rounds"] > 0
    got = dr.execute(TPCH["q3"]).rows
    assert_rows_match(got, parity.want(TPCH["q3"]), REL)
    with pytest.raises(SessionPropertyError):
        dr.execute("select count(*) from nation",
                   properties={"not_a_property": 1})
    with pytest.raises(NotImplementedError):
        dr.execute("set session mesh_devices = 2")
    ev = threading.Event()
    ev.set()
    with pytest.raises(QueryCancelledError):
        dr.execute("select count(*) from region", cancel_event=ev)


def test_distributed_runner_without_a_gpu_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.DistributedRunner(tpch_sf=SF)


def test_verifier_cli_local_against_distributed(tmp_path, capsys):
    from presto_tpu_torch.verifier import main
    qf = tmp_path / "q.sql"
    qf.write_text("select count(*) from nation;\n"
                  "select n_regionkey, count(*) from nation group by 1;")
    assert main([str(qf), "--device", "cpu", "--rel-tol", "1e-9"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("2/2 MATCH")


# -- a short last fused aggregation wave ---------------------------------------

SHORT_WAVE = [
    # 19 chunks of 800 rows form fused waves of 4, 4, 4, 4 and 3: the
    # last wave rounds up to the same 4 rounds as the full ones
    ("tpch", 800, {"mesh_fused_loop_rounds": 4},
     "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
     "from lineitem group by 1, 2 order by 1, 2",
     ("A", "F", 15209, 385560.0), 4),
    ("tpcds", 4096, {},
     "select cd_gender, cd_marital_status, count(*) "
     "from customer_demographics group by cube(cd_gender, "
     "cd_marital_status) order by 1 nulls last, 2 nulls last",
     ("F", "D", 192080), 18),
]


@pytest.mark.parametrize("catalog,rows_per_batch,extra,sql,first,n_rows",
                         SHORT_WAVE, ids=["tpch", "tpcds_cube"])
def test_short_last_fused_wave(monkeypatch, catalog, rows_per_batch, extra,
                               sql, first, n_rows):
    """A fused aggregation wave shorter than the one before it with the
    same rounding gets a program of its own: both statements return
    presto_tpu's 4-device mesh rows on 4 slots (doubles within rel
    1e-9)."""
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    want = LocalRunner(tpch_sf=SF, catalog=catalog).execute(
        sql, properties=mesh_props(4, **extra)).rows
    port = TLocalRunner(tpch_sf=SF, catalog=catalog, device="cpu",
                        rows_per_batch=rows_per_batch)
    before = _selected()
    got = port.execute(sql, properties=mesh_props(4, **extra)).rows
    assert _selected() == before + 1
    assert port.last_stats.mesh_flight.n_devices == 4
    assert len(want) == n_rows and tuple(want[0]) == first
    assert_rows_match(got, want, REL)
