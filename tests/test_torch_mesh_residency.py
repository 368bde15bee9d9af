"""Mesh shards stay resident on their slots (exec/distributed.py): the
values that pass between mesh operators are ``ShardedBatch`` values, one
``Batch`` per slot on that slot's device, and batch data comes onto the
controller device (slot 0's) only at the root and in the all-gather
behind a shard-0 finalize. Every such copy passes
``distributed.controller_copy``, whose counters these tests read.

Before the shards stayed on their slots, every operator stacked its
slot outputs into one global batch on the controller. Counted as the
bytes (``memory.batch_device_bytes``) of every batch
``DistributedExecutor._cat_shards`` returned, by wrapping that method
while each TPC-H query ran at SF 0.01 on 4 CPU slots with
``rows_per_batch=2**12``, that tree stacked 3 857 920 B (3.86 MB) in 12
stacks for Q6, 6 400 512 B (6.40 MB) in 9 for Q1 and 24 168 960 B
(24.17 MB) in 25 for Q3; ``PARENT_STACKED`` holds every query's figure.

The rows of the shapes that exercise the resident path (a string GROUP
BY whose shards' vocabularies differ, a LIMIT over a filter, VALUES, a
ROLLUP, windows, a broadcast join) equal presto_tpu's and the port's
single-device run on 2, 4 and 8 CPU slots, and a checked sum that
overflows on one slot raises NUMERIC_VALUE_OUT_OF_RANGE there as on one
device."""
import pytest
import torch

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.errors import QueryError
from presto_tpu_torch.exec import distributed as D
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY

from torch_parity import assert_rows_match
from tpch_queries import Q as H

SF = 0.01
REL = 1e-9
ROWS_PER_BATCH = 1 << 12
TPCH = {n: s for n, s, _ in H}

#: bytes the tree before this change stacked onto the controller per
#: TPC-H query (SF 0.01, 4 CPU slots, 2^12 rows a batch; see above)
PARENT_STACKED = {
    "q1": 6400512, "q2": 4852736, "q3": 24168960, "q4": 4224000,
    "q5": 43207168, "q6": 3857920, "q7": 48314368, "q8": 60854784,
    "q9": 58527744, "q10": 45103104, "q11": 2883072, "q12": 7138304,
    "q13": 4784128, "q14": 8774656, "q15": 3956736, "q16": 1232384,
    "q17": 15867392, "q18": 42958336, "q19": 12510720, "q20": 16940032,
    "q21": 29170688, "q22": 386048,
}
#: the residency bound for the three queries of the path
SMALL = 64 << 10


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")


def mesh_props(n, **extra):
    return {"mesh_execution": "on", "mesh_devices": n, **extra}


@pytest.fixture(scope="module")
def port():
    return TLocalRunner(tpch_sf=SF, device="cpu",
                        rows_per_batch=ROWS_PER_BATCH)


@pytest.fixture(scope="module")
def ref():
    return LocalRunner(tpch_sf=SF)


@pytest.fixture(scope="module")
def tpch_copies(port):
    """Per TPC-H query on 4 slots: (mesh rows, controller-copy counter
    deltas), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            before = D.copy_counters()
            rows = port.execute(TPCH[name], properties=mesh_props(4)).rows
            after = D.copy_counters()
            cache[name] = rows, {k: after[k] - before[k] for k in after}
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["q1", "q3", "q6"])
def test_path_queries_stack_under_64_kib(tpch_copies, name):
    rows, copies = tpch_copies(name)
    assert rows
    assert 0 < copies["stacked_bytes"] < SMALL, copies


@pytest.mark.parametrize("name", sorted(PARENT_STACKED,
                                        key=lambda q: int(q[1:])))
def test_no_query_stacks_more_than_before(port, tpch_copies, name):
    """Each of the 22 queries stacks less than the tree before this
    change did, and keeps its rows."""
    rows, copies = tpch_copies(name)
    assert copies["stacked_bytes"] < PARENT_STACKED[name], copies
    local = port.execute(TPCH[name],
                         properties={"mesh_execution": "off"}).rows
    assert_rows_match(rows, local, REL)


#: (name, statement, rows ordered): shapes of the resident path
SHAPES = [
    # o_clerk's vocabulary differs from split to split: the scan re-codes
    # each shard on its own slot
    ("string_group_by", "select o_clerk, count(*), sum(o_totalprice) "
     "from orders group by o_clerk order by o_clerk", True),
    # the first 25 live rows lie in shard 0's first batch on every width
    ("limit_over_filter", "select l_orderkey, l_linenumber, l_quantity "
     "from lineitem where l_quantity > 49 limit 25", True),
    # a limit larger than what the filter keeps: every slot's rows
    ("limit_keeps_all", "select l_orderkey, l_linenumber from lineitem "
     "where l_orderkey < 40 limit 1000", False),
    ("values", "select x, y from (values (3, 'c'), (1, 'a'), (2, null), "
     "(4, 'd')) t(x, y) order by x", True),
    ("values_join", "select n_name, v.w from nation join (values (1, 'x'), "
     "(7, 'y'), (24, 'z')) v(k, w) on n_nationkey = v.k order by n_name",
     True),
    ("rollup", "select l_returnflag, l_linestatus, count(*), "
     "sum(l_quantity) from lineitem group by rollup(l_returnflag, "
     "l_linestatus) order by l_returnflag, l_linestatus", True),
    ("window_partitioned", "select o_custkey, o_orderkey, rank() over "
     "(partition by o_custkey order by o_totalprice desc, o_orderkey) "
     "from orders where o_custkey < 60 order by o_custkey, o_orderkey",
     True),
    ("window_global", "select n_name, row_number() over (order by n_name) "
     "from nation order by n_name", True),
    ("cross_join", "select n_name, x from nation cross join (select "
     "max(r_regionkey) x from region) order by n_name", True),
    ("full_join", "select c_custkey, o_orderkey from customer full outer "
     "join orders on c_custkey = o_custkey where c_custkey < 20 or "
     "o_orderkey < 20 order by 1, 2", True),
    ("broadcast_join", "select n_name, r_name from nation join region "
     "on n_regionkey = r_regionkey order by n_name", True),
]


def _canonical(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v) for v in r))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name,sql,ordered", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_resident_shapes_keep_their_rows(port, ref, name, sql, ordered, n):
    selected = REGISTRY.counter("mesh_path_selected_total")
    before = selected.value
    got = port.execute(sql, properties=mesh_props(n)).rows
    assert selected.value == before + 1
    assert port.last_stats.mesh_flight.n_devices == n
    if name == "string_group_by":
        staged = [r for r in port.last_stats.mesh_flight.records()
                  if r["kind"] == "staging" and r.get("loads")]
        assert staged, "the shards' vocabularies did not differ"
    assert got
    for want in (ref.execute(sql).rows,
                 port.execute(sql,
                              properties={"mesh_execution": "off"}).rows):
        a, b = (got, want) if ordered else (_canonical(got),
                                            _canonical(want))
        assert_rows_match(a, b, REL)


def test_broadcast_join_is_replicated(port):
    strategy = REGISTRY.counter(
        "join_strategy_selected_total.sorted.replicated")
    direct = REGISTRY.counter(
        "join_strategy_selected_total.direct.replicated")
    before = strategy.value + direct.value
    port.execute(SHAPES[-1][1], properties=mesh_props(4))
    assert strategy.value + direct.value > before


#: a checked sum whose only overflowing partial is the one of the slot
#: holding o_orderkey 1 (shard 0's first rows)
OVERFLOW = ("select {key} sum(case when o_orderkey = 1 then "
            "9223372036854775807 else 1 end) from orders {group}")


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_checked_sum_overflow_on_one_slot_raises(port, n, grouped):
    sql = OVERFLOW.format(key="o_orderstatus," if grouped else "",
                          group="group by o_orderstatus" if grouped else "")
    for props in (mesh_props(n), {"mesh_execution": "off"}):
        with pytest.raises(QueryError) as ei:
            port.execute(sql, properties=props)
        assert ei.value.name == "NUMERIC_VALUE_OUT_OF_RANGE"


def _yielded(monkeypatch):
    """Records every value DistributedExecutor.run yields."""
    seen = []
    plain = D.DistributedExecutor.run

    def run(self, node):
        for v in plain(self, node):
            seen.append((self, v))
            yield v
    monkeypatch.setattr(D.DistributedExecutor, "run", run)
    return seen


@pytest.mark.parametrize("sql", [TPCH["q3"], TPCH["q1"]]
                         + [s[1] for s in SHAPES[:6]],
                         ids=["q3", "q1"] + [s[0] for s in SHAPES[:6]])
def test_operators_pass_sharded_batches(port, monkeypatch, sql):
    """Between operators every value is a ShardedBatch: one part per
    slot on that slot's device, one capacity, and one dictionary object
    per string column across the parts."""
    seen = _yielded(monkeypatch)
    port.execute(sql, properties=mesh_props(4))
    assert seen
    for ex, v in seen:
        assert isinstance(v, D.ShardedBatch), type(v)
        assert len(v.parts) == ex.n == 4
        assert [p.device for p in v.parts] == list(ex.slots)
        assert len({p.capacity for p in v.parts}) == 1
        assert v.capacity == 4 * v.shard_capacity
        for ci, c0 in enumerate(v.parts[0].columns):
            assert all(p.columns[ci].dictionary is c0.dictionary
                       for p in v.parts[1:])


def test_slot_programs_take_only_per_slot_values(port):
    """A batch on the controller never reaches a slot program: sharded
    inputs must be per-slot values, replicated ones per-device copies."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch
    from presto_tpu_torch.parallel.mesh import Mesh
    ex = D.DistributedExecutor(port.session, ROWS_PER_BATCH,
                               Mesh("dp", (torch.device("cpu"),) * 4))
    b = Batch.from_pydict({"x": (T.BIGINT, [1, 2, 3])}, device="cpu")
    with pytest.raises(TypeError, match="not sharded"):
        ex._smap(lambda x: x, 1)(b)
    with pytest.raises(TypeError, match="not replicated"):
        ex._smap(lambda x: x, 1, replicated_in=(0,))(b)
    sharded = ex._from_host(b)
    assert [p.capacity for p in sharded.parts] == [32] * 4
    assert ex._smap(lambda x: x, 1)(sharded).to_pylist() == [
        (1,), (2,), (3,)]


def test_sharded_batch_counts_and_gathers_in_slot_order():
    """host_count sums the parts; to_pylist gathers only live rows,
    slot 0's first, and counts them as stacked bytes."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch
    parts = []
    for i in range(3):
        b = Batch.from_pydict(
            {"x": (T.BIGINT, [10 * i + k for k in range(4)])},
            device="cpu")
        parts.append(Batch(b.schema, b.columns,
                           b.row_mask & (torch.arange(b.capacity) % 2
                                         == i % 2)))
    sb = D.ShardedBatch(parts)
    assert sb.host_count() == 6
    before = D.copy_counters()
    assert sb.to_pylist() == [(0,), (2,), (11,), (13,), (20,), (22,)]
    after = D.copy_counters()
    assert after["stacked_calls"] == before["stacked_calls"] + 1
    # three parts compacted to two live lanes each: 2 x (8 + 1) + 2 B
    assert after["stacked_bytes"] - before["stacked_bytes"] == 3 * 20
