"""Fused join chains of presto_tpu_torch (exec/fused.py and the chain in
exec/local.py) against presto_tpu's on the CPU at SF 0.01: every TPC-H
query takes the chain exactly where presto_tpu does (its
fused_source_lanes_total counter moved) and returns the same rows; a
chain with a left join and chains with an empty build agree; EXPLAIN
ANALYZE of q5 gives the same plan nodes the same rows; the probe's
plain version runs inside the tail and its calls are charged to the head
join; a probe that fails inside a tail raises (there is no fallback);
the head keeps its live count on the device. The TPC-DS battery is in
test_torch_fused_tpcds.py."""
import re

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner
from presto_tpu.obs.metrics import REGISTRY as JREGISTRY
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec import fused
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.ops import probe
from presto_tpu_torch.ops.join import prepare_direct
from presto_tpu_torch.planner.plan import JoinNode

from torch_parity import assert_results_match
from tpch_queries import Q

SQL = {name: sql for name, sql, _ in Q}
SF = 0.01
#: the TPC-H queries the reference runs through a fused chain at SF 0.01
FUSED_TPCH = {"q2", "q5", "q7", "q8", "q9", "q10", "q11", "q17", "q18",
              "q21"}

#: a chain of an inner and a left join whose build misses some keys
LEFT_CHAIN = """
select c_mktsegment, count(*) c, count(n_name) cn, sum(o_totalprice) s
from orders join customer on o_custkey = c_custkey
  left join (select * from nation where n_nationkey < 5) n
    on c_nationkey = n_nationkey
group by c_mktsegment order by 1"""
#: chains whose last build is empty: the generic path runs them
EMPTY_INNER = """
select n_name, count(*) c
from orders join customer on o_custkey = c_custkey
  join (select * from nation where n_name = 'ATLANTIS') n
    on c_nationkey = n_nationkey
group by n_name order by n_name"""
EMPTY_LEFT = """
select c_mktsegment, count(*) c, count(n_name) cn
from orders join customer on o_custkey = c_custkey
  left join (select * from nation where n_name = 'ATLANTIS') n
    on c_nationkey = n_nationkey
group by c_mktsegment order by 1"""


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=SF), TLocalRunner(tpch_sf=SF, device="cpu")


def _lanes(registry):
    return registry.counter("fused_source_lanes_total").value


def run_both(runners, sql, properties=None):
    """(port result, reference result, port source lanes, reference
    source lanes) of one statement."""
    jax_runner, torch_runner = runners
    j0 = _lanes(JREGISTRY)
    want = jax_runner.execute(sql, properties=properties)
    j_lanes = _lanes(JREGISTRY) - j0
    t0 = _lanes(REGISTRY)
    got = torch_runner.execute(sql, properties=properties)
    return got, want, _lanes(REGISTRY) - t0, j_lanes


@pytest.mark.parametrize("name", sorted(SQL))
def test_tpch_chain_taken_where_reference_takes_it(runners, name):
    got, want, lanes, ref_lanes = run_both(runners, SQL[name])
    assert (ref_lanes > 0) == (name in FUSED_TPCH)
    assert (lanes > 0) == (ref_lanes > 0), (lanes, ref_lanes)
    if name in FUSED_TPCH:
        assert lanes == ref_lanes
    assert_results_match(got, want, 1e-12)


@pytest.mark.parametrize("sql,chain", [(LEFT_CHAIN, True),
                                       (EMPTY_INNER, False),
                                       (EMPTY_LEFT, False)],
                         ids=["left_join", "empty_inner", "empty_left"])
def test_chain_shapes_match_reference(runners, sql, chain):
    got, want, lanes, ref_lanes = run_both(runners, sql)
    assert (lanes > 0) == (ref_lanes > 0) == chain
    assert_results_match(got, want, 1e-12)
    off = runners[1].execute(sql, properties={"fused_pipeline": False})
    assert off.rows == got.rows


def test_left_chain_keeps_unmatched_rows(runners):
    got, _, _, _ = run_both(runners, LEFT_CHAIN)
    assert all(cn < c for _, c, cn, _ in got.rows)
    assert any(cn > 0 for _, _, cn, _ in got.rows)


_ANALYZED = re.compile(
    r"^(?P<label>.*?)(   \[(?P<not>not executed)?(self [\d,.]+ms, wall "
    r"[\d,.]+ms, (?P<rows>[\d,]+) rows, (?P<batches>\d+) batches)?\].*)?$")


def _node_rows(lines):
    out = []
    for line in lines:
        if line.startswith("Total: "):
            break
        m = _ANALYZED.match(line)
        out.append((m.group("label"), m.group("not"), m.group("rows")))
    return out


def test_explain_analyze_q5_matches_reference(runners):
    jax_runner, torch_runner = runners
    sql = "explain analyze " + SQL["q5"]
    got = _node_rows([r[0] for r in torch_runner.execute(sql).rows])
    want = _node_rows([r[0] for r in jax_runner.execute(sql).rows])
    assert got == want
    # the chain's interior joins never run on their own
    assert sum(1 for _, nx, _ in got if nx) >= 2


def test_tail_probes_are_charged_to_the_head_join(runners):
    _, torch_runner = runners
    before = probe.plain_calls
    torch_runner.execute(SQL["q5"], properties={"profile": True})
    assert probe.plain_calls > before
    stats = torch_runner.last_stats
    charged = [node for node, per in stats.exe_by_node.items()
               if any(rec.name == "direct_probe" for rec in per)]
    assert charged and all(isinstance(n, JoinNode) for n in charged)
    # the head join is the only join node of the chain that executed
    plan = torch_runner.plan(SQL["q5"])
    executed = [n for n in stats.by_node if isinstance(n, JoinNode)]
    assert set(charged) <= set(executed)
    joins = []

    def walk(n):
        if isinstance(n, JoinNode):
            joins.append(n)
        for c in n.children:
            walk(c)
    walk(plan.root)
    assert len(executed) < len(joins)


def test_failing_probe_in_tail_raises(runners, monkeypatch):
    _, torch_runner = runners

    def boom(*a, **k):
        raise RuntimeError("probe kernel failed")
    monkeypatch.setattr(fused, "lookup_join_direct", boom)
    with pytest.raises(RuntimeError, match="probe kernel failed"):
        torch_runner.execute(SQL["q5"])
    assert not hasattr(fused, "strip_pallas")


def test_head_count_stays_on_device():
    """The head returns its live count as a 0-d tensor and gathers no
    payload: its output has the source's schema."""
    cpu = torch.device("cpu")
    src = Batch.from_pydict({"k": (T.BIGINT, [1, 2, 3, 9, None, 4]),
                             "v": (T.BIGINT, [10, 20, 30, 90, 0, 40])},
                            device=cpu)
    build = Batch.from_pydict({"k": (T.BIGINT, [2, 3, 4]),
                               "p": (T.VARCHAR, ["b", "c", "d"])},
                              device=cpu)
    prep = prepare_direct(build, [0], 2, 128)
    head = fused.fused_prefilter((), (1,), ((0,), (0,)))
    hb, err, count = head(src, [(15, 35)], build, prep)
    assert isinstance(count, torch.Tensor) and count.ndim == 0
    assert int(count) == 2 and err is None
    assert hb.schema == src.schema
    assert [r[0] for r in hb.to_pylist()] == [2, 3]
    assert fused.fused_prefilter((), (1,), ((0,), (0,))) is head
