"""The plan fragmenter of presto_tpu_torch (planner/fragmenter.py) and
EXPLAIN (TYPE DISTRIBUTED) against presto_tpu's, host only.

For the 22 TPC-H queries, q27 and the TPC-DS battery at SF 0.01, the
port's optimized plan cuts into the same mesh stages (verdict, reason,
stage kinds, exchanges, keys, operators, fused flags) as presto_tpu's,
and ``print_distributed_plan`` prints the same text line for line,
directly and through the runner's EXPLAIN (TYPE DISTRIBUTED), but for
the integer literals the port types INTEGER (tests/torch_retyped.py). Plans with
no mesh form give the same refusal reason."""
import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu.planner.fragmenter import (
    fragment_plan as jfragment, plan_mesh_stages as jstages,
)
from presto_tpu.planner.printer import (
    print_distributed_plan as jprint,
)
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.planner.fragmenter import (
    MeshPlan, fragment_plan, plan_mesh_stages,
)
from presto_tpu_torch.planner.printer import print_distributed_plan

from torch_retyped import TPCDS_RETYPED, TPCH_RETYPED, assert_retyped
from tpcds_queries import Q as DS
from tpch_queries import Q as H
from test_torch_tpcds import Q27

SF = 0.01
TPCH = [(n, s) for n, s, _ in H]
TPCDS = [(n, s) for n, s, _ in DS] + [("q27", Q27)]


@pytest.fixture(scope="module")
def runners():
    return {
        "tpch": (LocalRunner(tpch_sf=SF),
                 TLocalRunner(tpch_sf=SF, device="cpu")),
        "tpcds": (LocalRunner(tpch_sf=SF, catalog="tpcds"),
                  TLocalRunner(tpch_sf=SF, device="cpu",
                               catalog="tpcds")),
    }


def _stages(mp):
    return (mp.supported, mp.reason,
            [(s.id, s.kind, s.exchange, tuple(s.keys), tuple(s.ops),
              s.fused) for s in mp.stages])


def _check(runners, catalog, sql, retyped=()):
    """The same stages and fragments as the reference's, and the same
    text but for the integer literals the port types INTEGER
    (``retyped``: tests/torch_retyped.py's pairs)."""
    jr, tr = runners[catalog]
    jplan, tplan = jr.plan(sql), tr.plan(sql)
    for jroot, troot in zip([jplan.root] + list(jplan.init_plans),
                            [tplan.root] + list(tplan.init_plans)):
        assert _stages(plan_mesh_stages(troot)) == _stages(jstages(jroot))
        jf, tf = jfragment(jroot), fragment_plan(troot)
        assert [(f.id, f.partitioning) for f in tf.fragments] == \
            [(f.id, f.partitioning) for f in jf.fragments]
    assert_retyped(print_distributed_plan(tplan).split("\n"),
                   jprint(jplan).split("\n"), retyped)


@pytest.mark.parametrize("name,sql", TPCH, ids=[n for n, _ in TPCH])
def test_tpch_stages_and_text(runners, name, sql):
    _check(runners, "tpch", sql, TPCH_RETYPED.get(name, ()))


@pytest.mark.parametrize("name,sql", TPCDS, ids=[n for n, _ in TPCDS])
def test_tpcds_stages_and_text(runners, name, sql):
    _check(runners, "tpcds", sql, TPCDS_RETYPED.get(name, ()))


def test_explain_type_distributed_through_the_runner(runners):
    jr, tr = runners["tpch"]
    sql = dict(TPCH)["q3"]
    stmt = "explain (type distributed) " + sql
    got = [r[0] for r in tr.execute(stmt).rows]
    want = [r[0] for r in jr.execute(stmt).rows]
    assert got == want
    assert got[0].startswith("Fragment 0 [")
    with pytest.raises(ValueError):
        tr.execute("explain (type distributed, format json) " + sql)


#: the VALUES columns of integer literals: integer in the port, bigint in
#: the reference
OTHER_RETYPED = {"select * from (values (1, 2), (3, 4)) t(a, b)": [
    ("a:bigint", "a:integer"), ("b:bigint", "b:integer")] * 2}


@pytest.mark.parametrize("sql", [
    "select * from (values (1, 2), (3, 4)) t(a, b)",
    "select count(*) from nation",
    "select n_name, count(*) over (partition by n_regionkey) from nation",
    "select x from nation cross join unnest(array[n_nationkey]) as u(x)",
])
def test_verdicts_of_other_shapes(runners, sql):
    _check(runners, "tpch", sql, OTHER_RETYPED.get(sql, ()))


def test_unfragmentable_plan_gives_the_reason():
    """A node kind the fragmenter has no rule for: no mesh form, with the
    reference's reason text."""
    class Odd:
        children = ()
    mp = plan_mesh_stages(Odd())
    assert isinstance(mp, MeshPlan)
    assert (mp.supported, mp.reason, mp.stages) == \
        (False, "cannot fragment Odd", [])
    assert _stages(jstages(Odd())) == _stages(mp)
