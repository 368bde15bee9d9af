"""Plan-template parameters of presto_tpu_torch (expr/params.py) against
presto_tpu: ``collect_params``, ``has_params`` and ``bind_plan`` on the
same marked statements; Param evaluation against the same plan with the
literal inlined (row for row, and value for value on a seeded batch);
the errors outside a binding scope; and bindings seen on the threads
that run batches (split prefetch workers, the probe producer and
``parallel_drivers``). TPC-H SF 0.01 on the CPU. Rows compare in order:
integers, decimals, dates and strings exactly, doubles within rel 1e-12
(the same plan sums in the same order in both packages)."""
import threading

import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.expr import params as JP
from presto_tpu.planner.optimizer import optimize as joptimize
from presto_tpu.planner.planner import plan_query as jplan_query
from presto_tpu.planner.printer import print_plan as jprint_plan
from presto_tpu.serving.template import parameterize as jparameterize
from presto_tpu.sql.parser import parse_statement as jparse
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec.local import execute_plan
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.expr import compiler as C
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr import params as P
from presto_tpu_torch.expr.functions import Val
from presto_tpu_torch.planner.optimizer import optimize
from presto_tpu_torch.planner.planner import plan_query
from presto_tpu_torch.planner.printer import print_plan
from presto_tpu_torch.serving.template import parameterize
from presto_tpu_torch.sql.parser import parse_statement

from torch_parity import assert_rows_match
from torch_retyped import assert_retyped, col_pairs, lit_pairs

SF = 0.01
REL = 1e-12
TPROPS = {"plan_template_cache": True}
SEED = 20261017

#: statements whose WHERE literals hole-punch: every parameterizable
#: kind (BIGINT, DOUBLE, short DECIMAL, DATE), BETWEEN and IN lists, a
#: HAVING and a join
MARKED = [
    "select count(*), sum(l_extendedprice) from lineitem "
    "where l_quantity > 20 and l_shipdate < date '1995-06-01'",
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_discount between 0.05 and 0.07 and l_quantity < 24",
    "select l_returnflag, count(*) from lineitem where l_tax > 0.04 "
    "and l_linenumber in (1, 3, 5) group by 1 having count(*) > 10 "
    "order by 1",
    "select o_orderpriority, count(*) from orders join lineitem "
    "on o_orderkey = l_orderkey and l_commitdate < date '1996-01-01' "
    "where o_totalprice > 100000.5 group by 1 order by 1",
    "select count(*) from part where p_size * 2 > 30 and p_retailprice "
    "< 1500.0",
]


#: by statement of MARKED: the slots typed INTEGER in the port and BIGINT
#: in the reference, and the bound plans' differing tokens
PARAM_RETYPED = {
    0: ((0,), lit_pairs(20)),
    1: ((2,), lit_pairs(24)),
    2: ((1, 2, 3), col_pairs(0) + lit_pairs(1, 3, 5)),
    4: ((0, 1), col_pairs(0) + lit_pairs(2, 30)),
}


@pytest.fixture(scope="module")
def pair():
    return (JRunner(tpch_sf=SF),
            LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 12))


def _plans(pair, sql):
    """(reference plan, port plan, values) of the marked statement."""
    j, t = pair
    _jt, jmarked, jvalues = jparameterize(jparse(sql))
    _tt, marked, values = parameterize(parse_statement(sql))
    assert values == jvalues
    jplan = joptimize(jplan_query(jmarked, j.session), j.session)
    plan = optimize(plan_query(marked, t.session), t.session)
    return jplan, plan, values


def _plan_exprs(plan):
    out = []

    def walk(n):
        for f in ("predicate", "residual"):
            if getattr(n, f, None) is not None:
                out.append(getattr(n, f))
        out.extend(getattr(n, "exprs", None) or ())
        for c in n.children:
            walk(c)
    for r in [plan.root] + list(plan.init_plans):
        walk(r)
    return out


@pytest.mark.parametrize("i", range(len(MARKED)))
def test_collect_has_and_bind_equal_reference(pair, i):
    """The marked plan holds the same Param slots (slot, type) as the
    reference's; ``bind_plan`` leaves no Param and prints the same plan
    as the reference's bound plan. An integer literal's slot is INTEGER
    in the port (Presto's LongLiteral typing) and BIGINT in the
    reference, unless it meets a BIGINT operand (``count(*) > 10``): the
    slots and plan tokens of PARAM_RETYPED (tests/torch_retyped.py)."""
    j, t = pair
    jplan, plan, values = _plans(pair, MARKED[i])
    assert values
    assert P.has_params(plan) and JP.has_params(jplan)
    got = [(p.slot, p.type.display()) for p in
           P.collect_params(_plan_exprs(plan))]
    want = [(p.slot, p.type.display()) for p in
            JP.collect_params(_plan_exprs(jplan))]
    integer_slots, pairs = PARAM_RETYPED.get(i, ((), ()))
    assert [w for s, w in want if s in integer_slots] == \
        ["bigint"] * len(integer_slots)
    assert got == [(s, "integer" if s in integer_slots else w)
                   for s, w in want] and len(got) == len(values)
    bound = P.bind_plan(plan, values)
    assert not P.has_params(bound)
    assert P.has_params(plan)               # the template is untouched
    text = print_plan(bound)
    assert_retyped(text, jprint_plan(JP.bind_plan(jplan, values)), pairs)


@pytest.mark.parametrize("i", range(len(MARKED)))
def test_param_rows_equal_inlined_literals(pair, i):
    """The parameterized plan, run under its bindings, returns the
    reference's rows for the statement with its literals inlined."""
    j, t = pair
    _jplan, plan, values = _plans(pair, MARKED[i])
    import dataclasses
    session = dataclasses.replace(t.session, param_bindings=values)
    got = execute_plan(plan, session, "cpu", t.rows_per_batch).rows
    assert_rows_match(got, j.execute(MARKED[i]).rows, REL)


def _batch():
    rng = np.random.default_rng(SEED)
    n = 1000
    return Batch.from_pydict({
        "a": (T.BIGINT, rng.integers(-50, 50, n).tolist()),
        "d": (T.DOUBLE, rng.normal(0, 10, n).tolist()),
        "dt": (T.DATE, rng.integers(8000, 10000, n).tolist()),
        "m": (T.DecimalType(12, 2),
              [int(x) for x in rng.integers(-10 ** 6, 10 ** 6, n)]),
    }, device="cpu")


@pytest.mark.parametrize("col,typ,value", [
    (0, T.BIGINT, 7), (1, T.DOUBLE, 2.5), (2, T.DATE, 9000),
    (3, T.DecimalType(12, 2), 12345)])
def test_param_val_equals_literal(col, typ, value):
    """A Param evaluates to the same storage values as the Literal of
    its binding (in a comparison and in arithmetic), on a seeded
    batch."""
    b = _batch()
    inputs = [Val(c.data, c.validity, c.type, c.dictionary)
              for c in b.columns]
    ref = ir.InputRef(type=typ, index=col)
    lit = ir.Literal(type=typ, value=value)
    par = ir.param(0, value, typ)
    with P.bound({0: value}):
        for name in ("lt", "eq", "ge"):
            a = C.eval_expr(ir.Call(type=T.BOOLEAN, name=name,
                                    args=(ref, lit)), inputs)
            p = C.eval_expr(ir.Call(type=T.BOOLEAN, name=name,
                                    args=(ref, par)), inputs)
            assert torch.equal(a.data, p.data)
            assert torch.equal(a.valid, p.valid)
        v = C.eval_expr(par, inputs)
        assert v.data.shape[0] == b.capacity
        assert v.data.dtype == typ.storage_dtype
        assert bool(v.valid.all())
        assert set(v.data.tolist()) == {typ.to_storage(value)}


def test_param_scalar_made_once_per_query_and_device(pair, monkeypatch):
    """Each binding becomes one device scalar per query and device:
    a query over many batches makes one per slot, not one per batch."""
    _j, t = pair
    made = []
    real = P._Scope.__init__

    def init(self, values):
        real(self, values)
        made.append(self)

    monkeypatch.setattr(P._Scope, "__init__", init)
    runner = LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 10)
    sql = ("select count(*) from lineitem where l_quantity > 5 "
           "and l_discount < 0.09")
    runner.execute(sql, properties=TPROPS)
    assert len(made) == 1
    (scope,) = made
    assert sorted(scope.scalars) == [(0, "cpu"), (1, "cpu")]
    assert runner.last_stats.by_node       # many batches ran
    batches = max(s.batches for s in runner.last_stats.by_node.values())
    assert batches > 10


def test_param_outside_binding_scope_raises(pair):
    """A parameterized plan run without its bindings raises in both
    packages (RuntimeError), never a stale build-time value."""
    j, t = pair
    from presto_tpu.exec.local import execute_plan as jexecute_plan
    jplan, plan, _values = _plans(pair, MARKED[0])
    with pytest.raises(RuntimeError, match="binding scope"):
        jexecute_plan(jplan, j.session, j.rows_per_batch)
    with pytest.raises(RuntimeError, match="binding scope"):
        execute_plan(plan, t.session, "cpu", t.rows_per_batch)
    b = _batch()
    inputs = [Val(c.data, c.validity, c.type, c.dictionary)
              for c in b.columns]
    with pytest.raises(RuntimeError, match="binding scope"):
        C.eval_expr(ir.param(0, 1, T.BIGINT), inputs)
    with P.bound({1: 5}):
        with pytest.raises(RuntimeError, match="no binding"):
            C.eval_expr(ir.param(0, 1, T.BIGINT), inputs)
    with JP.bound({1: 5}):
        with pytest.raises(RuntimeError, match="no binding"):
            JP.current_args([JP.collect_params(
                [__import__("presto_tpu.expr.ir", fromlist=["ir"])
                 .param(0, 1, JT.BIGINT)])[0]])


def test_consult_records_guards_only_while_recording():
    p = ir.param(3, 42, T.BIGINT)
    assert P.consult(p) == 42
    with P.recording_guards() as guards:
        P.consult(p)
    assert guards == [(3, 42)]


@pytest.mark.parametrize("props,where", [
    ({"scan_prefetch": True, "scan_threads": 2}, "split prefetch"),
    ({"probe_prefetch": True}, "probe producer"),
    ({"task_concurrency": 4, "dense_grouping": False}, "parallel_drivers"),
])
def test_bindings_reach_batch_threads(pair, monkeypatch, props, where):
    """The binding scope opens before any thread that runs batches is
    started, so those threads see this query's bindings: the split
    prefetch workers run in it (they generate and stage splits; filters
    run downstream), and Params evaluated on the probe producer and the
    ``parallel_drivers`` threads read it. Rows equal the reference's
    with the literal inlined."""
    from presto_tpu_torch.connectors.tpch import TpchConnector
    j, t = pair
    seen = []                   # (thread name, binding scope visible)
    real_val = C.param_val
    real_source = TpchConnector.page_source

    def spy_val(p, n, device):
        seen.append((threading.current_thread().name, "param"))
        return real_val(p, n, device)

    def spy_source(self, *a, **k):
        if P._BINDINGS.get() is not None:
            seen.append((threading.current_thread().name, "split"))
        return real_source(self, *a, **k)

    monkeypatch.setattr(C, "param_val", spy_val)
    monkeypatch.setattr(TpchConnector, "page_source", spy_source)
    runner = LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 11)
    if where == "probe producer":
        sql = ("select o_orderpriority, count(*) from orders join "
               "lineitem on o_orderkey = l_orderkey "
               "where l_quantity > 45 and o_totalprice > 1000.5 "
               "group by 1 order by 1")
    else:
        sql = ("select l_orderkey, count(*), sum(l_quantity) from lineitem "
               "where l_quantity > 25 group by 1 order by 1 limit 50")
    got = runner.execute(sql, properties={**TPROPS, **props}).rows
    assert_rows_match(got, j.execute(sql).rows, REL)
    main = threading.main_thread().name
    kind = "split" if where == "split prefetch" else "param"
    assert any(name != main and k == kind for name, k in seen), \
        (where, seen)
