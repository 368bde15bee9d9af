"""ARRAY and MAP columns, the array functions, lambdas and UNNEST through
presto_tpu and presto_tpu_torch on the CPU: array columns built from
python values carried across (to_port), concatenated, compacted and
decoded; the array and map functions and the higher-order functions in
SQL; UNNEST with ordinality and zipped arrays over TPC-H SF 0.01. Every
comparison is exact (no doubles here). The LIMIT case asserts the right
column order: there the reference permutes the values (ROADMAP §3)."""
import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch import types as TT
from presto_tpu_torch.batch import Batch as TBatch, concat_batches
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match, to_port

ARRAYS = [[1, 2, 3], None, [], [None, 5], [7] * 9]
STRINGS = [["a", "b"], ["b", None, "c"], None, ["zz"]]


def _pydict(typ_j, arrays):
    return {"k": (JT.BIGINT, list(range(len(arrays)))),
            "a": (typ_j, arrays)}


@pytest.mark.parametrize("elem,values", [("bigint", ARRAYS),
                                         ("varchar", STRINGS)])
def test_array_column_carries_across(elem, values):
    jb = JBatch.from_pydict(_pydict(JT.parse_type(f"array({elem})"),
                                    values))
    tb = to_port(jb)
    assert tb.to_pylist() == jb.to_pylist()
    built = TBatch.from_pydict(
        {"k": (TT.BIGINT, list(range(len(values)))),
         "a": (TT.parse_type(f"array({elem})"), values)}, device="cpu")
    assert built.to_pylist() == jb.to_pylist()


def test_array_columns_concat_compact_and_pad():
    t = TT.parse_type("array(varchar)")
    a = TBatch.from_pydict({"a": (t, STRINGS)}, device="cpu")
    b = TBatch.from_pydict({"a": (t, [["c", "d", "e", "f"], ["a"]])},
                           device="cpu")
    both = concat_batches([a, b])
    want = [(r,) for r in STRINGS + [["c", "d", "e", "f"], ["a"]]]
    assert both.to_pylist() == want
    keep = both.row_mask.clone()
    keep[1] = False
    sparse = TBatch(both.schema, both.columns, keep)
    assert sparse.compact(128).to_pylist() == want[:1] + want[2:]
    assert both.pad(512).to_pylist() == want


SQL = {
    "constructors_and_access":
        "select cardinality(array[1,2,3]), array[1,2,3][2], "
        "element_at(array[1,2,3], -1), element_at(array[1,2], 5), "
        "contains(array[1,2,3], 2), contains(array[1, null], 3), "
        "array_position(array[3,2,1], 1), array_max(array[1,5,3]), "
        "array_min(array['b','a']), array_max(array[1, null])",
    "reshaping":
        "select array_sort(array[3,1,null,2]), array_sort(array['b','a']), "
        "array_distinct(array[1,1,2,null,null]), "
        "array_concat(array[1], array[2,3], array[4]), "
        "array_concat(array['x'], array['y']), repeat(7, 3), "
        "sequence(1, 5), sequence(10, 1, -3), split('a,b,c', ','), "
        "split('a,b,c', ',', 2)",
    "lambdas":
        "select transform(array[1,2,3], x -> x * 2), "
        "filter(array[1,2,3,4], x -> x % 2 = 0), "
        "any_match(array[1,2], x -> x > 1), all_match(array[1,2], x -> x > 1),"
        " none_match(array[1,2], x -> x > 5), "
        "reduce(array[1,2,3], 0, (s, x) -> s + x, s -> s * 10), "
        "transform(array['a','b'], s -> upper(s)), "
        "all_match(array[1, null], x -> x > 0)",
    "lambda_captures_column":
        "select n_name, transform(array[n_nationkey, n_regionkey], "
        "x -> x + n_regionkey), filter(array[n_nationkey, 7], "
        "x -> x > n_regionkey) from nation where n_nationkey < 12",
    "maps":
        "select map(array['a','b'], array[1,2])['b'], "
        "element_at(map(array[1,2], array[10,20]), 3), "
        "map_keys(map(array['a','b'], array[1,2])), "
        "map_values(map(array['a','b'], array[1,2])), "
        "cardinality(map(array[1], array[2])), "
        "map(array[1,2], array['x','y'])",
    "array_columns_through_operators":
        "select n_regionkey, array[n_nationkey, n_regionkey] a, "
        "split(n_name, 'A') from nation order by n_name desc limit 7",
    "unnest_literal": "select x from unnest(array[1,2,3]) as t(x)",
    "unnest_sequence": "select x from unnest(sequence(1, 10)) as t(x)",
    "cross_join_unnest":
        "select n_name, x from nation cross join "
        "unnest(array[n_nationkey, n_regionkey]) as t(x) order by 1, 2",
    "unnest_with_ordinality":
        "select n_name, x, o from nation cross join "
        "unnest(array[n_nationkey, n_regionkey]) with ordinality as t(x, o)"
        " order by 1, 3",
    "unnest_zip":
        "select x, y from unnest(array[1,2,3], array['a','b']) as t(x, y)",
    "unnest_grouped":
        "select u, count(*), sum(x) from orders cross join "
        "unnest(array[o_orderstatus, o_orderpriority], "
        "array[o_custkey, o_shippriority]) as t(u, x) group by u order by u",
    "unnest_split":
        "select r_name, w from region cross join "
        "unnest(split(r_comment, ' ')) as t(w) order by 1, 2 limit 40",
}


#: columns built from integer literals: ``array[1,2]`` is array(integer)
#: in the port (Presto's LongLiteral typing) and array(bigint) in the
#: reference, and so are its elements, maps and lambda results;
#: ``sequence`` and ``cardinality`` stay bigint in both
_INT = ("bigint", "integer")
_AINT = ("array(bigint)", "array(integer)")
RETYPED = {
    "constructors_and_access": {1: _INT, 2: _INT, 3: _INT, 7: _INT, 9: _INT},
    "reshaping": {0: _AINT, 2: _AINT, 3: _AINT, 5: _AINT},
    "lambdas": {0: _AINT, 1: _AINT, 5: _INT},
    "maps": {0: _INT, 1: _INT, 3: _AINT,
             5: ("map(bigint, varchar(1))", "map(integer, varchar(1))")},
    "unnest_literal": {0: _INT},
    "unnest_zip": {0: _INT},
}


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


@pytest.mark.parametrize("name", list(SQL))
def test_array_sql_matches_reference(runners, name):
    jr, tr = runners
    got = tr.execute(SQL[name])
    assert got.rows
    assert_results_match(got, jr.execute(SQL[name]), 0.0, RETYPED.get(name))


def test_unnest_limit_keeps_column_order(runners):
    """Under LIMIT without ORDER BY the port returns the values in the
    select list's order; the reference permutes them (ROADMAP §3)."""
    jr, tr = runners
    sql = ("select n_name, n_regionkey, x from nation cross join "
           "unnest(array[n_nationkey]) as u(x)")
    got = tr.execute(sql + " limit 2")
    assert got.names == ["n_name", "n_regionkey", "x"]
    assert got.rows == [("ALGERIA", 0, 0), ("ARGENTINA", 1, 1)]
    assert got.rows == tr.execute(sql).rows[:2] == jr.execute(sql).rows[:2]
    # the reference's answer under LIMIT, kept here to show the fault
    assert jr.execute(sql + " limit 2").rows[0] == (0, "ALGERIA", 0)


def test_unnest_union_limit_keeps_column_order(runners):
    _, tr = runners
    sql = ("select n_name, x from nation cross join "
           "unnest(array[n_nationkey]) as u(x) union all "
           "select n_name, x from nation cross join "
           "unnest(array[n_regionkey]) as u(x)")
    got = tr.execute(sql + " limit 3").rows
    assert got == [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 2)]


@pytest.mark.parametrize("array", ["array[r_regionkey, 1]",
                                   "split(r_name, 'A')"])
def test_join_with_array_payload(runners, array):
    """An ARRAY column on the build side rides around the probe kernel (its
    row index does); the reference cannot run this shape (its build
    buffer reads ``.size`` of the column's tuple), so the port's rows are
    held against the reference building the array after the join."""
    jr, tr = runners
    got = tr.execute(
        f"select n.n_name, r.a, r.r_name from nation n join (select "
        f"r_regionkey, r_name, {array} a from region) r "
        "on n.n_regionkey = r.r_regionkey order by n.n_name")
    want = jr.execute(
        f"select n_name, {array.replace('r_', 'r.r_')}, r_name from "
        "nation n join region r on n.n_regionkey = r.r_regionkey "
        "order by n_name limit 25")
    assert got.rows == want.rows
    assert len(got.rows) == 25


def test_map_and_long_decimal_columns_carry_across(runners):
    """to_port carries a MAP column (four parts and a pair of
    vocabularies) and long-decimal limb pairs out of a JAX batch."""
    from presto_tpu.expr.compiler import compile_projection
    jr, _ = runners
    plan = jr.plan("select map(array['a', 'b'], array[n_nationkey, 2]) m, "
                   "cast(n_nationkey as decimal(30,2)) * 1000000000000 d "
                   "from nation")
    proj = plan.root.child
    scan = JBatch.from_pydict({"n_nationkey": (JT.BIGINT, list(range(5)))})
    jb = compile_projection(list(proj.exprs), ["m", "d"], scan.schema)(scan)
    tb = to_port(jb)
    assert tb.to_pylist() == jb.to_pylist()
    assert tb.columns[1].data.shape == (jb.capacity, 2)
