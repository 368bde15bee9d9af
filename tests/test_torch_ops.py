"""Operator parity: presto_tpu_torch's expression compiler, aggregation,
join and top-n against presto_tpu on the same seeded batches (the JAX
side on the CPU backend). Integers, dates and strings must be identical;
double sums may differ by summation order within rel 1e-12."""
import numpy as np
import pytest

from presto_tpu import types as T
from presto_tpu.batch import Batch
from presto_tpu.connectors.spi import TableHandle
from presto_tpu.connectors.tpch import TpchConnector
from presto_tpu.expr import call, input_ref, lit
from presto_tpu.expr.compiler import compile_filter, compile_projection
from presto_tpu.expr.ir import Form, special
from presto_tpu.ops import aggregation as A
from presto_tpu.ops import join as J
from presto_tpu.ops import sort as S
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compiler as TC
from presto_tpu_torch.expr import ir as TI
from presto_tpu_torch.ops import aggregation as TA
from presto_tpu_torch.ops import join as TJ
from presto_tpu_torch.ops import sort as TS

from torch_parity import assert_rows_match, sorted_rows, to_port

_COLS = ["l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
         "l_extendedprice", "l_discount", "l_shipdate", "l_tax"]


@pytest.fixture(scope="module")
def lineitem():
    conn = TpchConnector(sf=0.002)
    split = conn.split_manager.splits(TableHandle("tpch", "t", "lineitem"),
                                      1)[0]
    (batch,) = list(conn.page_source(split, _COLS,
                                     rows_per_batch=1 << 14).batches())
    return batch, to_port(batch)


def _q6_exprs(t, ir, shipdate=6, discount=5, quantity=3, price=4):
    """The Q6 predicate and projection of __graft_entry__._q6_exprs, built
    in either package's IR."""
    pred = ir.special(
        ir.Form.AND, t.BOOLEAN,
        ir.call("ge", t.BOOLEAN, ir.input_ref(shipdate, t.DATE),
                ir.lit("1994-01-01", t.DATE)),
        ir.call("lt", t.BOOLEAN, ir.input_ref(shipdate, t.DATE),
                ir.lit("1995-01-01", t.DATE)),
        ir.special(ir.Form.BETWEEN, t.BOOLEAN,
                   ir.input_ref(discount, t.DOUBLE), ir.lit(0.05, t.DOUBLE),
                   ir.lit(0.07, t.DOUBLE)),
        ir.call("lt", t.BOOLEAN, ir.input_ref(quantity, t.DOUBLE),
                ir.lit(24.0, t.DOUBLE)),
    )
    proj = [ir.call("multiply", t.DOUBLE, ir.input_ref(price, t.DOUBLE),
                    ir.input_ref(discount, t.DOUBLE))]
    return pred, proj


class _JaxIR:
    Form = Form
    special = staticmethod(special)
    call = staticmethod(call)
    input_ref = staticmethod(input_ref)
    lit = staticmethod(lit)


def test_q6_filter_and_projection(lineitem):
    jb, tb = lineitem
    jpred, jproj = _q6_exprs(T, _JaxIR)
    tpred, tproj = _q6_exprs(PT, TI)
    jout = compile_projection(jproj, ["rev"], jb.schema)(
        compile_filter(jpred, jb.schema)(jb))
    tout = TC.compile_projection(tproj, ["rev"], tb.schema)(
        TC.compile_filter(tpred, tb.schema)(tb))
    assert np.array_equal(tout.row_mask.numpy(), np.asarray(jout.row_mask))
    assert tout.row_mask.any()
    assert tout.to_pylist() == jout.to_pylist()


def test_error_channel_flags_division_by_zero(lineitem):
    """Integer division by zero records DIVISION_BY_ZERO on the row-error
    channel in both packages."""
    jb, tb = lineitem

    def div(t, ir):
        return ir.call("divide", t.BIGINT, ir.input_ref(0, t.BIGINT),
                       ir.lit(0, t.BIGINT))
    _, jerr = compile_projection([div(T, _JaxIR)], ["d"], jb.schema,
                                 errors=True)(jb)
    _, terr = TC.compile_projection([div(PT, TI)], ["d"], tb.schema,
                                    errors=True)(tb)
    assert int(terr) == int(jerr) != 0


def _aggs(t, agg_cls):
    return [agg_cls("sum", 3, t.DOUBLE, "sum_qty"),
            agg_cls("avg", 4, t.DOUBLE, "avg_price"),
            agg_cls("count_star", None, t.BIGINT, "n"),
            agg_cls("sum", 0, t.BIGINT, "sum_key"),
            agg_cls("min", 6, t.DATE, "first_ship"),
            agg_cls("max", 1, t.VARCHAR, "max_flag")]


@pytest.mark.parametrize("keys,allow_dense", [
    ([1, 2], True),          # dictionary keys: the dense slot path
    ([1, 2], False),         # the same grouping forced onto the sort path
    ([0, 6], False),         # high-cardinality keys: the sort path
])
def test_grouped_aggregate(lineitem, keys, allow_dense):
    jb, tb = lineitem
    jaggs, taggs = _aggs(T, A.AggSpec), _aggs(PT, TA.AggSpec)
    assert (TA.dense_path_selected(tb, keys, taggs) and allow_dense) == \
        (A.dense_path_selected(jb, keys, jaggs) and allow_dense)
    want = A.grouped_aggregate(jb, keys, jaggs, allow_dense=allow_dense)
    got = TA.grouped_aggregate(tb, keys, taggs, allow_dense=allow_dense)
    assert_rows_match(sorted_rows(got), sorted_rows(want), 1e-12)


def test_grouped_partial_then_final(lineitem):
    """PARTIAL states of two halves, concatenated, then FINAL — the
    executor's two-step shape over the sort path."""
    jb, tb = lineitem
    jaggs, taggs = _aggs(T, A.AggSpec), _aggs(PT, TA.AggSpec)
    want = A.grouped_aggregate(jb, [0], jaggs, allow_dense=False)
    from presto_tpu_torch.batch import Batch as TBatch, concat_batches
    half = tb.capacity // 2
    lo = TBatch(tb.schema, tb.columns, tb.row_mask.clone())
    lo.row_mask[half:] = False
    hi = TBatch(tb.schema, tb.columns, tb.row_mask.clone())
    hi.row_mask[:half] = False
    parts = [TA.grouped_aggregate(b, [0], taggs, mode="partial",
                                  allow_dense=False) for b in (lo, hi)]
    got = TA.grouped_aggregate(concat_batches(parts), [0], taggs,
                               mode="final", allow_dense=False)
    assert_rows_match(sorted_rows(got), sorted_rows(want), 1e-12)


def test_global_aggregate(lineitem):
    jb, tb = lineitem
    jaggs, taggs = _aggs(T, A.AggSpec), _aggs(PT, TA.AggSpec)
    want = A.global_aggregate(jb, jaggs).to_pylist()
    got = TA.global_aggregate(tb, taggs).to_pylist()
    assert_rows_match(got, want, 1e-12)


def _join_inputs(seed=1):
    rng = np.random.default_rng(seed)
    n = 300
    keys = rng.permutation(np.arange(10, 10 + 2 * n, 2))
    build = Batch.from_pydict({
        "k": (T.BIGINT, keys.tolist()),
        "v": (T.DOUBLE, rng.standard_normal(n).tolist()),
        "s": (T.VARCHAR, [f"x{i % 13}" if i % 11 else None
                          for i in range(n)])})
    pk = rng.integers(0, 2 * n + 30, 700).tolist()
    pk[3] = None
    probe = Batch.from_pydict({"p": (T.BIGINT, pk),
                               "q": (T.INTEGER, list(range(700)))})
    return build, probe


@pytest.mark.parametrize("jt", ["inner", "left"])
@pytest.mark.parametrize("strategy", ["direct", "sorted"])
def test_lookup_join(jt, strategy):
    build, probe = _join_inputs()
    tb, tp = to_port(build), to_port(probe)
    if strategy == "direct":
        jprep = J.prepare_direct(build, [0], 10, 1024)
        tprep = TJ.prepare_direct(tb, [0], 10, 1024)
    else:
        jprep, tprep = J.prepare_build(build, [0]), TJ.prepare_build(tb, [0])
    want = J.lookup_join(probe, build, [0], [0], [1, 2], ["v", "s"], jt,
                         prepared=jprep)
    got = TJ.lookup_join(tp, tb, [0], [0], [1, 2], ["v", "s"], jt,
                         prepared=tprep)
    assert sorted_rows(got) == sorted_rows(want)


def test_lookup_join_composite_sorted_keys():
    """Two-key sorted build: the composite binary search."""
    rng = np.random.default_rng(2)
    n = 200
    build = Batch.from_pydict({
        "a": (T.BIGINT, [i % 10 for i in range(n)]),
        "b": (T.BIGINT, [i // 10 for i in range(n)]),
        "v": (T.BIGINT, rng.integers(-99, 99, n).tolist())})
    probe = Batch.from_pydict({
        "x": (T.BIGINT, rng.integers(-1, 12, 400).tolist()),
        "y": (T.BIGINT, rng.integers(-1, 22, 400).tolist())})
    want = J.lookup_join(probe, build, [0, 1], [0, 1], [2], ["v"], "left")
    got = TJ.lookup_join(to_port(probe), to_port(build), [0, 1], [0, 1],
                         [2], ["v"], "left")
    assert sorted_rows(got) == sorted_rows(want)


@pytest.mark.parametrize("n", [1, 10, 200])
def test_top_n(lineitem, n):
    jb, tb = lineitem
    keys = [(4, False, None), (6, True, None), (0, True, None)]
    want = S.top_n(jb, [S.SortKey(*k) for k in keys], n).to_pylist()
    got = TS.top_n(tb, [TS.SortKey(*k) for k in keys], n).to_pylist()
    assert got == want
