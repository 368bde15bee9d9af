"""The aggregates this slice ports, through presto_tpu and
presto_tpu_torch on the same seeded inputs on the CPU: MarkDistinct's
first-occurrence flags, variance and boolean aggregates in every mode
(single, partial -> merge -> final), the drained grouped percentiles,
and the same shapes in SQL over TPC-H SF 0.01 (DISTINCT beside other
aggregates, the 1e15-shift case of tests/test_sql.py). Integers,
booleans, strings and sketch results exactly; doubles within rel 1e-12
(the summation order differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.exec.runner import LocalRunner
from presto_tpu.ops import aggregation as JA
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.ops import aggregation as TA

from torch_parity import (
    assert_results_match, assert_rows_match, port_type, sorted_rows, to_port,
)

SEED = 20261017
REL = 1e-12


def _batch(n=1200, k=0):
    """A seeded batch: string and int keys (with NULLs), doubles shifted
    far from zero, ints, booleans; a tail of dead lanes."""
    rng = np.random.default_rng(SEED + k)
    keys = ["a", "b", "c", None]
    data = {
        "ks": (JT.VARCHAR, [keys[i] for i in rng.integers(0, 4, n)]),
        "ki": (JT.BIGINT, [None if v == 0 else int(v)
                           for v in rng.integers(0, 40, n)]),
        "x": (JT.DOUBLE, [None if rng.random() < 0.05 else
                          float(1e15 + rng.normal() * 3) for _ in range(n)]),
        "q": (JT.BIGINT, [int(v) for v in rng.integers(-50, 50, n)]),
        "b": (JT.BOOLEAN, [None if v == 2 else bool(v)
                           for v in rng.integers(0, 3, n)]),
        "p": (JT.DOUBLE, [float(v) for v in rng.lognormal(3, 2, n)]),
    }
    jb = JBatch.from_pydict(data)
    mask = np.asarray(jb.row_mask).copy()
    mask[n - n // 10:] = False
    return JBatch(jb.schema, jb.columns, jnp.asarray(mask))


def _spec(mod, fn, inp, out_t, name, mask=None, param=None):
    t = out_t if mod is JA else port_type(out_t)
    return mod.AggSpec(fn, inp, t, name, mask=mask, param=param)


AGGS = [("var_samp", 2, JT.DOUBLE), ("var_pop", 2, JT.DOUBLE),
        ("stddev_samp", 3, JT.DOUBLE), ("stddev_pop", 2, JT.DOUBLE),
        ("bool_and", 4, JT.BOOLEAN), ("bool_or", 4, JT.BOOLEAN),
        ("count", 2, JT.BIGINT), ("sum", 3, JT.BIGINT),
        ("approx_distinct", 3, JT.BIGINT)]


def _specs(mod):
    return [_spec(mod, fn, i, t, f"a{j}") for j, (fn, i, t) in
            enumerate(AGGS)]


@pytest.mark.parametrize("group", [[0], [1], [0, 1], [0, 4]])
def test_grouped_single_matches(group):
    jb = _batch()
    want = JA.grouped_aggregate(jb, group, _specs(JA), "single")
    got = TA.grouped_aggregate(to_port(jb), group, _specs(TA), "single")
    assert_rows_match(sorted_rows(got), sorted_rows(want), REL)


@pytest.mark.parametrize("group", [[0], [1, 0]])
def test_grouped_partial_merge_final_matches(group):
    """Partials of two batches merge (Chan's combination) and finalize."""
    parts_j, parts_t = [], []
    for k in (1, 2):
        jb = _batch(800, k)
        parts_j.append(JA.grouped_aggregate(jb, group, _specs(JA), "partial"))
        parts_t.append(TA.grouped_aggregate(to_port(jb), group, _specs(TA),
                                            "partial"))
    from presto_tpu.batch import concat_batches as jcat
    from presto_tpu_torch.batch import concat_batches as tcat
    keys = list(range(len(group)))
    mj = JA.grouped_aggregate(jcat(parts_j), keys, _specs(JA), "merge")
    mt = TA.grouped_aggregate(tcat(parts_t), keys, _specs(TA), "merge")
    want = JA.grouped_aggregate(mj, keys, _specs(JA), "final")
    got = TA.grouped_aggregate(mt, keys, _specs(TA), "final")
    assert_rows_match(sorted_rows(got), sorted_rows(want), REL)


def test_global_modes_match():
    jb = _batch()
    tb = to_port(jb)
    for mode in ("single", "partial"):
        assert_rows_match(
            TA.global_aggregate(tb, _specs(TA), mode).to_pylist()
            if mode == "single" else
            TA.global_aggregate(TA.global_aggregate(tb, _specs(TA), mode),
                                _specs(TA), "final").to_pylist(),
            JA.global_aggregate(jb, _specs(JA), mode).to_pylist()
            if mode == "single" else
            JA.global_aggregate(JA.global_aggregate(jb, _specs(JA), mode),
                                _specs(JA), "final").to_pylist(), REL)


@pytest.mark.parametrize("p", [0.0, 0.5, 0.99])
def test_percentiles_match(p):
    """Grouped percentiles drain exactly; the global one carries the
    histogram state through partial -> final."""
    jb = _batch()
    tb = to_port(jb)

    def specs(mod):
        return [_spec(mod, "approx_percentile", 5, JT.DOUBLE, "pct",
                      param=p),
                _spec(mod, "approx_percentile", 0, JT.VARCHAR, "s",
                      param=p),
                _spec(mod, "count", 2, JT.BIGINT, "n")]
    want = JA.grouped_aggregate(jb, [1], specs(JA), "single")
    got = TA.grouped_aggregate(tb, [1], specs(TA), "single")
    assert_rows_match(sorted_rows(got), sorted_rows(want), 0.0)
    one = [specs(TA)[0]], [specs(JA)[0]]
    got = TA.global_aggregate(TA.global_aggregate(tb, one[0], "partial"),
                              one[0], "final").to_pylist()
    want = JA.global_aggregate(JA.global_aggregate(jb, one[1], "partial"),
                               one[1], "final").to_pylist()
    assert got == want


@pytest.mark.parametrize("cols", [[0], [1], [0, 1], [2], [4, 0]])
def test_mark_distinct_flags_match(cols):
    jb = _batch()
    want = np.asarray(JA.mark_distinct_flags(jb, cols))
    got = TA.mark_distinct_flags(to_port(jb), cols).numpy()
    assert np.array_equal(want, got)


# -- SQL ---------------------------------------------------------------------

SQL = {
    "mixed_distinct":
        "select count(*), count(distinct l_suppkey), "
        "sum(distinct l_linenumber) from lineitem",
    "grouped_mixed_distinct":
        "select l_returnflag, count(distinct l_suppkey), avg(l_quantity), "
        "sum(distinct l_linenumber) from lineitem group by 1 order by 1",
    "variance_family":
        "select l_returnflag, stddev(l_quantity), var_pop(l_discount), "
        "var_samp(l_tax), stddev_pop(l_quantity), variance(l_extendedprice) "
        "from lineitem group by l_returnflag order by 1",
    "variance_shift_1e15":
        "select stddev(l_quantity + 1000000000000000.0) a, "
        "stddev(l_quantity) b from lineitem",
    "grouped_variance_shift_1e15":
        "select l_returnflag, stddev(l_quantity + 1000000000000000.0) a, "
        "stddev(l_quantity) b from lineitem group by 1 order by 1",
    "bool_aggs":
        "select bool_and(o_totalprice > 1000), "
        "bool_or(o_totalprice > 500000), every(o_orderkey > 0) from orders",
    "grouped_bool_aggs":
        "select o_orderstatus, bool_and(o_totalprice > 1000), "
        "bool_or(o_totalprice > 400000) from orders group by 1 order by 1",
    "approx_distinct":
        "select approx_distinct(o_custkey), approx_distinct(o_clerk), "
        "approx_distinct(o_totalprice, 0.1) from orders",
    "grouped_approx_percentile":
        "select o_orderstatus, approx_percentile(o_totalprice, 0.5), "
        "approx_percentile(o_orderpriority, 0.5) "
        "from orders group by o_orderstatus order by 1",
    "global_approx_percentile":
        "select approx_percentile(o_totalprice, 0.9), "
        "approx_percentile(o_orderkey, 0.5), approx_percentile(o_clerk, 0.1)"
        " from orders",
    "sort_path_distinct":
        "select l_orderkey, count(distinct l_suppkey), variance(l_quantity),"
        " sum(l_linenumber) from lineitem group by l_orderkey "
        "order by 4 desc, 1 limit 10",
    "empty_input":
        "select stddev(o_totalprice), bool_and(o_totalprice > 0), "
        "approx_distinct(o_custkey), approx_percentile(o_totalprice, 0.5), "
        "count(distinct o_custkey), count(*) from orders where o_orderkey < 0",
}


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


@pytest.mark.parametrize("name", list(SQL))
def test_aggregate_sql_matches_reference(runners, name):
    jr, tr = runners
    got = tr.execute(SQL[name])
    assert got.rows
    assert_results_match(got, jr.execute(SQL[name]), REL)


def test_variance_shift_keeps_stddev(runners):
    """Central moments do not cancel: shifting by 1e15 leaves stddev
    within 1e-3 of the unshifted (a sum-of-squares state fails here)."""
    _, tr = runners
    (a, b), = tr.execute(SQL["variance_shift_1e15"]).rows
    assert a == pytest.approx(b, rel=1e-3)


@pytest.mark.parametrize("e", ["0.5", "0.001"])
def test_approx_distinct_error_out_of_range(runners, e):
    """The standard-error argument is range-checked at planning, as in
    the reference."""
    from presto_tpu.sql.analyzer import AnalysisError as JErr
    from presto_tpu_torch.sql.analyzer import AnalysisError as TErr
    sql = f"select approx_distinct(o_custkey, {e}) from orders"
    jr, tr = runners
    with pytest.raises(JErr, match="standard error") as want:
        jr.execute(sql)
    with pytest.raises(TErr) as got:
        tr.execute(sql)
    assert str(got.value) == str(want.value)
