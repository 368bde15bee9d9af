"""Integer literals and decimal-integral arithmetic in presto_tpu_torch,
typed as Presto 319 types them, against presto_tpu on the same
statements (both LocalRunners on the CPU over TPC-H SF 0.01). Each case
asserts the reference's type, value or error first (it stays as it
is), then the port's.

Presto's rules:

- ``ExpressionAnalyzer.visitLongLiteral``: a literal is INTEGER when it
  lies in [-2^31, 2^31-1] and BIGINT otherwise. The reference types
  every one BIGINT.
- Presto 319's grammar (``SqlBase.g4``) has no signed number: ``number``
  is ``INTEGER_VALUE #integerLiteral``, and a sign is ``operator=(MINUS |
  PLUS) valueExpression #arithmeticUnary``. So ``-2147483648`` is the
  negation of the BIGINT literal 2147483648 and stays BIGINT.
- ``DecimalOperators``: an integral operand counts as the decimal it
  coerces to (TINYINT, SMALLINT, INTEGER, BIGINT: decimal(3|5|10|19, 0));
  the reference counts every one as 19 digits. Modulus is
  ``decimal(min(p1-s1, p2-s2) + max(s1, s2), max(s1, s2))``; the
  reference gives it the formula of ``+``, so a decimal modulo any
  integral type is a long decimal there and raises.

The statements then run on a 4-slot CPU mesh and through a two-worker
CPU cluster, whose rows must equal the single device's."""
import datetime
from decimal import Decimal

import pytest
import torch

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.errors import QueryError
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match

SF = 0.01
_INT = ("bigint", "integer")


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=SF), TLocalRunner(tpch_sf=SF, device="cpu")


def _types(result):
    return [t.display() for t in result.types]


def _rows(result):
    return [tuple(r) for r in result.rows]


def _raises(port, sql: str, name: str, **kw) -> None:
    with pytest.raises(QueryError) as ei:
        port.execute(sql, **kw)
    assert ei.value.name == name, (sql, ei.value.name)


# -- the literal's own type --------------------------------------------------

#: (literal as written, the port's type, its value); the reference types
#: every one bigint
LITERALS = [
    ("0", "integer", 0),
    ("2147483647", "integer", 2147483647),
    ("-2147483647", "integer", -2147483647),
    ("2147483648", "bigint", 2147483648),
    ("-2147483648", "bigint", -2147483648),
    ("-(2147483648)", "bigint", -2147483648),
    ("-(2147483647)", "integer", -2147483647),
    ("- -2147483648", "bigint", 2147483648),
    ("-2147483649", "bigint", -2147483649),
    ("9223372036854775807", "bigint", 9223372036854775807),
]


@pytest.mark.parametrize("literal,port_type,value", LITERALS)
def test_literal_type(runners, literal, port_type, value):
    ref, port = runners
    sql = f"select {literal}"
    want, got = ref.execute(sql), port.execute(sql)
    assert _types(want) == ["bigint"] and _rows(want) == [(value,)]
    assert _types(got) == [port_type] and _rows(got) == [(value,)]


@pytest.mark.parametrize("text,value,typ", [
    ("-2147483648", -2147483648, T.BIGINT),
    ("-(2147483648)", -2147483648, T.BIGINT),
    ("-(2147483647)", -2147483647, T.INTEGER),
    ("-2147483647", -2147483647, T.INTEGER),
    ("+2147483647", 2147483647, T.INTEGER),
])
def test_sign_fold_keeps_the_unsigned_literals_type(text, value, typ):
    """The parser folds a unary minus into the literal; the folded
    literal keeps the type of the unsigned literal as written, as
    Presto's ``arithmeticUnary`` over an ``integerLiteral`` does."""
    from presto_tpu_torch.sql import ast as A
    from presto_tpu_torch.sql.analyzer import literal_type
    from presto_tpu_torch.sql.parser import parse_statement
    expr = parse_statement(f"select {text}").body.select[0].value
    assert expr == A.LongLiteral(value)
    assert literal_type(expr) == typ


def test_integer_column_plus_literal_raises_past_int32(runners):
    """ROADMAP §3's statement: the literal is INTEGER, so the sum is
    INTEGER and raises at the first key above 47; the reference types it
    BIGINT and gives 2147483601 first."""
    ref, port = runners
    sql = "select cast(o_orderkey as integer) + 2147483600 from orders"
    want = ref.execute(sql + " order by o_orderkey limit 1")
    assert _types(want) == ["bigint"] and _rows(want) == [(2147483601,)]
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    fits = port.execute(sql + " where o_orderkey <= 47 order by 1")
    assert _types(fits) == ["integer"]
    assert _rows(fits) == [(k + 2147483600,) for k in range(1, 48)]
    _raises(port, sql + " where o_orderkey <= 48",
            "NUMERIC_VALUE_OUT_OF_RANGE")


def test_overflowing_constant_raises_when_the_statement_runs(runners):
    """``2147483647 + 1`` is INTEGER + INTEGER: it plans (EXPLAIN prints
    it) and raises NUMERIC_VALUE_OUT_OF_RANGE when it runs; TRY gives
    NULL. The reference gives the BIGINT 2147483648."""
    ref, port = runners
    sql = "select 2147483647 + 1"
    want = ref.execute(sql)
    assert _types(want) == ["bigint"] and _rows(want) == [(2147483648,)]
    assert port.execute("explain " + sql).rows
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    got = port.execute("select try(2147483647 + 1)")
    assert _types(got) == ["integer"] and _rows(got) == [(None,)]
    assert _rows(ref.execute("select try(2147483647 + 1)")) == \
        [(2147483648,)]


def test_integer_division_and_modulus_over_values(runners):
    ref, port = runners
    sql = "select x / 2, x % 2 from (values (1), (5)) t(x) order by x"
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql),
                         retyped={0: _INT, 1: _INT})
    assert _rows(got) == [(0, 1), (2, 1)]


# -- decimal arithmetic with integral operands -------------------------------

#: the decimal(7,2) operand and an integral one per row
DEC_VALUES = ("(values (decimal '12345.67', 3), (decimal '-0.05', -7), "
              "(decimal '99999.99', 100), (decimal '-250.50', 11)) t(d, n)")
D = "cast(d as decimal(7,2))"
PAIRS = [(Decimal("12345.67"), 3), (Decimal("-0.05"), -7),
         (Decimal("99999.99"), 100), (Decimal("-250.50"), 11)]

#: (operand, the port's type of D * it, of D + it, of D % it)
OPERANDS = [
    ("cast(n as tinyint)", "decimal(10,2)", "decimal(8,2)", "decimal(5,2)"),
    ("cast(n as smallint)", "decimal(12,2)", "decimal(8,2)", "decimal(7,2)"),
    ("cast(n as integer)", "decimal(17,2)", "decimal(13,2)", "decimal(7,2)"),
    ("n", "decimal(17,2)", "decimal(13,2)", "decimal(7,2)"),
    ("cast(n as bigint)", "decimal(26,2)", "decimal(22,2)", "decimal(7,2)"),
]


def _dec_rem(a: Decimal, b, places: str = "0.01") -> Decimal:
    """Presto's decimal remainder: truncated, signed like the dividend."""
    return (a % Decimal(b)).quantize(Decimal(places))


@pytest.mark.parametrize("operand,mul_t,add_t,mod_t", OPERANDS)
def test_decimal_times_plus_integral(runners, operand, mul_t, add_t, mod_t):
    """Multiply and add: the reference's values with Presto's types (the
    reference's are decimal(26,2) and decimal(22,2) for every integral
    operand); the short results stay in int64 and are exact."""
    ref, port = runners
    sql = (f"select {D} * {operand}, {D} + {operand}, {operand} * {D} "
           f"from {DEC_VALUES}")
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql), retyped={
        0: ("decimal(26,2)", mul_t), 1: ("decimal(22,2)", add_t),
        2: ("decimal(26,2)", mul_t)})
    assert _rows(got) == [(d * n, d + n, d * n) for d, n in PAIRS]


@pytest.mark.parametrize("operand,mul_t,add_t,mod_t", OPERANDS)
def test_decimal_modulo_integral(runners, operand, mul_t, add_t, mod_t):
    """Presto's modulus type; the reference raises on every one."""
    ref, port = runners
    sql = f"select {D} % {operand} from {DEC_VALUES}"
    with pytest.raises(NotImplementedError, match="long decimal mod"):
        ref.execute(sql)
    got = port.execute(sql)
    assert _types(got) == [mod_t]
    assert _rows(got) == [(_dec_rem(d, n),) for d, n in PAIRS]


def test_decimal_modulo_literal_two(runners):
    ref, port = runners
    sql = f"select {D} % 2, {D} * 2, {D} + 2 from {DEC_VALUES}"
    with pytest.raises(NotImplementedError, match="long decimal mod"):
        ref.execute(sql)
    got = port.execute(sql)
    assert _types(got) == ["decimal(7,2)", "decimal(17,2)", "decimal(13,2)"]
    assert _rows(got) == [(_dec_rem(d, 2), d * 2, d + 2) for d, _ in PAIRS]


#: (statement, the port's type, its row): BIGINT operands whose rescale
#: leaves int64 (a divisor past 10^17 at scale 2, a bigint dividend at
#: scale 2) take the remainder on int128 limbs
WIDE_MODS = [
    ("select cast(7.25 as decimal(7,2)) % cast(200000000000000000 as bigint)",
     "decimal(7,2)", Decimal("7.25")),
    ("select cast(-7.25 as decimal(7,2)) % "
     "cast(-9223372036854775807 as bigint)", "decimal(7,2)", Decimal("-7.25")),
    ("select cast(123456789012345678 as bigint) % "
     "cast(7.25 as decimal(7,2))", "decimal(7,2)",
     _dec_rem(Decimal(123456789012345678), Decimal("7.25"))),
    ("select cast(-9223372036854775808 as bigint) % "
     "cast(99999.99 as decimal(7,2))", "decimal(7,2)",
     _dec_rem(Decimal(-9223372036854775808), Decimal("99999.99"))),
    ("select cast(17.5 as decimal(7,2)) % cast(2.5 as decimal(5,1))",
     "decimal(6,2)", Decimal("0.00")),
    ("select cast(-17.45 as decimal(7,2)) % cast(2.5 as decimal(5,1))",
     "decimal(6,2)", Decimal("-2.45")),
    ("select cast(99999999.99999 as decimal(13,5)) % "
     "cast(3 as decimal(18,0))", "decimal(13,5)",
     _dec_rem(Decimal("99999999.99999"), 3, "0.00001")),
]


@pytest.mark.parametrize("sql,port_type,row", WIDE_MODS)
def test_decimal_modulo_is_exact(runners, sql, port_type, row):
    _, port = runners
    got = port.execute(sql)
    assert _types(got) == [port_type] and _rows(got) == [(row,)]


def test_decimal_modulo_by_zero_and_long_dividend(runners):
    _, port = runners
    _raises(port, "select cast(1.5 as decimal(7,2)) % cast(0 as bigint)",
            "DIVISION_BY_ZERO")
    assert _rows(port.execute(
        "select try(cast(1.5 as decimal(7,2)) % 0)")) == [(None,)]
    # a dividend of more than 18 digits still raises, as in the reference
    with pytest.raises(NotImplementedError, match="long decimal mod"):
        port.execute("select cast(1.5 as decimal(20,2)) % 2")


def test_decimal_compare_with_integer_column(runners):
    """A long decimal compared with an INTEGER column counts its 10
    digits; the rows equal the reference's."""
    ref, port = runners
    sql = ("select n_nationkey from nation where cast(n_nationkey as "
           "integer) < cast(12.5 as decimal(30,1)) order by 1")
    assert_results_match(port.execute(sql), ref.execute(sql))


# -- the other planes that read a literal's type -----------------------------

def test_values_unify_rows_of_mixed_width(runners):
    ref, port = runners
    wide = "select x from (values (1), (5000000000)) t(x) order by x"
    assert_results_match(port.execute(wide), ref.execute(wide))
    assert _types(port.execute(wide)) == ["bigint"]
    narrow = "select x from (values (1), (2)) t(x) order by x"
    assert_results_match(port.execute(narrow), ref.execute(narrow),
                         retyped={0: _INT})


def test_array_of_literals_and_sequence(runners):
    ref, port = runners
    sql = "select array[1, 2], sequence(1, 3), array[1, 5000000000]"
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql), retyped={
        0: ("array(bigint)", "array(integer)")})
    assert _types(got) == ["array(integer)", "array(bigint)",
                           "array(bigint)"]


def test_functions_take_integer_arguments(runners):
    """substr, round, lpad, lag, ntile and nth_value coerce an INTEGER
    argument; GROUP BY and ORDER BY ordinals stay ordinals."""
    ref, port = runners
    sql = ("select n_nationkey, substr(n_name, 2, 3), "
           "round(n_nationkey * 1.5, 1), lpad(n_name, 12, '*'), "
           "lag(n_nationkey, 2) over (order by n_nationkey), "
           "ntile(4) over (order by n_nationkey), "
           "nth_value(n_name, 3) over (order by n_nationkey) "
           "from nation order by 1")
    assert_results_match(port.execute(sql), ref.execute(sql))
    sql = ("select o_orderstatus, count(*) from orders group by 1 "
           "order by 2 desc, 1")
    assert_results_match(port.execute(sql), ref.execute(sql))


#: an INTEGER expression summed on the sort path (a grouping key with no
#: stats bounds): sum is BIGINT, avg DOUBLE, in both packages
SORT_SUM = ("select o_custkey % 5 k, sum(case when o_orderpriority = "
            "'1-URGENT' then 1 else 0 end), avg(case when o_orderstatus = "
            "'F' then 2 else 0 end) from orders group by 1 order by 1")


def test_integer_sum_goes_through_the_segment_sum(runners):
    from presto_tpu_torch.ops import scan
    ref, port = runners
    before = scan.plain_calls
    got = port.execute(SORT_SUM)
    assert scan.plain_calls > before
    assert_results_match(got, ref.execute(SORT_SUM))
    assert _types(got) == ["bigint", "bigint", "double"]


def test_integer_sum_of_literals_overflows_in_the_addition(runners):
    """sum of an INTEGER expression is BIGINT and does not overflow; the
    INTEGER addition under it does."""
    _, port = runners
    ok = port.execute("select sum(k) from (values 2147483647, 2147483647) "
                      "t(k)")
    assert _types(ok) == ["bigint"] and _rows(ok) == [(4294967294,)]
    _raises(port, "select sum(k + 2147483600) from (values 1, 47, 48) t(k)",
            "NUMERIC_VALUE_OUT_OF_RANGE")


def test_insert_integer_literal_into_bigint_column(runners):
    """CTAS of literals into memory makes an INTEGER and a BIGINT column
    (two BIGINT in the reference); INSERT of INTEGER literals coerces to
    the table's types."""
    ref, port = runners
    for r in runners:
        r.execute("drop table if exists memory.default.lit_ins")
        r.execute("create table memory.default.lit_ins as "
                  "select 1 a, 5000000000 b")
        r.execute("insert into memory.default.lit_ins values (2, 7)")
    sql = "select a, b from memory.default.lit_ins order by a"
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql), retyped={0: _INT})
    assert _rows(got) == [(1, 5000000000), (2, 7)]
    for r in runners:
        r.execute("drop table memory.default.lit_ins")


@pytest.mark.parametrize("kind", ["orc", "parquet", "sqlite"])
def test_ctas_of_literals_writes_their_types(tmp_path, kind):
    """``select 1 a, 5000000000 b`` writes an INTEGER and a BIGINT column
    (ORC INT and LONG, Parquet INT32 and INT64) and reads them back; the
    reference writes two BIGINT columns. SQLite's INTEGER affinity is 64
    bits, and its catalog reads every INT column as BIGINT, in both."""
    from presto_tpu.connectors.spi import CatalogManager as JCatalogs
    from presto_tpu_torch.connectors.spi import CatalogManager
    if kind == "sqlite":
        from presto_tpu.connectors.sqlite import SqliteConnector as JConn
        from presto_tpu_torch.connectors.sqlite import SqliteConnector as Conn
        jconn, conn = (JConn(str(tmp_path / "j.db")),
                       Conn(str(tmp_path / "t.db")))
    else:
        from presto_tpu.connectors.orc import OrcConnector as JOrc
        from presto_tpu.connectors.parquet import ParquetConnector as JPq
        from presto_tpu_torch.connectors.orc import OrcConnector
        from presto_tpu_torch.connectors.parquet import ParquetConnector
        for d in ("j", "t"):
            (tmp_path / d).mkdir()
        jcls, cls = {"orc": (JOrc, OrcConnector),
                     "parquet": (JPq, ParquetConnector)}[kind]
        jconn, conn = jcls(str(tmp_path / "j")), cls(str(tmp_path / "t"))
    jc, tc = JCatalogs(), CatalogManager()
    jc.register("files", jconn)
    tc.register("files", conn)
    ref = LocalRunner(catalogs=jc, catalog="files")
    port = TLocalRunner(catalogs=tc, catalog="files", device="cpu")
    for r in (ref, port):
        r.execute("create table files.default.lits as "
                  "select 1 a, 5000000000 b, -7 c")
    sql = "select a, b, c from files.default.lits"
    got, want = port.execute(sql), ref.execute(sql)
    if kind == "sqlite":
        assert_results_match(got, want)
    else:
        assert_results_match(got, want, retyped={0: _INT, 2: _INT})
    assert _rows(got) == [(1, 5000000000, -7)]


def test_template_kind_follows_the_literals_range(runners):
    """``o_orderkey > 5`` and ``o_orderkey > 5000000000`` never share a
    template: the kind is the literal's type. An INTEGER slot compared
    with an INTEGER column binds in int32 storage, one compared with a
    BIGINT column is widened with it; the rows equal the reference's
    without templates."""
    from presto_tpu_torch.expr import params as P
    from presto_tpu_torch.serving.plancache import parse_cached
    from presto_tpu_torch.serving.template import parameterize
    ref, port = runners
    small = "select count(*) from orders where o_orderkey > 5"
    big = "select count(*) from orders where o_orderkey > 5000000000"
    ts, tb = (parameterize(parse_cached(s))[0] for s in (small, big))
    assert ts != tb
    assert "kind='integer'" in repr(ts) and "kind='bigint'" in repr(tb)
    props = {"plan_template_cache": True}
    for sql in (small, big, small.replace("> 5", "> 7")):
        assert _rows(port.execute(sql, properties=props)) == \
            _rows(ref.execute(sql))
    from presto_tpu_torch.planner.optimizer import optimize
    from presto_tpu_torch.planner.planner import plan_query
    for sql, want in (("select count(*) from part where p_size > 5",
                       (T.INTEGER, torch.int32)),
                      (small, (T.BIGINT, torch.int64))):
        _t, marked, values = parameterize(parse_cached(sql))
        planned = optimize(plan_query(marked, port.session), port.session)
        [param] = P.collect_params(_plan_exprs(planned))
        assert param.type == want[0]
        with P.bound(values):
            assert P.param_val(param, 3, "cpu").data.dtype == want[1]


def _plan_exprs(plan):
    out = []

    def walk(n):
        for f in ("predicate", "residual"):
            if getattr(n, f, None) is not None:
                out.append(getattr(n, f))
        out.extend(getattr(n, "exprs", None) or ())
        for c in n.children:
            walk(c)
    walk(plan.root)
    return out


@pytest.mark.parametrize("value,port_type", [("5", "integer"),
                                             ("5000000000", "bigint")])
def test_execute_using_follows_the_literals_type(runners, value,
                                                 port_type):
    ref, port = runners
    for r in runners:
        r.execute("prepare lit_p from select ? + 1 x")
    sql = f"execute lit_p using {value}"
    got, want = port.execute(sql), ref.execute(sql)
    assert _types(want) == ["bigint"] and _rows(want) == _rows(got)
    assert _types(got) == [port_type]


def test_codec_carries_integer_literals():
    import json
    from presto_tpu_torch.planner import codec
    r = TLocalRunner(tpch_sf=SF, device="cpu")
    root = r.plan("select n_name, 1 a, 2 b from nation "
                  "where n_nationkey < 5000000000").root
    doc = json.loads(json.dumps(codec.encode(root)))
    assert codec.decode(doc) == root
    literals = []

    def walk(d):
        if isinstance(d, dict):
            if d.get("$") == "Literal":
                literals.append((d["value"], d["type"]["$t"]))
            for v in d.values():
                walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)
    walk(doc)
    assert (1, "integer") in literals and (2, "integer") in literals
    assert (5000000000, "bigint") in literals


# -- the mesh and the cluster give the single device's rows ------------------

#: the statements above, whose rows the mesh and the cluster must give
#: (ARRAY columns cross no exchange page, in either package)
SHARDED = [
    "select 2147483647, 2147483648, -2147483648, -(2147483648), "
    "-2147483649",
    "select x / 2, x % 2 from (values (1), (5)) t(x) order by x",
    f"select {D} * cast(n as tinyint), {D} + cast(n as smallint), "
    f"{D} % cast(n as integer), {D} % cast(n as bigint), {D} % 2, "
    f"{D} * n from {DEC_VALUES}",
    WIDE_MODS[0][0],
    "select x from (values (1), (5000000000)) t(x) order by x",
    "select cast(o_orderkey as integer) + 2147483600 from orders "
    "where o_orderkey <= 47 order by 1",
    SORT_SUM,
    "select n_name, v.w from nation join (values (1, 'x'), (7, 'y'), "
    "(24, 'z')) v(k, w) on n_nationkey = v.k order by n_name",
    "select o_orderkey, cast(o_totalprice as decimal(12,2)) * 2, "
    "cast(o_totalprice as decimal(12,2)) % 7, "
    "cast(o_totalprice as decimal(12,2)) + cast(o_shippriority as integer)"
    " from orders where o_orderkey < 200 order by o_orderkey",
    "select o_orderstatus, count(*), sum(o_shippriority + 1) from orders "
    "where o_custkey > 5 group by 1 order by 1",
]

#: statements that must raise NUMERIC_VALUE_OUT_OF_RANGE there too
SHARDED_RAISES = [
    "select cast(o_orderkey as integer) + 2147483600 from orders",
    "select 2147483647 + 1",
    "select sum(k + 2147483600) from (values 1, 47, 48) t(k)",
]


def test_mesh_gives_the_single_devices_rows(runners, monkeypatch):
    from presto_tpu_torch.obs.metrics import REGISTRY
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    _, port = runners
    props = {"mesh_execution": "on", "mesh_devices": 4}
    selected = REGISTRY.counter("mesh_path_selected_total")
    before = selected.value
    for sql in SHARDED:
        got, want = port.execute(sql, properties=props), port.execute(sql)
        assert_results_match(got, want)
    assert selected.value > before
    for sql in SHARDED_RAISES:
        _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE", properties=props)


def test_cluster_gives_the_single_devices_rows(runners):
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.server.worker import WorkerServer
    _, port = runners
    workers = [WorkerServer(tpch_sf=SF, device="cpu") for _ in range(2)]
    for w in workers:
        w.start()
    try:
        cluster = ClusterRunner(
            [f"http://127.0.0.1:{w.port}" for w in workers], tpch_sf=SF,
            heartbeat=False, device="cpu")
        for sql in SHARDED:
            assert_results_match(cluster.execute(sql), port.execute(sql))
        for sql in SHARDED_RAISES:
            _raises(cluster, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    finally:
        for w in workers:
            w.stop()


#: chip_smoke.py's literal-typing statements of SURFACE_CHECKED
SMOKE_LITERALS = (
    "literal_types", "sum_integer_case_sort", "integer_plus_literal",
    "integer_plus_literal_overflow", "integer_sum_of_literals_overflow",
    "values_sum_overflow", "constant_overflow", "try_constant_overflow",
    "decimal_times_integer", "decimal_plus_smallint", "decimal_mod",
    "values_join_integer_key", "values_mixed_width")


def test_surface_phase_literal_statements_rehearsed(runners):
    """chip_smoke.py's literal-typing statements of its surface phase at
    SF 0.01, with a second CPU runner in the card's place: the listed
    types and error names on both, and the sort-path INTEGER sum through
    the segment sum's wrapper."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, port = runners
    other = TLocalRunner(tpch_sf=SF, device="cpu")
    statements = [s for s in smoke.SURFACE_CHECKED if s[0] in SMOKE_LITERALS]
    assert [s[0] for s in statements] == list(SMOKE_LITERALS)
    smoke._surface_checked(other, port, lambda: None, counter="plain_calls",
                           statements=statements)


def test_dates_are_untouched(runners):
    """Interval arithmetic keeps its internal BIGINT amount."""
    ref, port = runners
    sql = ("select o_orderdate + interval '3' day from orders "
           "order by o_orderkey limit 2")
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql))
    assert isinstance(_rows(got)[0][0], datetime.date)
