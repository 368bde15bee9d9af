"""Expression parity: presto_tpu_torch's special forms (IF, CASE,
COALESCE, IN, NULLIF, TRY), date parts and vocabulary string functions
against presto_tpu's on the same seeded batch (NULLs included), with the
row-error channel compared as well: an error in a branch a row does not
take must not surface, one in the branch it takes must."""
import numpy as np
import pytest

from presto_tpu import types as T
from presto_tpu.batch import Batch
from presto_tpu.expr import ir as JI
from presto_tpu.expr.compiler import compile_projection
from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import compiler as TC
from presto_tpu_torch.expr import ir as TI

from torch_parity import to_port

N = 300
WORDS = ["ab", "a_b", " Abc ", "xyz", "A%c", "abab", "b", "", "Zebra  "]
OTHER = ["xyz", "q", "ab", "Qq", "none"]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(20261016)

    def nulls(vals, p=0.15):
        return [None if rng.random() < p else v for v in vals]

    a = nulls([int(x) for x in rng.integers(-20, 120, N)])
    b = [int(x) for x in rng.integers(0, 4, N)]          # zeros divide
    d = nulls([float(x) for x in rng.normal(0, 10, N)])
    s = nulls([WORDS[i] for i in rng.integers(0, len(WORDS), N)])
    t = nulls([OTHER[i] for i in rng.integers(0, len(OTHER), N)])
    import datetime
    base = datetime.date(1992, 1, 1)
    dt = nulls([base + datetime.timedelta(days=int(x))
                for x in rng.integers(0, 2500, N)])
    jb = Batch.from_pydict({"a": (T.BIGINT, a), "b": (T.BIGINT, b),
                            "d": (T.DOUBLE, d), "s": (T.VARCHAR, s),
                            "t": (T.VARCHAR, t), "dt": (T.DATE, dt)})
    return jb, to_port(jb)


def _exprs(t, ir):
    """name -> expression over (a, b, d, s, t, dt), in either package."""
    a, b = ir.input_ref(0, t.BIGINT), ir.input_ref(1, t.BIGINT)
    d, s = ir.input_ref(2, t.DOUBLE), ir.input_ref(3, t.VARCHAR)
    tt, dt = ir.input_ref(4, t.VARCHAR), ir.input_ref(5, t.DATE)
    F, B, I, V = ir.Form, t.BOOLEAN, t.BIGINT, t.VARCHAR

    def c(name, typ, *args):
        return ir.call(name, typ, *args)

    def n(v):
        return ir.lit(v, I)

    def sv(v):
        return ir.lit(v, V)
    return {
        "if_numeric": ir.special(F.IF, I, c("gt", B, a, n(0)),
                                 c("multiply", I, a, n(2)), b),
        "if_error_untaken": ir.special(F.IF, I, c("ne", B, b, n(0)),
                                       c("divide", I, a, b), n(-1)),
        "if_error_taken": ir.special(F.IF, I, c("gt", B, a, n(0)),
                                     c("divide", I, a, b), n(0)),
        "if_double": ir.special(F.IF, t.DOUBLE, c("lt", B, d, ir.lit(0.0,
                                                                   t.DOUBLE)),
                                c("negate", t.DOUBLE, d), d),
        "switch_numeric": ir.special(
            F.SWITCH, I, c("lt", B, a, n(0)), n(1),
            c("eq", B, b, n(0)), n(2), c("divide", I, a, b)),
        "switch_strings": ir.special(
            F.SWITCH, V, c("gt", B, a, n(50)), s, c("gt", B, a, n(0)), tt,
            sv("none")),
        "coalesce_numeric": ir.special(F.COALESCE, I, a, b, n(7)),
        "coalesce_strings": ir.special(F.COALESCE, V, s, tt, sv("-")),
        "coalesce_error": ir.special(F.COALESCE, I, a,
                                     c("divide", I, n(10), b)),
        "in_numeric": ir.special(F.IN, B, a, n(1), n(5), n(100), b),
        "in_string": ir.special(F.IN, B, s, sv("ab"), sv("b"), sv("nope")),
        "null_if": ir.special(F.NULL_IF, I, a, n(5)),
        "try": ir.special(F.TRY, I, c("divide", I, a, b)),
        "year": c("year", I, dt),
        "month": c("month", I, dt),
        "day": c("day", I, dt),
        "quarter": c("quarter", I, dt),
        "like_percent": c("like", B, s, sv("%b%")),
        "like_underscore": c("like", B, s, sv("a_b%")),
        "like_escape": c("like", B, s, sv("a!_%"), sv("!")),
        "substr_2_3": c("substr", V, s, n(2), n(3)),
        "substr_2": c("substr", V, s, n(2)),
        "substr_prefix": c("substr", V, s, n(1), n(1)),
        "lower": c("lower", V, s),
        "upper": c("upper", V, s),
        "trim": c("trim", V, s),
        "length": c("length", I, s),
        "concat": c("concat", V, sv("<"), s, sv(">")),
    }


JAX_EXPRS = _exprs(T, JI)
PORT_EXPRS = _exprs(PT, TI)


def _err(e) -> int:
    return 0 if e is None else int(e)


@pytest.mark.parametrize("name", list(JAX_EXPRS))
def test_expression_matches_reference(batch, name):
    jb, tb = batch
    jout, jerr = compile_projection([JAX_EXPRS[name]], ["x"], jb.schema,
                                    errors=True)(jb)
    tout, terr = TC.compile_projection([PORT_EXPRS[name]], ["x"], tb.schema,
                                       errors=True)(tb)
    assert tout.to_pylist() == jout.to_pylist()
    assert _err(terr) == _err(jerr)
    values = [r[0] for r in tout.to_pylist()]
    assert any(v is not None for v in values), name
    if name == "if_error_taken":
        assert _err(terr) != 0
    if name in ("if_error_untaken", "switch_numeric", "try"):
        assert _err(terr) == 0
