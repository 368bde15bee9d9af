"""The port's plan codec (presto_tpu_torch/planner/codec.py) against
presto_tpu's: every plan of the 22 TPC-H queries, TPC-DS q27 and the
queries of tests/tpcds_queries.py at SF 0.01 round-trips through JSON to
an equal plan, and its document equals the reference's encoding of the
same SQL, tag for tag, but for the type tags of the integer literals
the port types INTEGER (tests/torch_retyped.py). Init-plan values:
numpy scalars round-trip by value, long decimals as ``$dec``, and ARRAY
and MAP values raise the reference's error on the coordinator."""
import collections
import decimal
import json
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.planner import codec as jcodec
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.planner import codec

sys.path.insert(0, "tests")
from torch_retyped import RETYPED, lit_pairs, retype_doc  # noqa: E402
from test_torch_tpcds import Q27  # noqa: E402
from tpcds_queries import Q as TPCDS  # noqa: E402
from tpch_queries import Q as TPCH  # noqa: E402

SF = 0.01
CASES = ([("tpch", name, sql) for name, sql, *_ in TPCH]
         + [("tpcds", "q27", Q27)]
         + [("tpcds", name, sql) for name, sql, *_ in TPCDS])


@pytest.fixture(scope="module")
def runners():
    return {cat: (LocalRunner(catalog=cat, tpch_sf=SF, device="cpu"),
                  JRunner(catalog=cat, tpch_sf=SF))
            for cat in ("tpch", "tpcds")}


#: type tags the documents carry and the plan text does not print, since
#: a Project prints its output names and not its expressions: TPC-H
#: Q12's two CASE expressions and their literals (_aggarg0, _aggarg1),
#: Q22's substr(c_phone, 1, 2) and TPC-DS q79's substr(s_city, 1, 30)
DOC_ONLY = {
    ("tpch", "q12"): [("switch(...):bigint", "switch(...):integer")] * 2
    + lit_pairs(1, 0, 1, 0),
    ("tpch", "q22"): lit_pairs(1, 2),
    ("tpcds", "q79"): lit_pairs(1, 30),
}


@pytest.mark.parametrize("cat,name,sql", CASES,
                         ids=[f"{c}-{n}" for c, n, _ in CASES])
def test_plans_round_trip_and_equal_reference(runners, cat, name, sql):
    """The port's document equals the reference's tag for tag, once the
    reference's type tags are rewritten where the port types an integer
    literal INTEGER and the reference BIGINT: exactly the pairs that
    tests/torch_retyped.py lists for the query (with DOC_ONLY's), no more
    and no fewer. A query not listed there has the reference's document."""
    port, ref = runners[cat]
    plan, jplan = port.plan(sql), ref.plan(sql)
    made = collections.Counter()
    for root, jroot in zip([plan.root] + list(plan.init_plans),
                           [jplan.root] + list(jplan.init_plans)):
        doc = json.loads(json.dumps(codec.encode(root)))
        assert codec.decode(doc) == root
        jdoc = json.loads(json.dumps(jcodec.encode(jroot)))
        assert doc == retype_doc(jdoc, doc, made)
    assert len(plan.init_plans) == len(jplan.init_plans)
    assert made == collections.Counter(
        list(RETYPED[cat].get(name, ())) + DOC_ONLY.get((cat, name), []))


def test_documents_cross_decode():
    """A fragment the reference encodes decodes in the port to the
    port's own plan of the same SQL."""
    port, ref = LocalRunner(tpch_sf=SF, device="cpu"), JRunner(tpch_sf=SF)
    sql = next(s for n, s, *_ in TPCH if n == "q3")
    doc = json.loads(json.dumps(jcodec.encode(ref.plan(sql).root)))
    assert codec.decode(doc) == port.plan(sql).root


def _init_values(sql):
    from presto_tpu_torch.exec.local import _Executor, run_init_plans
    r = LocalRunner(tpch_sf=SF, device="cpu")
    ex = _Executor(r.session, 1 << 12, r.device)
    run_init_plans(ex, r.plan(sql))
    return ex.init_values


@pytest.mark.parametrize("value,plain", [
    (np.int64(7), 7), (np.int32(-3), -3), (np.float64(2.5), 2.5),
    (np.bool_(True), True), (decimal.Decimal("3753520037.50"),
                             decimal.Decimal("3753520037.50")),
    (None, None), ("AIR", "AIR"),
])
def test_init_values_round_trip(value, plain):
    doc = json.loads(json.dumps(codec.encode_values([value])))
    out = codec.decode(doc)
    assert out == (plain,) and type(out[0]) is type(plain)


def test_integer_and_decimal_subquery_values():
    """An integer scalar subquery's value is a numpy scalar (the
    reference's encode raises ``cannot encode int64`` on it); a long
    decimal sum's is a Decimal. Both ship and decode by value."""
    ints = _init_values("select r_name from region where r_regionkey < "
                        "(select max(n_regionkey) from nation)")
    assert isinstance(ints[0], np.integer)
    with pytest.raises(TypeError, match="cannot encode int64"):
        jcodec.encode(list(ints))
    assert codec.decode(json.loads(json.dumps(
        codec.encode_values(ints)))) == (4,)
    decs = _init_values("select (select sum(cast(o_totalprice as "
                        "decimal(30, 2))) from orders) from region")
    assert isinstance(decs[0], decimal.Decimal)
    doc = codec.encode_values(decs)
    assert doc == jcodec.encode(list(decs)) == [{"$dec": str(decs[0])}]
    assert codec.decode(doc) == tuple(decs)


@pytest.mark.parametrize("value,err", [
    ([np.int64(1), np.int64(2)], "cannot encode int64: np.int64(1)"),
    ({np.int64(1): np.int64(2)}, "cannot encode dict"),
    (np.arange(3), "cannot encode ndarray"),
])
def test_array_and_map_values_raise_reference_error(value, err):
    """ARRAY and MAP values (a list of numpy scalars, a dict) and arrays
    raise the reference's TypeError: none reaches a worker as text."""
    with pytest.raises(TypeError) as want:
        jcodec.encode([value])
    with pytest.raises(TypeError) as got:
        codec.encode_values([value])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(err)


def test_unregistered_class_and_bad_document_raise():
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Stray:
        x: int = 1
    with pytest.raises(TypeError, match="unregistered plan class Stray"):
        codec.encode(Stray())
    with pytest.raises(TypeError, match="cannot decode"):
        codec.decode(b"bytes")
    with pytest.raises(KeyError):
        codec.decode({"$": "NoSuchNode"})
