"""Parameters fall in each specification's ranges, one seed repeats them
exactly, set-up warms every covered value, and every client's sequence
keeps the traffic's mix."""
import collections
import itertools
import json
from decimal import Decimal

import pytest

from conftest import ROOT
from gpubench.harness import params, spec, traffic

SEEDS = (0, 7, 2_147_483_659, 18_446_744_073_709_551_629)
AGG = json.loads((ROOT / "gpubench" / "traffic" / "agg.json").read_text())


def _statements(seed, client=0, n=400):
    return list(itertools.islice(
        traffic.sequence("tpch", AGG, seed, client), n))


def _in_range(inst):
    p = inst.params
    if inst.template == "q1":
        assert 60 <= p["delta"] <= 120
    else:
        assert 1993 <= p["year"] <= 1997
        assert Decimal("0.02") <= Decimal(p["discount"]) <= Decimal("0.09")
        assert Decimal(p["discount"]) * 100 % 1 == 0
        assert p["quantity"] in (24, 25)


@pytest.mark.parametrize("seed", SEEDS)
def test_ranges(seed):
    for inst in traffic.warm("tpch", AGG, seed) + _statements(seed):
        _in_range(inst)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_repeats(seed):
    assert traffic.warm("tpch", AGG, seed) == traffic.warm("tpch", AGG, seed)
    a = _statements(seed)
    assert a == _statements(seed)
    assert a != _statements(seed + 1)
    assert a != _statements(seed, client=1)


@pytest.mark.parametrize("seed", SEEDS)
def test_warm_statements_cover_every_entry(seed):
    warm = traffic.warm("tpch", AGG, seed)
    assert collections.Counter(i.template for i in warm) == {"q1": 1,
                                                             "q6": 5}
    assert sorted(i.params["year"] for i in warm
                  if i.template == "q6") == list(range(1993, 1998))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_statements_draw_fresh_parameters(seed):
    """As a throughput test's streams do: each statement draws its own
    set, so over many statements every value of each range comes up."""
    sts = _statements(seed)
    q6 = [s.params for s in sts if s.template == "q6"]
    assert {p["year"] for p in q6} == set(range(1993, 1998))
    assert {p["quantity"] for p in q6} == {24, 25}
    assert len({p["delta"] for s in sts if s.template == "q1"
                for p in [s.params]}) > 40
    # 141 parameter sets in all: the first 40 statements repeat few
    assert len({s.key for s in sts[:40]}) >= 30


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sequences_keep_the_mix(seed):
    block = sum(AGG["templates"].values())
    for c in range(AGG["clients"]):
        seq = _statements(seed, c, block * 16)
        for i in range(0, len(seq), block):
            got = collections.Counter(s.template for s in seq[i:i + block])
            assert got == collections.Counter(AGG["templates"])


def test_cover_size():
    for name, want in (("q1", 1), ("q6", 5)):
        assert params.cover_size(spec.template("tpch", name)[1]) == want


def test_render_fills_every_placeholder():
    sql, _ = spec.template("tpch", "q6")
    out = params.render(sql, {"year": 1994, "discount": "0.06",
                              "quantity": 24})
    assert "date '1994-01-01'" in out and "0.06 - 0.01" in out
    assert "l_quantity < 24" in out and "{" not in out
