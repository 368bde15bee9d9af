"""Parameter rules that draw from lists (``choice``, ``sample``), their
checks at load, joint cover, every registry counter over the window, and
the agg cell's statements pinned for three seeds."""
import collections
import dataclasses
import hashlib
import itertools
import json
import random
import re

import pytest

from conftest import ROOT, SMALL, cell as load
from gpubench.harness import cell, params, spec, traffic

SEEDS = (7, 2_147_483_659, 18_446_744_073_709_551_629)
AGG = json.loads((ROOT / "gpubench" / "traffic" / "agg.json").read_text())

#: the states of the TPC-DS connector's 37 stores at SF10, one a store
#: in key order: q27's STATE_A-F are 6 distinct positions of this list
SF10_STORE_STATES = [
    "AL", "TN", "TN", "NC", "TN", "AL", "OH", "TN", "TN", "VA", "OH", "TN",
    "AL", "AL", "NC", "TN", "TN", "NC", "TN", "OH", "TN", "TN", "KY", "NC",
    "AL", "KY", "OH", "VA", "TN", "SC", "GA", "OH", "VA", "TN", "OH", "MO",
    "TX"]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
            "HOUSEHOLD"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

#: the rules and templates a TPC-DS q27 and TPC-H Q3 and Q12 cell would
#: add as data files (dsqgen query27.tpl; TPC-H 3.0.1 clauses 2.4.3.3,
#: 2.4.12.3)
RULES = {
    "q27": {"params": {
        "year": {"kind": "int", "lo": 1998, "hi": 2002},
        "gen": {"kind": "choice", "values": GENDERS},
        "ms": {"kind": "choice", "values": MARITAL},
        "es": {"kind": "choice", "values": EDUCATION},
        "states": {"kind": "sample", "values": SF10_STORE_STATES, "k": 6}}},
    "q3": {"params": {
        "segment": {"kind": "choice", "values": SEGMENTS},
        "day": {"kind": "int", "lo": 1, "hi": 31}}},
    "q12": {"params": {
        "shipmodes": {"kind": "sample", "values": SHIPMODES, "k": 2},
        "year": {"kind": "int", "lo": 1993, "hi": 1997}}},
}
TEMPLATES = {
    "q27": """select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = '{gen}' and cd_marital_status = '{ms}'
  and cd_education_status = '{es}' and d_year = {year}
  and s_state in ('{states[0]}', '{states[1]}', '{states[2]}',
                  '{states[3]}', '{states[4]}', '{states[5]}')
group by rollup (i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100""",
    "q3": """select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{segment}' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-{day:02d}'
  and l_shipdate > date '1995-03-{day:02d}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10""",
    "q12": """select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH' then 1 else 0 end),
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH' then 1 else 0 end)
from orders, lineitem
where o_orderkey = l_orderkey
  and l_shipmode in ('{shipmodes[0]}', '{shipmodes[1]}')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '{year}-01-01'
  and l_receiptdate < date '{year}-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode""",
}

#: sha256 of the agg cell's warm pool and of each client's first 100
#: statements (template, parameters, text), taken before the list kinds
#: came in: the parent and the change send the same statements
PINNED = {
    7: ["741d58361ed27373b4402c564721b6fb50a88a64debfb2904fefeb95982751dd",
        "74e757b9ada205020dd1eaa5d8b117759efc9e628ca08f18639f9ca72fe280e4",
        "8fb81fcaecc5847f21918be3f7b3c374ab711c45c44c782ccc6ead65d1a16383",
        "5bb1de5514b16c07de38eafedb652605404945055085de8e270a70adc2a1a8e2"],
    2_147_483_659: [
        "3cfeefcdd61bf980fb9db0e2c97dfd93473acb7fb4a24814b5a275bec7677cf1",
        "09899d8ca9cf3e58ef2b5de1d0ed3ffa0cbb3a0579bb15009fc467f0096fb11a",
        "8f5390d6d97379afb7bd9b0039aa436aca7f82344e506f254fa352e65bdcca7c",
        "a5f0f80dd9234c4741f1fb681f3387d777dcf61e38eae0d88524ee57184253ae"],
    18_446_744_073_709_551_629: [
        "fdf1fb2019494f5aa4b934a87fa5e7b4a26f5f520c5ac4bed7c104e17be2f4ed",
        "e9c78e748b8ac338cc1abd036812afbf09b6b0a763f4ec7dfd18789ca12183b6",
        "178aec4641d80e5436bd694394f395d124a98ef35f464e88883a05f46ca3247a",
        "e76ee71daef2aead44db99a5def5d6f7171228256152ee105cdb6041162a2cd6"],
}


def _digest(instances):
    text = repr([(i.template, sorted(i.params.items()), i.sql)
                 for i in instances])
    return hashlib.sha256(text.encode()).hexdigest()


def _draws(rule, seed, n=300):
    r = traffic.rng(seed, "rules")
    return [params.draw(rule, r) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_choice_and_sample_ranges_and_repeats(seed):
    rule = {"params": {
        "gen": {"kind": "choice", "values": GENDERS},
        "n": {"kind": "choice", "values": [3, 5, 8]},
        "states": {"kind": "sample", "values": SF10_STORE_STATES, "k": 6}}}
    params.check("t", rule)
    got = _draws(rule, seed)
    assert got == _draws(rule, seed)
    assert got != _draws(rule, seed + 1)
    assert {p["gen"] for p in got} == set(GENDERS)
    assert {p["n"] for p in got} == {3, 5, 8}
    for p in got:
        s = p["states"]
        assert isinstance(s, tuple) and len(s) == 6
        assert set(s) <= set(SF10_STORE_STATES)
        # distinct positions: no state more often than the list holds it
        assert all(s.count(v) <= SF10_STORE_STATES.count(v) for v in s)
    # positions repeat a member: TN (13 of 37 stores) comes twice or more
    assert any(p["states"].count("TN") >= 2 for p in got)
    # a sample of every position is a permutation of the list
    whole = {"params": {"s": {"kind": "sample", "values": SHIPMODES,
                              "k": len(SHIPMODES)}}}
    assert sorted(_draws(whole, seed, 5)[4]["s"]) == sorted(SHIPMODES)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_weighted_choice_follows_its_weights(seed):
    rule = {"params": {"m": {"kind": "choice", "values": ["a", "b", "c"],
                             "weights": [6, 1, 0]}}}
    params.check("t", rule)
    counts = collections.Counter(p["m"] for p in _draws(rule, seed, 7000))
    assert counts["c"] == 0
    assert 5 * counts["b"] < counts["a"] < 7 * counts["b"]


@pytest.mark.parametrize("name", sorted(RULES))
@pytest.mark.parametrize("seed", SEEDS)
def test_list_rules_of_q27_q3_q12_render(name, seed):
    rule, sql = RULES[name], TEMPLATES[name]
    params.check(name, rule)
    for p in _draws(rule, seed, 50):
        out = params.render(sql, p)
        assert "{" not in out and "}" not in out
        if name == "q27":
            assert f"cd_gender = '{p['gen']}'" in out
            assert f"cd_education_status = '{p['es']}'" in out
            assert p["ms"] in MARITAL and 1998 <= p["year"] <= 2002
            listed = re.search(r"s_state in \(([^)]*)\)", out).group(1)
            assert re.findall(r"'(\w\w)'", listed) == list(p["states"])
        elif name == "q3":
            assert f"c_mktsegment = '{p['segment']}'" in out
            day = f"date '1995-03-{p['day']:02d}'"
            assert out.count(day) == 2 and 1 <= p["day"] <= 31
        else:
            m1, m2 = p["shipmodes"]
            assert m1 != m2 and {m1, m2} <= set(SHIPMODES)
            assert f"l_shipmode in ('{m1}', '{m2}')" in out
            assert f"date '{p['year']}-01-01'" in out


@pytest.mark.parametrize("spec_, fault", [
    ({"kind": "float", "lo": 1, "hi": 2}, "unknown kind 'float'"),
    ({"lo": 1, "hi": 2}, "unknown kind None"),
    ({"kind": "choice", "values": []}, "'values' must be a list"),
    ({"kind": "choice", "values": "MF"}, "'values' must be a list"),
    ({"kind": "sample", "k": 1}, "'values' must be a list"),
    ({"kind": "choice", "values": ["M", "F"], "weights": [1]},
     "1 weights for 2 values"),
    ({"kind": "choice", "values": ["M", "F"], "weights": [1, -1]},
     "weights must be at least 0"),
    ({"kind": "choice", "values": ["M", "F"], "weights": [0, 0]},
     "weights must be at least 0"),
    ({"kind": "sample", "values": SHIPMODES, "k": 8},
     "k = 8 distinct positions of 7 values"),
    ({"kind": "sample", "values": SHIPMODES}, "k = None"),
    ({"kind": "sample", "values": SHIPMODES, "k": 2, "weights": [1] * 7},
     "no weights"),
    ({"kind": "sample", "values": SHIPMODES, "k": 2, "cover": True},
     "a sample cannot be covered"),
])
def test_malformed_rule_fails_at_load(monkeypatch, spec_, fault):
    """The check runs where the harness loads a template, before the
    warm pass or a client draws anything."""
    rule = {"params": {"year": {"kind": "int", "lo": 1993, "hi": 1997},
                       "bad_param": spec_}}
    real = spec.template

    def template(suite, name):
        sql, good = real(suite, name)
        return (sql, rule) if name == "q6" else (sql, good)
    monkeypatch.setattr(spec, "template", template)
    for load_ in (lambda: traffic.warm("tpch", AGG, 1),
                  lambda: next(traffic.sequence("tpch", AGG, 1, 0))):
        with pytest.raises(ValueError) as e:
            load_()
        msg = str(e.value)
        assert "template 'q6'" in msg and "parameter 'bad_param'" in msg
        assert fault in msg


@pytest.mark.parametrize("seed", SEEDS)
def test_joint_cover_warms_every_combination(seed):
    """q55's store_sales entry is keyed on its year, month and manager
    together (its dynamic filter bounds on the sold date and the item)."""
    rule = {"params": {
        "month": {"kind": "choice", "values": [11, 12], "cover": True},
        "year": {"kind": "int", "lo": 1998, "hi": 2002, "cover": True},
        "manager": {"kind": "int", "lo": 1, "hi": 100, "cover": True},
        "x": {"kind": "decimal", "lo": "0.1", "hi": "0.3", "step": "0.1"}}}
    params.check("q55", rule)
    size = params.cover_size(rule)
    assert size == 2 * 5 * 100
    pool = params.draw_pool(rule, traffic.rng(seed, "warm", "q55"), size)
    combos = collections.Counter((p["month"], p["year"], p["manager"])
                                 for p in pool)
    assert set(combos) == set(itertools.product((11, 12),
                                                range(1998, 2003),
                                                range(1, 101)))
    assert set(combos.values()) == {1}
    assert pool == params.draw_pool(rule, traffic.rng(seed, "warm", "q55"),
                                    size)
    # the order is drawn
    assert pool != params.draw_pool(
        rule, traffic.rng(seed + 1, "warm", "q55"), size)
    # twice the size: each combination twice
    twice = params.draw_pool(rule, random.Random(seed), 2 * size)
    assert set(collections.Counter(
        (p["month"], p["year"], p["manager"]) for p in twice).values()) == {2}


@pytest.mark.parametrize("seed", SEEDS)
def test_cover_on_a_choice_warms_every_member(seed):
    rule = {"params": {
        "segment": {"kind": "choice", "values": SEGMENTS + ["BUILDING"],
                    "cover": True},
        "day": {"kind": "int", "lo": 1, "hi": 31}}}
    assert params.cover_size(rule) == len(SEGMENTS)
    pool = params.draw_pool(rule, traffic.rng(seed, "warm", "q3"),
                            params.cover_size(rule))
    assert sorted(p["segment"] for p in pool) == sorted(SEGMENTS)


@pytest.mark.parametrize("seed", SEEDS)
def test_agg_statements_pinned(seed):
    """The warm pool (Q6's one covered year) and the first 100
    statements of each of the 3 clients are what they were."""
    got = [_digest(traffic.warm("tpch", AGG, seed))]
    got += [_digest(itertools.islice(traffic.sequence("tpch", AGG, seed, c),
                                     100))
            for c in range(AGG["clients"])]
    assert got == PINNED[seed]


def test_every_counter_over_the_window(monkeypatch):
    """A counter and a histogram that the program first names inside the
    window, and the scan cache's two counters under their old keys, reach
    the metric readers as deltas over the window."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    name = f"gpubench_window_probe_{id(monkeypatch)}_total"

    class Loop(cell.ClosedLoop):
        def start(self):
            REGISTRY.counter(name).inc(3)
            REGISTRY.histogram(name + "_seconds").observe(0.25)
            REGISTRY.histogram(name + "_seconds").observe(0.5)
            REGISTRY.counter("scan_cache_hit_total").inc(5)
            super().start()

    seen = []

    class Context(cell.Context):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append(self)

    monkeypatch.setattr(cell, "ClosedLoop", Loop)
    monkeypatch.setattr(cell, "Context", Context)
    c = load("tpch_sf10.agg")
    c = dataclasses.replace(c, traffic={**c.traffic, "clients": 1})
    import time
    res = cell.run_cell(c, 17, 0.5, False, "cpu", time.perf_counter(),
                        overrides=SMALL)
    assert res["correct"], res["checks"]
    (ctx,) = seen
    got = ctx.counters
    assert got[name] == 3
    assert got[name + "_seconds.count"] == 2
    assert got[name + "_seconds.sum"] == 0.75
    assert got["scan_cache_hits"] == got["scan_cache_hit_total"] >= 5
    assert got["scan_cache_misses"] == got["scan_cache_miss_total"]
    assert "slot_sum_index_add_total" in got
    assert "scheduler_wait_seconds.sum" in got
    assert all(v >= 0 for v in got.values())
    hits, misses = got["scan_cache_hits"], got["scan_cache_misses"]
    assert spec.metric_reader("scan_cache_hit_pct").read(ctx) == \
        100.0 * hits / (hits + misses)


@pytest.mark.parametrize("name", sorted(RULES))
def test_list_rules_render_statements_the_port_runs(name):
    from presto_tpu_torch.exec.runner import LocalRunner
    catalog = "tpcds" if name == "q27" else "tpch"
    runner = LocalRunner(catalog=catalog, tpch_sf=SMALL["scale_factor"],
                         device="cpu")
    for p in _draws(RULES[name], 11, 2):
        runner.execute(params.render(TEMPLATES[name], p))
