"""Every metric reader on a hand-made run: the numbers each should read,
and nothing where there is nothing to read."""
import pytest

from gpubench.harness import spec, trace
from gpubench.harness.cell import Context
from gpubench.harness.loop import Statement
from gpubench.harness.traffic import Instance

H100 = "NVIDIA H100 80GB HBM3"
S = 1_000_000_000


def _ctx(slice_=None, mem=3 * 2 ** 30):
    q1, q6 = Instance("q1", {}, ""), Instance("q6", {}, "")
    sts = [Statement(0, q1, 0.0, 2.0, []), Statement(1, q6, 0.5, 1.0, []),
           Statement(1, q6, 1.0, 6.0, []), Statement(0, q1, 2.0, 11.0, []),
           Statement(1, q6, 6.0, None, None, "boom")]
    return Context(10.0, 42.0, sts, {"scan_cache_hits": 9,
                                     "scan_cache_misses": 1},
                   mem, slice_, H100, 1000.0)


def _slice():
    recs = [("void at::native::reduce_kernel<512, 1>(...)", 7, 1001 * S,
             1001 * S + 10_000),
            ("Memcpy HtoD (Pageable -> Device)", 7, 1002 * S,
             1002 * S + 20_000),
            ("other", 7, 1003 * S, 1004 * S),
            ("index_add", 9, 1003 * S + S // 2, 1005 * S)]
    spans = [{"name": "plan", "start": 1001.0, "end": 1001.002,
              "attrs": {}},
             {"name": "plan", "start": 1002.0, "end": 1002.004,
              "attrs": {}}]
    return trace.Slice(1000.0, 1008.0, recs, 0, spans)


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_end_to_end_readers():
    ctx = _ctx()
    assert read("queries_per_s", ctx) == pytest.approx(0.3)
    # 5 statements: latencies 0.5, 2, 5, 9 and a failure; nearest rank 5
    assert read("latency_p90_ms", ctx) is None
    ctx.statements.pop()
    assert read("latency_p90_ms", ctx) == pytest.approx(9000.0)
    assert read("query_mem_gib", ctx) == 3.0
    assert read("query_mem_gib", _ctx(mem=None)) is None
    assert read("setup_s", ctx) == 42.0


def test_per_layer_readers():
    ctx = _ctx(_slice())
    assert read("scan_cache_hit_pct", ctx) == 90.0
    assert read("plan_ms", ctx) == pytest.approx(3.0)
    busy = 10_000 + 20_000 + 2 * S      # overlapping records counted once
    assert read("device_idle_pct", ctx) == \
        pytest.approx(100 * (1 - busy / (8 * S)))
    # statements done in the slice [0, 8] s of the window: 3
    assert read("device_ms_per_query", ctx) == pytest.approx(busy / 1e6 / 3)


def test_nothing_to_read():
    ctx = _ctx()
    for name in ("plan_ms", "device_idle_pct", "device_ms_per_query"):
        assert read(name, ctx) is None
    ctx.counters = {"scan_cache_hits": 0, "scan_cache_misses": 0}
    assert read("scan_cache_hit_pct", ctx) is None
