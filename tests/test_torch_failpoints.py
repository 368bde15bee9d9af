"""The failpoint harness of presto_tpu_torch (exec/failpoints.py): the
registry tests of tests/test_failover.py and tests/test_chaos.py that
need no cluster, held to the same outcomes as presto_tpu's registry on
the same hit sequences, and the two sites on the port's path:
``scan.decode`` (an aborted decode never inserts a partial split into
the scan cache) and ``mesh.repartition`` (an armed error propagates out
of a mesh query, and the next run returns the rows)."""
import subprocess
import sys
import time

import pytest

from presto_tpu.exec import failpoints as jfp
from presto_tpu_torch.exec.failpoints import (
    FAILPOINTS, SITES, FailpointError, FailpointRegistry,
)
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY

SF = 0.01


@pytest.fixture(autouse=True)
def _clean():
    FAILPOINTS.clear()
    yield
    FAILPOINTS.clear()


def _counter(name):
    return REGISTRY.counter(name).value


def _fire_pattern(reg, site, n, key=""):
    out = []
    for _ in range(n):
        try:
            reg.hit(site, key=key)
            out.append(0)
        except Exception as e:          # each side's FailpointError
            assert type(e).__name__ == "FailpointError"
            out.append(1)
    return out


def test_sites_are_the_reference_sites():
    assert set(SITES) == set(jfp.SITES)


def test_failpoint_times_and_skip():
    fp = FailpointRegistry()
    fp.configure("a.b", times=2, skip=1, message="boom")
    fired = []
    for _ in range(5):
        try:
            fp.hit("a.b")
            fired.append(False)
        except FailpointError:
            fired.append(True)
    # hits 2 and 3 trigger: skip the first, then times=2, then disarmed
    assert fired == [False, True, True, False, False]
    assert fp.hits("a.b") == 5 and fp.triggers("a.b") == 2


def test_failpoint_unlimited_times():
    fp = FailpointRegistry()
    fp.configure("a.b", times=None)
    for _ in range(3):
        with pytest.raises(FailpointError):
            fp.hit("a.b")


def test_failpoint_match_targets_key():
    fp = FailpointRegistry()
    fp.configure("site", match=r"\.0\.0@", times=None)
    fp.hit("site", key="cq_1.0.1@worker-a")      # no match, no trigger
    with pytest.raises(FailpointError):
        fp.hit("site", key="cq_1.0.0@worker-a")
    # non-matching keys don't consume the hit counter
    assert fp.triggers("site") == 1 and fp.hits("site") == 1


def test_failpoint_probability_replayable_and_equal_to_reference():
    """Same seed + same hit sequence = the same trigger sequence, run to
    run and against presto_tpu's registry."""
    def run(reg_cls):
        fp = reg_cls()
        fp.configure("p", probability=0.3, seed=42, times=None)
        return _fire_pattern(fp, "p", 64)
    a, b = run(FailpointRegistry), run(FailpointRegistry)
    assert a == b and 0 < sum(a) < 64
    assert a == run(jfp.FailpointRegistry)


def test_failpoint_sleep_and_callback():
    fp = FailpointRegistry()
    fp.configure("s", action="sleep", sleep_s=0.05)
    t0 = time.monotonic()
    fp.hit("s")
    assert time.monotonic() - t0 >= 0.05
    seen = {}
    fp.configure("cb", action="callback",
                 callback=lambda key, **ctx: seen.update(key=key, **ctx))
    fp.hit("cb", key="k1", task_id="t9")
    assert seen == {"key": "k1", "task_id": "t9"}
    with pytest.raises(ValueError):
        fp.configure("cb2", action="callback")     # callback= required


SPEC = ("w.run=error:boom,times:2,skip:1;"
        "x.pull=sleep:0.01,prob:0.5,seed:7,match:a$;"
        "y.z=error,times:inf")


def test_failpoint_spec_grammar():
    fp = FailpointRegistry()
    fp.configure_from_spec(SPEC)
    fp.hit("w.run")                               # skipped
    with pytest.raises(FailpointError, match="boom"):
        fp.hit("w.run")
    for _ in range(3):                            # times:inf
        with pytest.raises(FailpointError):
            fp.hit("y.z")
    for bad in ("noequals", "a.b=callback", "a.b=explode",
                "a.b=error,frequency:2"):
        with pytest.raises(ValueError):
            FailpointRegistry().configure_from_spec(bad)


@pytest.mark.parametrize("site,key", [("w.run", ""), ("y.z", ""),
                                      ("x.pull", "ka"), ("x.pull", "kb")])
def test_spec_fires_as_the_reference(site, key):
    fp, jf = FailpointRegistry(), jfp.FailpointRegistry()
    fp.configure_from_spec(SPEC)
    jf.configure_from_spec(SPEC)
    assert _fire_pattern(fp, site, 6, key) == _fire_pattern(jf, site, 6, key)
    assert (fp.hits(site), fp.triggers(site)) == \
        (jf.hits(site), jf.triggers(site))


def test_chaos_spec_with_unknown_site_fails_fast():
    """A typo'd chaos spec raises at parse time: a config that injects
    nothing would pass every recovery scenario it was meant to test."""
    with pytest.raises(ValueError, match="unknown failpoint site"):
        FAILPOINTS.configure_from_spec("worker.task_ruin=error")


def test_environment_variable_arms_the_registry():
    code = ("from presto_tpu_torch.exec.failpoints import FAILPOINTS\n"
            "assert FAILPOINTS.active()\n"
            "try:\n"
            "    FAILPOINTS.hit('mesh.repartition')\n"
            "except Exception as e:\n"
            "    print(type(e).__name__, e)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PRESTO_TPU_TORCH_FAILPOINTS":
             "mesh.repartition=error:env-armed,times:1",
             "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == \
        "FailpointError failpoint mesh.repartition: env-armed"


def test_scancache_no_insert_on_aborted_scan():
    """A scan that dies mid-decode never puts a partial column set: the
    next clean run misses and decodes fresh."""
    from presto_tpu_torch.exec.scancache import CACHE
    CACHE.clear()
    lr = LocalRunner(tpch_sf=SF, device="cpu")
    lr.session.properties["scan_prefetch"] = False
    q = ("select l_returnflag, count(*) c from lineitem "
         "group by 1 order by 1")
    inserts0 = _counter("scan_cache_insert_total")
    FAILPOINTS.configure("scan.decode", message="chaos mid-decode",
                         match=r"\.lineitem\.")
    with pytest.raises(FailpointError, match="chaos mid-decode"):
        lr.execute(q)
    assert _counter("scan_cache_insert_total") == inserts0
    FAILPOINTS.clear()
    hits0 = _counter("scan_cache_hit_total")
    want = lr.execute(q, properties={"scan_cache": False}).rows
    assert _counter("scan_cache_hit_total") == hits0
    assert lr.execute(q).rows == want             # clean run: cold miss
    assert _counter("scan_cache_insert_total") > inserts0
    assert lr.execute(q).rows == want             # warm hit
    assert _counter("scan_cache_hit_total") > hits0
    CACHE.clear()


def test_mesh_repartition_error_propagates(monkeypatch):
    """An armed mesh.repartition error fails the mesh query (no
    fallback to the local path), and the next run returns the rows."""
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    lr = LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 12)
    q = ("select c_mktsegment, count(*), sum(o_totalprice) from customer "
         "join orders on c_custkey = o_custkey group by 1 order by 1")
    props = {"mesh_execution": "on", "broadcast_join_row_limit": 1}
    want = lr.execute(q, properties={"mesh_execution": "off"}).rows
    FAILPOINTS.configure_from_spec("mesh.repartition=error:boom,times:1")
    with pytest.raises(FailpointError, match="boom"):
        lr.execute(q, properties=props)
    assert FAILPOINTS.triggers("mesh.repartition") == 1
    got = lr.execute(q, properties=props).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        assert g[2] == pytest.approx(w[2], rel=1e-9)
