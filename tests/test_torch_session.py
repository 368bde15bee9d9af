"""The port's session statements and property registry
(presto_tpu_torch/config.py, exec/runner.py): SET / RESET / SHOW SESSION
coerce and reject as presto_tpu does, per-query property overlays leave
the runner's session alone, every property the port reads is declared,
and a cancelled query stops."""
import ast
import pathlib
import threading

import pytest

from presto_tpu.config import validate_session_property as jvalidate
from presto_tpu_torch.config import (
    SESSION_PROPERTIES, SessionPropertyError, validate_session_property,
)
from presto_tpu_torch.errors import QueryCancelledError
from presto_tpu_torch.exec.runner import LocalRunner

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def runner():
    return LocalRunner(tpch_sf=0.01, device="cpu")


@pytest.mark.parametrize("name,value", [
    ("scan_cache", "false"), ("scan_cache", "ON"), ("scan_cache", True),
    ("scan_threads", "3"), ("scan_threads", 4),
    ("scan_prefetch_depth", " 2 "), ("probe_prefetch", "no"),
    ("broadcast_join_row_limit", 10),
])
def test_values_coerce_as_in_reference(name, value):
    assert validate_session_property(name, value) == \
        jvalidate(name, value)


@pytest.mark.parametrize("name,value", [
    ("scan_cache", "maybe"), ("scan_cache", 1), ("scan_threads", "two"),
    ("scan_threads", True), ("scan_threads", 2.5), ("no_such_prop", 1),
])
def test_bad_values_rejected_as_in_reference(name, value):
    with pytest.raises(ValueError):
        jvalidate(name, value)
    with pytest.raises(SessionPropertyError):
        validate_session_property(name, value)


def test_set_reset_show_session(runner):
    assert runner.execute("set session scan_threads = 3").rows == [(True,)]
    assert runner.execute("set session scan_cache = 'false'").rows
    assert runner.execute("show session").rows == [
        ("scan_cache", "False"), ("scan_threads", "3")]
    assert runner.session.properties == {"scan_cache": False,
                                         "scan_threads": 3}
    runner.execute("reset session scan_threads")
    assert runner.session.properties == {"scan_cache": False}
    with pytest.raises(SessionPropertyError, match="unknown session"):
        runner.execute("set session scan_cach = true")


def test_per_query_overlay_leaves_session_alone(runner):
    rows = runner.execute("select count(*) from nation",
                          properties={"scan_threads": 1,
                                      "scan_prefetch": False}).rows
    assert rows == [(25,)]
    assert runner.session.properties == {}
    # one thread asks for one split
    assert [s["split"] for s in runner.last_stats.splits] == [0]


def _read_properties():
    """Every property name the port's code reads through bool_property or
    session.properties.get."""
    names = set()
    for path in (ROOT / "presto_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            attr = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if attr == "bool_property" and len(node.args) >= 2:
                arg = node.args[1]
            elif attr == "get" and isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Attribute) and \
                    fn.value.attr == "properties" and node.args:
                arg = node.args[0]
            else:
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
    return names


def test_every_read_property_is_declared():
    read = _read_properties()
    assert {"scan_cache", "scan_threads", "probe_prefetch",
            "dense_grouping"} <= read
    assert read <= set(SESSION_PROPERTIES)


def test_cancel_event_stops_the_query(runner):
    ev = threading.Event()
    ev.set()
    with pytest.raises(QueryCancelledError):
        runner.execute("select count(*) from lineitem", cancel_event=ev)
    assert runner.execute("select count(*) from region").rows == [(5,)]


def test_spill_properties_set_by_session_run(runner):
    """SET SESSION of the spill properties reaches the query's pool: a
    budget this small spills the ORDER BY, and the rows are the
    reference's under the same properties."""
    from presto_tpu.exec.runner import LocalRunner as JRunner
    sql = "select c_custkey, c_name from customer order by c_name desc"
    for stmt in ("set session query_max_memory = 30000",
                 "set session spill_partitions = 4",
                 "set session spill_to_disk_bytes = 10000"):
        runner.execute(stmt)
    got = runner.execute(sql)
    stats = runner.session.last_memory_stats
    assert stats.spilled_bytes > 0 and stats.disk_spilled_bytes > 0
    assert stats.peak_bytes <= 30000
    want = JRunner(tpch_sf=0.01).execute(sql, properties={
        "query_max_memory": 30000, "spill_partitions": 4,
        "spill_to_disk_bytes": 10000})
    assert got.rows == [tuple(r) for r in want.rows]
