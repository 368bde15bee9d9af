"""The port's session-property table against presto_tpu's: the same
names, types and defaults, each value coerced and each bad value refused
as the reference does; and ``join_pallas_probe``, which the reference
reads to choose its probe implementation and which changes no row, is
accepted by the port's ``SET SESSION`` with Q3 at SF 0.01 then giving the
reference's rows (integers exactly, doubles within rel 1e-12)."""
import sys

import pytest

import torch_parity
from presto_tpu.config import SESSION_PROPERTIES as JPROPS
from presto_tpu.config import validate_session_property as jvalidate
from presto_tpu_torch.config import (
    SESSION_PROPERTIES, SessionPropertyError, validate_session_property,
)

sys.path.insert(0, "tests")
from tpch_queries import Q as TPCH  # noqa: E402

Q3 = next(sql for name, sql, *_ in TPCH if name == "q3")

#: the cluster's properties (exec/cluster.py, server/worker.py)
CLUSTER_PROPS = ("cluster_memory_limit", "exchange_failure_timeout_s",
                 "query_max_run_time", "query_retry_attempts",
                 "retry_policy", "speculative_execution",
                 "speculative_spool_reads", "spool_exchange",
                 "task_retry_attempts", "task_retry_backoff_s")


#: declared differently by design: the port's mesh_fused_exchange takes
#: ``auto`` (the counted plane where slots share a device; ROADMAP §3)
BY_DESIGN = {"mesh_fused_exchange": ("varchar", "auto")}


def test_table_equals_reference_name_for_name():
    assert sorted(SESSION_PROPERTIES) == sorted(JPROPS)
    for name in CLUSTER_PROPS + ("join_pallas_probe",):
        assert name in SESSION_PROPERTIES, name
    differ = {name: (sp.type, sp.default)
              for name, sp in SESSION_PROPERTIES.items()
              if (sp.type, sp.default) != (JPROPS[name].type,
                                           JPROPS[name].default)}
    assert differ == BY_DESIGN


@pytest.mark.parametrize("name,value", [
    ("retry_policy", "task"), ("retry_policy", "NONE"),
    ("query_max_run_time", "30s"), ("query_max_run_time", "500ms"),
    ("task_retry_attempts", "3"), ("task_retry_backoff_s", "0.2"),
    ("exchange_failure_timeout_s", 5), ("speculative_execution", "false"),
    ("speculative_spool_reads", "on"), ("spool_exchange", False),
    ("cluster_memory_limit", "1000000"), ("query_retry_attempts", 2),
    ("join_pallas_probe", "false"), ("join_pallas_probe", True),
])
def test_cluster_values_coerce_as_in_reference(name, value):
    assert validate_session_property(name, value) == \
        jvalidate(name, value)


@pytest.mark.parametrize("name,value", [
    ("retry_policy", "SOMETIMES"), ("query_max_run_time", "soon"),
    ("task_retry_attempts", "many"), ("spool_exchange", "perhaps"),
    ("join_pallas_probe", 3),
])
def test_bad_cluster_values_refused_as_in_reference(name, value):
    with pytest.raises(ValueError):
        jvalidate(name, value)
    with pytest.raises(SessionPropertyError):
        validate_session_property(name, value)


def test_set_session_accepts_every_reference_property():
    """``SET SESSION`` of each cluster property, then ``SHOW SESSION``,
    in both packages: the same rows."""
    from presto_tpu.exec.runner import LocalRunner as JRunner
    from presto_tpu_torch.exec.runner import LocalRunner
    sets = ["set session retry_policy = 'TASK'",
            "set session query_max_run_time = '30s'",
            "set session task_retry_attempts = 3",
            "set session spool_exchange = false",
            "set session join_pallas_probe = false"]
    shown = []
    for r in (LocalRunner(tpch_sf=0.01, device="cpu"),
              JRunner(tpch_sf=0.01)):
        for sql in sets:
            assert r.execute(sql).rows == [(True,)]
        shown.append(r.execute("show session").rows)
    assert shown[0] == shown[1]


def test_join_pallas_probe_off_keeps_q3_rows():
    from presto_tpu.exec.runner import LocalRunner as JRunner
    from presto_tpu_torch.exec.runner import LocalRunner
    got, want = [], []
    for r, out in ((LocalRunner(tpch_sf=0.01, device="cpu"), got),
                   (JRunner(tpch_sf=0.01), want)):
        r.execute("set session join_pallas_probe = false")
        out.append(r.execute(Q3))
        r.execute("reset session join_pallas_probe")
        out.append(r.execute(Q3))
    for g, w in zip(got, want):
        torch_parity.assert_results_match(g, w, rel=1e-12)
    assert got[0].rows == got[1].rows
