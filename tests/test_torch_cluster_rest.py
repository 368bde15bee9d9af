"""The TPC-H queries outside the reference's CLUSTER_TPCH list (the
companion of test_torch_cluster.py): presto_tpu_torch's ClusterRunner
against presto_tpu's, each over two in-process workers (the port's on
the CPU) at SF 0.01, gives the reference's cluster rows, integers
exactly and doubles within rel 1e-9. The reference's cluster runs all 22
TPC-H queries at this scale."""
import sys

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_cluster import Clusters

sys.path.insert(0, "tests")
from tpch_queries import Q as TPCH  # noqa: E402

SQL = {name: sql for name, sql, *_ in TPCH}
REST = ["q2", "q7", "q8", "q9", "q10", "q11", "q15", "q16", "q17", "q18",
        "q20", "q21", "q22"]


@pytest.fixture(scope="module")
def clusters():
    c = Clusters(0.01)
    yield c
    c.stop()


@pytest.mark.parametrize("name", REST)
def test_tpch_cluster_rest(clusters, name):
    clusters.check(SQL[name])


def test_every_tpch_query_is_covered():
    from test_torch_cluster import CLUSTER_TPCH
    assert sorted(CLUSTER_TPCH + REST) == sorted(SQL)
