"""TPC-DS on the port's mesh of 2 and 8 CPU slots at SF 0.01: q27 (the
five-way star join under ROLLUP) and battery queries with a window
(q98), grouping and top-n (q7, q43, q96), against
presto_tpu's LocalRunner and the port's single-device run (see
test_torch_mesh.py for the harness and the tolerance). Rows compare in
order, but for the battery's q73, which compares as a multiset: its
ORDER BY leaves ties (two customers named Gonzalez with one ticket
each), whose order the mesh does not fix."""
import pytest

from tpcds_queries import Q as DS
from test_torch_mesh import SLOTS, Parity
from test_torch_tpcds import Q27

QUERIES = {n: s for n, s, _ in DS}
QUERIES["q27"] = Q27
NAMES = ["q27", "q7", "q43", "q96", "q98"]


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")


@pytest.fixture(scope="module")
def parity():
    return Parity(catalog="tpcds")


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("name", NAMES)
def test_tpcds_on_the_mesh(parity, name, n):
    parity.check(QUERIES[name], n)


def test_tie_order_query_as_a_multiset(parity):
    parity.check(QUERIES["q73"], 8, ordered=False)
