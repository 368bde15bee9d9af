"""TPC-H q8-q15 at SF 0.01 on the port's mesh of 2 and 8 CPU slots
against presto_tpu's LocalRunner and the port's single-device run (see
test_torch_mesh.py for the harness and the tolerance)."""
import pytest

from test_torch_mesh import SLOTS, TPCH, Parity

NAMES = ["q8", "q9", "q10", "q11", "q12", "q13", "q14", "q15"]


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")


@pytest.fixture(scope="module")
def parity():
    return Parity()


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("name", NAMES)
def test_tpch_on_the_mesh(parity, name, n):
    parity.check(TPCH[name], n)
