"""TPC-H q2, q16-q22 at SF 0.01 on the port's mesh of 2 and 8 CPU slots
against presto_tpu's LocalRunner and the port's single-device run (see
test_torch_mesh.py for the harness and the tolerance). q20 returns no
row at SF 0.01, so it also runs at SF 0.05 against the port's own
single-device run."""
import pytest

from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_rows_match
from test_torch_mesh import REL, SLOTS, TPCH, Parity, mesh_props

NAMES = ["q2", "q16", "q17", "q18", "q19", "q20", "q21", "q22"]


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


def test_q20_with_rows():
    r = TLocalRunner(tpch_sf=0.05, device="cpu", rows_per_batch=1 << 13)
    want = r.execute(TPCH["q20"], properties={"mesh_execution": "off"})
    got = r.execute(TPCH["q20"], properties=mesh_props(8))
    assert want.rows
    assert_rows_match(got.rows, want.rows, REL)
