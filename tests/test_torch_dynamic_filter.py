"""Dynamic filtering over the port's ORC catalog: build-side key bounds
prune the probe scan's stripes at runtime (reference
sql/DynamicFilters.java), the three cases of tests/test_dynamic_filter.py
on presto_tpu_torch's OrcConnector, each statement held to presto_tpu's
answer over the same file."""
import re

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.orc as pa_orc  # noqa: E402

from presto_tpu.connectors.memory import MemoryConnector as JMemory  # noqa: E402
from presto_tpu.connectors.orc import OrcConnector as JOrcConnector  # noqa: E402
from presto_tpu.connectors.spi import CatalogManager as JCatalogs  # noqa: E402
from presto_tpu.exec.runner import LocalRunner as JRunner  # noqa: E402
from presto_tpu_torch.connectors.memory import MemoryConnector  # noqa: E402
from presto_tpu_torch.connectors.orc import OrcConnector  # noqa: E402
from presto_tpu_torch.connectors.spi import CatalogManager  # noqa: E402
from presto_tpu_torch.exec.runner import LocalRunner  # noqa: E402
from presto_tpu_torch.formats import decodestats  # noqa: E402

from torch_parity import assert_results_match  # noqa: E402

N = 400_000


KEYS = ("create table memory.default.keys as "
        "select cast(100 as bigint) k union all select 150 "
        "union all select 199")


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(presto_tpu's runner, the port's) over the same ORC file and
    memory table."""
    root = tmp_path_factory.mktemp("orcdf")
    (root / "seq").mkdir()
    pa_orc.write_table(
        pa.table({"k": pa.array(np.arange(N, dtype=np.int64)),
                  "v": pa.array(np.arange(N, dtype=np.int64) * 3)}),
        str(root / "seq" / "a.orc"),
        compression="uncompressed", stripe_size=256 * 1024)
    jc = JCatalogs()
    jc.register("hive", JOrcConnector(str(root)))
    jc.register("memory", JMemory())
    catalogs = CatalogManager()
    catalogs.register("hive", OrcConnector(str(root)))
    catalogs.register("memory", MemoryConnector())
    jr = JRunner(catalogs=jc, catalog="hive")
    r = LocalRunner(catalogs=catalogs, catalog="hive", device="cpu")
    jr.execute(KEYS)
    r.execute(KEYS)
    return jr, r


def _scan_rows(runner, sql: str, dynamic: bool) -> int:
    # scan_cache off: a warm cache would replay the full decoded scan
    # under the static-pushdown key instead of what the dynamic filter's
    # stripe pruning decodes
    ana = runner.execute(f"explain analyze {sql}",
                         properties={"scan_cache": False,
                                     "enable_dynamic_filtering": dynamic})
    text = "\n".join(row[0] for row in ana.rows)
    m = re.search(r"TableScan\[hive.*?(\d[\d,]*) rows", text)
    assert m, text
    return int(m.group(1).replace(",", ""))


JOIN = ("select count(*) c, sum(s.v) sv from seq s, "
        "memory.default.keys t where s.k = t.k")


@pytest.mark.parametrize("dynamic", [False, True])
def test_results_match_with_and_without(runners, dynamic):
    jr, r = runners
    props = {"enable_dynamic_filtering": dynamic}
    got = r.execute(JOIN, properties=props)
    assert_results_match(got, jr.execute(JOIN, properties=props))
    assert got.rows == [(3, (100 + 150 + 199) * 3)]


def test_probe_scan_pruned(runners):
    """The build side covers keys 100..199, so only the first stripe
    survives stats pruning: the probe scan reads far fewer rows, the
    same rows as presto_tpu's."""
    jr, r = runners
    pruned0 = decodestats.ORC_STRIPES_PRUNED.value
    pruned = _scan_rows(r, JOIN, True)
    assert decodestats.ORC_STRIPES_PRUNED.value > pruned0
    full = _scan_rows(r, JOIN, False)
    assert full == N
    assert pruned < full / 2, (pruned, full)
    assert (pruned, full) == (_scan_rows(jr, JOIN, True),
                              _scan_rows(jr, JOIN, False))


def test_shared_probe_subtree_not_pruned(runners):
    """A scan replayed for two consumers must not inherit one join's
    bounds; results stay correct."""
    jr, r = runners
    sql = ("select (select count(*) from seq), count(*) from seq s, "
           "memory.default.keys t where s.k = t.k")
    props = {"enable_dynamic_filtering": True}
    got = r.execute(sql, properties=props)
    assert_results_match(got, jr.execute(sql, properties=props))
    assert got.rows == [(N, 3)]
