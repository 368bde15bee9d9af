"""presto_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports JAX, anything of presto_tpu, or pyarrow (the card's
machine has none; the port writes its own ORC and Parquet files); and the
runner never falls back to the CPU on its own."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = sorted((ROOT / "presto_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "presto_tpu", "pyarrow")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in _SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sources_found():
    names = {p.name for p in _SOURCES}
    assert {"runner.py", "probe.py", "scan.py", "chip_smoke.py"} <= names
    # the scan-cache slice: its modules are held to the same rule
    assert {"scancache.py", "local_exchange.py", "stats.py", "memory.py",
            "metrics.py", "config.py", "printer.py"} <= names
    # the SQL-surface slice: long decimals, sketches, arrays
    assert {"int128.py", "sketch.py", "array_functions.py"} <= names
    # the file-format slice: ORC and Parquet, their connectors, the
    # profiler
    assert {"proto.py", "thrift_compact.py", "orc_meta.py", "orc_rle.py",
            "orc.py", "orc_writer.py", "parquet.py", "decodestats.py",
            "filebase.py", "profiler.py"} <= names
    # the fused-chain and spill slice
    assert {"fused.py", "spill.py", "pages.py", "exchange.py"} <= names
    # the statement, catalog and observability slice
    assert {"lockcheck.py", "security.py", "events.py", "transaction.py",
            "verifier.py", "trace.py", "log.py", "history.py", "system.py",
            "sqlite.py"} <= names
    assert (ROOT / "presto_tpu_torch" / "_devtools" / "lockcheck.py") \
        in _SOURCES
    assert (ROOT / "presto_tpu_torch" / "server" / "security.py") \
        in _SOURCES


def test_runner_without_device_needs_a_gpu(monkeypatch):
    from presto_tpu_torch.exec.runner import LocalRunner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner(tpch_sf=0.001)
    assert LocalRunner(tpch_sf=0.001, device="cpu").device.type == "cpu"


def test_sqlite_catalog_and_verifier_need_a_gpu(monkeypatch, tmp_path):
    """With no device named and no GPU, a SQLite catalog's scan and a
    verifier's card runner raise as LocalRunner does; nothing falls back
    to the CPU."""
    from presto_tpu_torch.connectors.spi import CatalogManager, TableHandle
    from presto_tpu_torch.connectors.sqlite import SqliteConnector
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.verifier import Verifier
    db = SqliteConnector(str(tmp_path / "t.db"))
    cpu = LocalRunner(tpch_sf=0.001, device="cpu")
    cat = CatalogManager()
    cat.register("sq", db)
    LocalRunner(catalogs=cat, catalog="sq", device="cpu").execute(
        "create table sq.default.t as select 1 a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    split = db.split_manager.splits(TableHandle("sq", "default", "t"))[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        db.page_source(split, ["a"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner(catalogs=cat, catalog="sq")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Verifier(cpu, LocalRunner(tpch_sf=0.001))
    assert db.page_source(split, ["a"], device="cpu") is not None
