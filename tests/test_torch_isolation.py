"""presto_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports JAX, anything of presto_tpu, the reference's tools
or bench harness, or pyarrow (the card's machine has none; the port writes
its own ORC and Parquet files); and the runner never falls back to the CPU
on its own."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = sorted((ROOT / "presto_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "presto_tpu", "pyarrow", "tools", "bench")


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
    # the mesh slice: SPMD execution, the fragmenter, the flight
    # recorder, failpoints and the fair device scheduler
    assert {"distributed.py", "mesh.py", "fragmenter.py", "flight.py",
            "failpoints.py", "taskexec.py"} <= names
    # the serving and observability planes
    for rel in ("expr/params.py", "serving/__init__.py",
                "serving/plancache.py", "serving/template.py",
                "serving/resultcache.py", "serving/groups.py",
                "server/resource_groups.py", "_devtools/interleave.py",
                "obs/timeseries.py", "obs/slo.py", "obs/signals.py",
                "obs/exposition.py"):
        assert (ROOT / "presto_tpu_torch" / rel) in _SOURCES, rel
    # the front door and the coordinator fleet
    for rel in ("exec/discovery.py", "client.py", "server/protocol.py",
                "server/__init__.py", "dbapi.py", "cli.py", "plugin.py",
                "serving/fleet.py", "config.py", "server/security.py",
                "obs/profiler.py"):
        assert (ROOT / "presto_tpu_torch" / rel) in _SOURCES, rel
    # the cluster: plan codec, exchange spool, worker and coordinator
    for rel in ("exec/backoff.py", "planner/codec.py", "exec/spool.py",
                "server/worker.py", "exec/cluster.py",
                "_devtools/chaos.py"):
        assert (ROOT / "presto_tpu_torch" / rel) in _SOURCES, rel
    # the autoscaler: rules, providers, controller, and its devtools
    for rel in ("exec/autoscale.py", "_devtools/autoscale_watch.py",
                "_devtools/fleet.py"):
        assert (ROOT / "presto_tpu_torch" / rel) in _SOURCES, rel
    # the last reference tools: the device profile, the SLO and mesh
    # reports and the static-analysis plane
    for rel in ("_devtools/profile_query.py", "_devtools/slo_report.py",
                "_devtools/mesh_report.py", "_devtools/analyze/__init__.py",
                "_devtools/analyze/__main__.py", "_devtools/analyze/base.py",
                "_devtools/analyze/locks.py",
                "_devtools/analyze/registries.py",
                "_devtools/analyze/caches.py", "_devtools/analyze/tracing.py",
                "_devtools/analyze/metric_names.py"):
        assert (ROOT / "presto_tpu_torch" / rel) in _SOURCES, rel
    assert (ROOT / "presto_tpu_torch" / "_devtools" / "analyze"
            / "baseline.json").is_file()
    assert (ROOT / "presto_tpu_torch" / "parallel" / "mesh.py") \
        in _SOURCES
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


def test_front_door_without_device_needs_a_gpu(monkeypatch, tmp_path):
    """With no device named and no GPU, the statement server's default
    runner, a config-directory boot and the CLI's embedded server raise
    as LocalRunner does; each runs on the CPU only when asked."""
    from presto_tpu_torch import cli
    from presto_tpu_torch.config import server_from_etc
    from presto_tpu_torch.server import PrestoTpuServer
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "catalog" / "tpch.properties").write_text(
        "connector.name=tpch\ntpch.scale-factor=0.001\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrestoTpuServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_from_etc(str(etc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-e", "select 1"])
    srv, _ = server_from_etc(str(etc), device="cpu")
    try:
        assert srv.runner.device.type == "cpu"
    finally:
        srv.stop()
    assert cli.main(["--device", "cpu", "--sf", "0.001",
                     "-e", "select 1"]) == 0


def test_profiled_takes_its_device():
    """``profiled`` has no default device: a caller must say which
    clock times its work."""
    import inspect
    from presto_tpu_torch.obs import profiler
    params = inspect.signature(profiler.profiled).parameters
    assert params["device"].default is inspect.Parameter.empty
    assert params["on"].default is inspect.Parameter.empty


def test_cluster_without_device_needs_a_gpu(monkeypatch):
    """With no device named and no GPU, a worker, a cluster runner and
    the worker's command line raise as LocalRunner does; each runs on
    the CPU only when asked."""
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.server import worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.WorkerServer(tpch_sf=0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterRunner(["http://127.0.0.1:1"], tpch_sf=0.001,
                      heartbeat=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--tpch-sf", "0.001"])
    w = worker.WorkerServer(tpch_sf=0.001, device="cpu")
    w.start()
    try:
        assert w.device.type == "cpu"
    finally:
        w.stop()
    r = ClusterRunner(["http://127.0.0.1:1"], tpch_sf=0.001,
                      heartbeat=False, device="cpu")
    assert r.device.type == "cpu"


def test_autoscaler_without_device_needs_a_gpu(monkeypatch):
    """With no device named and no GPU, both providers, the load ramp and
    the fleet launcher raise as LocalRunner does; each runs on the CPU
    only when asked."""
    from presto_tpu_torch._devtools import chaos, fleet
    from presto_tpu_torch.exec.autoscale import (InProcessProvider,
                                                 LocalProcessProvider)
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    discovery = DiscoveryNodeManager()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InProcessProvider(discovery)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalProcessProvider(["http://127.0.0.1:1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_elastic_ramp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_fleet_chaos()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.launch_fleet()
    assert InProcessProvider(discovery, device="cpu").device.type == "cpu"
    assert LocalProcessProvider([], device="cpu").device.type == "cpu"


def test_profile_query_without_device_needs_a_gpu(monkeypatch):
    """With no device named and no GPU, the profile's runner raises as
    LocalRunner does; it runs on the CPU only when asked."""
    from presto_tpu_torch._devtools import profile_query
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_query.make_runner("tpch", 0.001, 1 << 12, None)
    assert profile_query.make_runner(
        "tpch", 0.001, 1 << 12, "cpu").device.type == "cpu"
