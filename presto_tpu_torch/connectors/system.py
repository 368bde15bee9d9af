"""System connector: engine state as queryable tables.

The counterpart of ``presto_tpu/connectors/system.py`` (reference
presto-main/.../connector/system/, the ``system.runtime`` tables, and
connector/informationschema/InformationSchemaMetadata.java): catalogs,
tables, columns, the query log, the task and node registries, the
metrics registry, the query history and the kernel registry are ordinary
tables served from live engine state, as device batches on the device
the scan names. The engine flattens schemas, so ``system.runtime.queries``
and ``system.default.queries`` are one table.

Tables, with the reference's columns:

- ``catalogs``, ``tables``, ``columns``: the mounted catalogs' metadata;
- ``queries``: the runner's query log (``QueryLogEntry``), the running
  statement included;
- ``tasks``: ``obs/metrics.TASKS`` (no rows outside a cluster);
- ``nodes``: ``obs/metrics.NODES``, or outside a cluster one row for the
  device this connector was made for: ``node_id`` is the torch device
  (``cuda:0``, ``cpu``), ``uri`` the device's name
  (``torch.cuda.get_device_name``; ``cpu`` for the CPU), and the HBM
  columns a live ``obs/profiler.sample_hbm`` of the card's caching
  allocator (0 on the CPU);
- ``metrics``: ``obs/metrics.REGISTRY``, histograms flattened to
  ``.count/.sum/.min/.max/.p50/.p95/.p99`` rows, with one
  ``sampled_at`` wall-clock read per scan;
- ``completed_queries`` and ``operator_stats``: ``obs/history.HISTORY``;
- ``executables``: ``obs/profiler.KERNELS``, the port's counterpart of
  the reference's jit-executable registry: one row per hand-written CUDA
  kernel. ``name`` is the kernel's wrapper, ``static_key`` its source
  under ``presto_tpu_torch/csrc``, ``compiles`` 1 once this process built
  it and ``compile_seconds`` the nvcc seconds, ``invocations`` its
  launches on the card (not the plain version's calls on CPU tensors),
  ``device_time_s`` its profiled seconds and ``bytes_accessed`` its
  bound-formula bytes per profiled call. ``flops``, ``arg_bytes``,
  ``output_bytes``, ``temp_bytes`` and ``generated_code_bytes`` come
  from XLA's cost and memory analysis in the reference and have no
  counterpart for a kernel built by nvcc: they are NULL.

``mesh_rounds`` holds the round timeline of the most recent mesh
queries (``obs/flight.FLIGHTS``, one row per flight round in
``flight.ROUND_COLUMNS`` order, the rows EXPLAIN ANALYZE's mesh section
prints). ``timeseries`` holds the derived series of the time-series
store (``obs/timeseries.TIMESERIES``: counter rates, histogram windowed
quantiles, gauge points), ``slo`` one row per declared resource-group
objective and ``alerts`` the SLO alert transitions (``obs/slo.SLO``),
``resource_groups`` every group of every live resource-group manager
joined with the fair scheduler's per-group share
(``serving/groups.group_snapshot``). ``metrics`` also carries the
store's windowed quantiles (``.p95_5m`` rows) once the sampler has two
points in the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from .. import types as T
from ..batch import Batch, Schema
from ..device import resolve_device
from .spi import (
    Connector, ConnectorMetadata, ConnectorSplitManager, PageSource,
    Split, TableHandle, TableStats,
)

V = T.VARCHAR

_SCHEMAS: Dict[str, List] = {
    "catalogs": [("catalog_name", V)],
    "tables": [("table_catalog", V), ("table_name", V)],
    "columns": [("table_catalog", V), ("table_name", V),
                ("column_name", V), ("ordinal", T.BIGINT),
                ("data_type", V)],
    "queries": [("query_id", V), ("state", V), ("query", V),
                ("elapsed_ms", T.DOUBLE), ("user", V), ("error", V),
                ("create_time", T.DOUBLE)],
    "tasks": [("task_id", V), ("query_id", V), ("stage_id", T.BIGINT),
              ("task_partition", T.BIGINT), ("node_id", V), ("state", V),
              ("elapsed_ms", T.DOUBLE), ("output_rows", T.BIGINT),
              ("output_bytes", T.BIGINT), ("straggler", T.BOOLEAN),
              ("skew_ratio", T.DOUBLE)],
    "metrics": [("name", V), ("kind", V), ("value", T.DOUBLE),
                ("sampled_at", T.DOUBLE)],
    "timeseries": [("name", V), ("kind", V), ("ts", T.DOUBLE),
                   ("value", T.DOUBLE)],
    "slo": [("group_path", V), ("objective", V), ("rule", V),
            ("target", T.DOUBLE), ("threshold_ms", T.DOUBLE),
            ("state", V), ("since", T.DOUBLE),
            ("burn_short", T.DOUBLE), ("burn_long", T.DOUBLE),
            ("budget_remaining", T.DOUBLE)],
    "alerts": [("ts", T.DOUBLE), ("group_path", V), ("objective", V),
               ("rule", V), ("from_state", V), ("to_state", V),
               ("burn_short", T.DOUBLE), ("burn_long", T.DOUBLE)],
    "nodes": [("node_id", V), ("state", V), ("coordinator", T.BOOLEAN),
              ("heartbeat_age_s", T.DOUBLE), ("active_tasks", T.BIGINT),
              ("mem_pool_peak_bytes", T.BIGINT),
              ("hbm_in_use_bytes", T.BIGINT),
              ("hbm_peak_bytes", T.BIGINT), ("uri", V)],
    "completed_queries": [
        ("query_id", V), ("state", V), ("user", V), ("query", V),
        ("error", V), ("error_code", V), ("create_time", T.DOUBLE),
        ("elapsed_ms", T.DOUBLE), ("cpu_ms", T.DOUBLE),
        ("device_sync_ms", T.DOUBLE), ("planning_ms", T.DOUBLE),
        ("peak_memory_bytes", T.BIGINT), ("rows", T.BIGINT),
        ("mode", V), ("plan_summary", V), ("retries", T.BIGINT),
        ("mesh_rounds", T.BIGINT), ("mesh_dominant_bucket", V),
        ("mesh_overhead_ms", T.DOUBLE), ("mesh_buckets", V)],
    "mesh_rounds": [
        ("query_id", V), ("round", T.BIGINT), ("stage", T.BIGINT),
        ("kind", V), ("bucket", V), ("t_start", T.DOUBLE),
        ("wall_s", T.DOUBLE), ("rows", T.BIGINT), ("bytes", T.BIGINT),
        ("loads", V), ("blocking", T.BOOLEAN), ("rounds", T.BIGINT)],
    "operator_stats": [
        ("query_id", V), ("operator", V), ("rows", T.BIGINT),
        ("batches", T.BIGINT), ("wall_ms", T.DOUBLE),
        ("bytes", T.BIGINT), ("device_time_s", T.DOUBLE),
        ("flops", T.DOUBLE), ("hbm_bytes", T.BIGINT)],
    "resource_groups": [
        ("group", V), ("state", V), ("running", T.BIGINT),
        ("queued", T.BIGINT), ("memory_reserved_bytes", T.BIGINT),
        ("soft_memory_limit_bytes", T.BIGINT),
        ("scheduling_weight", T.BIGINT),
        ("device_seconds", T.DOUBLE), ("device_share", T.DOUBLE),
        ("quanta", T.BIGINT)],
    "executables": [
        ("name", V), ("static_key", V), ("compiles", T.BIGINT),
        ("compile_seconds", T.DOUBLE), ("invocations", T.BIGINT),
        ("device_time_s", T.DOUBLE), ("flops", T.DOUBLE),
        ("bytes_accessed", T.DOUBLE), ("arg_bytes", T.BIGINT),
        ("output_bytes", T.BIGINT), ("temp_bytes", T.BIGINT),
        ("generated_code_bytes", T.BIGINT)],
}


@dataclasses.dataclass
class QueryLogEntry:
    query_id: str
    state: str
    query: str
    elapsed_ms: float
    user: str = ""
    error: Optional[str] = None
    create_time: float = 0.0


class _Metadata(ConnectorMetadata):
    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        return list(_SCHEMAS)

    def table_schema(self, table: TableHandle) -> Schema:
        if table.table not in _SCHEMAS:
            raise KeyError(f"unknown system table {table.table!r}")
        return Schema(_SCHEMAS[table.table])

    def table_stats(self, table: TableHandle) -> TableStats:
        return TableStats(row_count=100.0, columns={}, primary_key=())


class _SplitManager(ConnectorSplitManager):
    def splits(self, table: TableHandle, desired: int = 1) -> List[Split]:
        return [Split(table, ())]


class _RowsPageSource(PageSource):
    def __init__(self, schema: Schema, columns: Sequence[str],
                 rows: List[tuple], device: torch.device):
        self.schema = schema
        self.columns = list(columns)
        self.rows = rows
        self.device = device

    def batches(self) -> Iterator[Batch]:
        idx = [self.schema.names.index(c) for c in self.columns]
        if not idx:
            # count(*) prunes every column; the batch must still carry
            # the row count or the aggregate sees an empty table
            yield Batch.from_arrays(Schema([]), [], num_rows=len(self.rows),
                                    device=self.device)
            return
        yield Batch.from_pydict(
            {self.schema.names[i]: (self.schema.types[i],
                                    [r[i] for r in self.rows])
             for i in idx}, device=self.device)


def _node(device: torch.device):
    """(node id, name) of a local device: ``cuda:0`` and the card's name,
    or ``cpu`` twice."""
    if device.type != "cuda":
        return device.type, device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return f"cuda:{index}", torch.cuda.get_device_name(index)


class SystemConnector(Connector):
    """``device`` is the one node a process outside a cluster lists in
    ``nodes`` (the runner passes its own)."""

    name = "system"

    def __init__(self, catalogs, query_log: Optional[List] = None,
                 device=None):
        self.catalogs = catalogs        # CatalogManager (live reference)
        self.query_log: List[QueryLogEntry] = (
            query_log if query_log is not None else [])
        self.device = resolve_device(device)
        self._metadata = _Metadata()
        self._splits = _SplitManager()

    @property
    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    @property
    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def _rows(self, table: str) -> List[tuple]:
        return getattr(self, "_rows_" + table)()

    def _rows_catalogs(self) -> List[tuple]:
        return [(c,) for c in self.catalogs.names()]

    def _tables(self):
        for cat in self.catalogs.names():
            conn = self.catalogs.get(cat)
            try:
                tables = conn.metadata.list_tables()
            except Exception:   # a broken catalog must not hide the rest
                continue
            for t in tables:
                yield cat, conn, t

    def _rows_tables(self) -> List[tuple]:
        return [(cat, t) for cat, _, t in self._tables()]

    def _rows_columns(self) -> List[tuple]:
        out = []
        for cat, conn, t in self._tables():
            try:
                ts = conn.metadata.table_schema(
                    TableHandle(cat, "default", t))
            except Exception:
                continue
            out += [(cat, t, f.name, i + 1, f.type.display())
                    for i, f in enumerate(ts.fields)]
        return out

    def _rows_queries(self) -> List[tuple]:
        return [(q.query_id, q.state, q.query, q.elapsed_ms, q.user,
                 q.error, q.create_time) for q in list(self.query_log)]

    def _rows_tasks(self) -> List[tuple]:
        from ..obs.metrics import TASKS
        return [(t.get("task_id", ""), t.get("query_id", ""),
                 int(t.get("stage_id", 0)), int(t.get("partition", 0)),
                 t.get("node_id", ""), t.get("state", ""),
                 float(t.get("elapsed_ms", 0.0)),
                 int(t.get("output_rows", 0) or 0),
                 int(t.get("output_bytes", 0) or 0),
                 bool(t.get("straggler", False)),
                 float(t.get("skew_ratio", 0.0) or 0.0))
                for t in TASKS.snapshot()]

    def _rows_metrics(self) -> List[tuple]:
        from ..obs.metrics import REGISTRY
        from ..obs.timeseries import TIMESERIES
        sampled_at = time.time()   # ONE clock read per scan
        out = [(m["name"], m["kind"], float(m["value"]), sampled_at)
               for m in REGISTRY.snapshot()]
        # windowed quantiles next to the lifetime ``.p95`` rows:
        # ``.p95_5m`` means "over the last 5 minutes"
        out += [(name, "histogram", value, sampled_at)
                for name, value in TIMESERIES.window_quantile_rows(300.0)]
        return out

    def _rows_timeseries(self) -> List[tuple]:
        from ..obs.timeseries import TIMESERIES
        return TIMESERIES.rows()

    def _rows_slo(self) -> List[tuple]:
        from ..obs.slo import SLO
        return SLO.snapshot_rows()

    def _rows_alerts(self) -> List[tuple]:
        from ..obs.slo import SLO
        return SLO.alert_rows()

    def _rows_resource_groups(self) -> List[tuple]:
        from ..serving.groups import group_snapshot
        return [(g["group"], g["state"], int(g["running"]),
                 int(g["queued"]), int(g["memory_reserved_bytes"] or 0),
                 None if g["soft_memory_limit_bytes"] is None
                 else int(g["soft_memory_limit_bytes"]),
                 int(g["scheduling_weight"]), float(g["device_seconds"]),
                 float(g["device_share"]), int(g["quanta"]))
                for g in group_snapshot()]

    def _rows_nodes(self) -> List[tuple]:
        from ..obs.metrics import NODES
        rows = NODES.snapshot()
        if rows:
            return [(n.get("node_id", ""), n.get("state", ""),
                     bool(n.get("coordinator", False)),
                     float(n.get("heartbeat_age_s", 0.0)),
                     int(n.get("active_tasks", 0) or 0),
                     int(n.get("mem_pool_peak_bytes", 0) or 0),
                     int(n.get("hbm_in_use_bytes", 0) or 0),
                     int(n.get("hbm_peak_bytes", 0) or 0),
                     n.get("uri", ""))
                    for n in rows]
        # no cluster: the one local device, with a live allocator sample
        from ..obs.profiler import sample_hbm
        hbm = sample_hbm([self.device])
        h = hbm[0] if hbm else {}
        node_id, name = _node(self.device)
        return [(node_id, "active", True, 0.0, 0, 0,
                 int(h.get("bytes_in_use", 0)),
                 int(h.get("peak_bytes_in_use", 0)), name)]

    def _rows_mesh_rounds(self) -> List[tuple]:
        from ..obs.flight import FLIGHTS
        return FLIGHTS.rows()

    def _rows_completed_queries(self) -> List[tuple]:
        from ..obs.history import HISTORY
        return [(r.get("query_id", ""), r.get("state", ""),
                 r.get("user", ""), r.get("query", ""),
                 r.get("error"), r.get("error_code"),
                 float(r.get("create_time") or 0.0),
                 float(r.get("elapsed_ms") or 0.0),
                 float(r.get("cpu_ms") or 0.0),
                 float(r.get("device_sync_ms") or 0.0),
                 float(r.get("planning_ms") or 0.0),
                 int(r.get("peak_memory_bytes") or 0),
                 int(r.get("rows") or 0),
                 r.get("mode", ""), r.get("plan_summary", ""),
                 int(r.get("retries") or 0),
                 int(r.get("mesh_rounds") or 0),
                 r.get("mesh_dominant_bucket"),
                 float(r.get("mesh_overhead_ms") or 0.0),
                 r.get("mesh_buckets"))
                for r in HISTORY.snapshot()]

    def _rows_operator_stats(self) -> List[tuple]:
        from ..obs.history import HISTORY
        return [(r.get("query_id", ""), op.get("operator", ""),
                 int(op.get("rows") or 0), int(op.get("batches") or 0),
                 float(op.get("wall_ms") or 0.0),
                 int(op.get("bytes") or 0),
                 float(op.get("device_time_s") or 0.0),
                 float(op.get("flops") or 0.0),
                 int(op.get("hbm_bytes") or 0))
                for r in HISTORY.snapshot()
                for op in r.get("operators") or ()]

    def _rows_executables(self) -> List[tuple]:
        from ..obs.profiler import KERNELS
        return [(k["name"], k["source"], int(k["build_seconds"] > 0),
                 float(k["build_seconds"]), int(k["launches"]),
                 float(k["device_time_s"]), None,
                 None if k["bytes_per_call"] is None
                 else float(k["bytes_per_call"]),
                 None, None, None, None)
                for k in KERNELS.snapshot()]

    def page_source(self, split: Split, columns: Sequence[str],
                    pushdown=None, rows_per_batch: int = 1 << 17, *,
                    device=None) -> PageSource:
        table = split.table.table
        return _RowsPageSource(Schema(_SCHEMAS[table]), columns,
                               self._rows(table), resolve_device(device))
