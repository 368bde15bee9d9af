"""LocalRunner: SQL text -> result rows in one process, on one device.

The counterpart of ``presto_tpu/exec/runner.py`` (reference
presto-main/.../testing/LocalQueryRunner.java:210): parse -> analyze and
plan -> optimize -> execute, with in-process connectors. Besides queries
it serves EXPLAIN [ANALYZE] (text; ANALYZE profiles the operators' device
time and appends the kernels and verdict sections), SET / RESET / SHOW
SESSION, and CREATE TABLE AS (with ``partitioned_by`` on the file
catalogs), INSERT INTO and DROP TABLE on the writable catalogs (memory,
ORC, Parquet), like the reference's DataDefinitionTask dispatch. It has
no system catalog, transactions, security, query log, history, serving
caches or events.

The runner works on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present it raises rather than carry on
quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from .. import types as T
from ..batch import Batch, Schema
from ..config import validate_session_property
from ..connectors.memory import MemoryConnector
from ..connectors.spi import CatalogManager
from ..connectors.tpcds import TpcdsConnector
from ..connectors.tpch import TpchConnector
from ..device import resolve_device
from ..planner.optimizer import optimize
from ..planner.planner import LogicalPlan, Session, _schema_exists, plan_query
from ..planner.printer import (
    format_cost_verdict, format_executables_summary,
    format_scan_cache_summary, format_skew_summary, print_plan,
)
from ..sql import ast as A
from ..sql.parser import parse_statement
from .local import QueryResult, _Executor, execute_plan, run_init_plans
from .stats import StatsCollector


def _ok() -> QueryResult:
    return QueryResult(["result"], [T.BOOLEAN], [(True,)])


class LocalRunner:
    def __init__(self, catalogs: Optional[CatalogManager] = None,
                 catalog: str = "tpch", schema: str = "default",
                 tpch_sf: float = 0.01, device=None,
                 rows_per_batch: int = 1 << 17):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector(sf=tpch_sf))
            catalogs.register("tpcds", TpcdsConnector(sf=tpch_sf))
            catalogs.register("memory", MemoryConnector())
        self.session = Session(catalogs=catalogs, catalog=catalog,
                               schema=schema)
        self.rows_per_batch = rows_per_batch
        #: the StatsCollector of the last statement (per-node walls and
        #: batches, split records, scan-cache hits, misses and stalls)
        self.last_stats: Optional[StatsCollector] = None

    def plan(self, sql: str, optimized: bool = True) -> LogicalPlan:
        stmt = parse_statement(sql)
        if not isinstance(stmt, A.Query):
            raise NotImplementedError(
                f"statement {type(stmt).__name__} is not ported")
        plan = plan_query(stmt, self.session)
        return optimize(plan, self.session) if optimized else plan

    # -- public API -----------------------------------------------------------
    def execute(self, sql: str,
                properties: Optional[Dict[str, object]] = None,
                cancel_event=None) -> QueryResult:
        """Run one statement. ``properties`` overlays per-query session
        properties without changing the runner's session (the reference
        builds a per-query Session the same way); a set ``cancel_event``
        stops a running query between batches."""
        stats = StatsCollector(count_rows=False)
        self.last_stats = stats
        return self._execute_stmt(parse_statement(sql), properties,
                                  cancel_event, stats)

    # -- statement dispatch ---------------------------------------------------
    def _execute_stmt(self, stmt: A.Node, properties, cancel_event,
                      stats: StatsCollector) -> QueryResult:
        session = self.session
        if properties:
            session = dataclasses.replace(
                session, properties={**session.properties, **properties})
        if isinstance(stmt, A.Query):
            plan = optimize(plan_query(stmt, session), session)
            try:
                return execute_plan(plan, session, self.device,
                                    self.rows_per_batch, stats=stats,
                                    cancel_event=cancel_event)
            finally:
                if session is not self.session:
                    # the executor stamped its memory stats on the overlay
                    self.session.last_memory_stats = \
                        session.last_memory_stats
        if isinstance(stmt, A.Explain):
            return self._explain(stmt, session, cancel_event)
        if isinstance(stmt, A.ShowSession):
            return QueryResult(
                ["Name", "Value"], [T.VARCHAR, T.VARCHAR],
                [(k, str(v)) for k, v in
                 sorted(self.session.properties.items())])
        if isinstance(stmt, A.SetSession):
            # checked against the declared registry (config.py): an
            # unknown or mistyped property fails the statement
            self.session.properties[stmt.name] = validate_session_property(
                stmt.name, _literal_value(stmt.value))
            return _ok()
        if isinstance(stmt, A.ResetSession):
            self.session.properties.pop(stmt.name, None)
            return _ok()
        if isinstance(stmt, A.CreateTableAsSelect):
            return self._ctas(stmt, session, cancel_event)
        if isinstance(stmt, A.InsertInto):
            return self._insert(stmt, session, cancel_event)
        if isinstance(stmt, A.DropTable):
            conn, table = self._writable(stmt.name)
            conn.drop_table(table, if_exists=stmt.if_exists)
            return _ok()
        raise NotImplementedError(
            f"statement {type(stmt).__name__} is not ported")

    def _explain(self, stmt: A.Explain, session: Session,
                 cancel_event) -> QueryResult:
        if not isinstance(stmt.statement, A.Query):
            raise ValueError("EXPLAIN requires a query")
        if stmt.type != "logical":
            raise NotImplementedError(
                f"EXPLAIN (TYPE {stmt.type.upper()}) is not ported")
        if stmt.format != "text":
            raise NotImplementedError(
                f"EXPLAIN (FORMAT {stmt.format.upper()}) is not ported")
        t0 = time.perf_counter()
        plan = optimize(plan_query(stmt.statement, session), session)
        stats = None
        if stmt.analyze:
            # run the query with per-operator stats, draining batches
            # without decoding rows (reference ExplainAnalyzeOperator.java)
            stats = StatsCollector(count_rows=True)
            self.last_stats = stats
            stats.planning_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            execute_plan(plan, session, self.device, self.rows_per_batch,
                         stats=stats, collect_rows=False,
                         cancel_event=cancel_event)
            stats.total_wall_s = time.perf_counter() - t1
        text = print_plan(plan, stats)
        if stats is not None:
            for section in (format_skew_summary(stats),
                            format_scan_cache_summary(stats, self.device),
                            format_executables_summary(stats),
                            format_cost_verdict(stats)):
                if section:
                    text += "\n" + section
        return QueryResult(["Query Plan"], [T.VARCHAR],
                           [(line,) for line in text.split("\n")])

    # -- write path (reference TableWriterOperator + finishInsert) ----------
    def _writable(self, name):
        catalog = self.session.catalog if len(name) < 3 else name[-3]
        if len(name) == 2 and self.session.catalogs.exists(name[0]) \
                and not _schema_exists(self.session, name[0]):
            # a two-part name whose qualifier names a mounted catalog (and
            # no schema of the session catalog shadows it): catalog.table,
            # resolved as the read path's planner.plan_table does
            catalog = name[0]
        conn = self.session.catalogs.get(catalog)
        if not hasattr(conn, "create_table"):
            raise ValueError(f"catalog {catalog!r} is not writable")
        return conn, name[-1]

    def _run_to_batches(self, query: A.Query, session: Session,
                        cancel_event):
        """The query's schema and output batches, drained and
        error-checked BEFORE the caller writes: a failing INSERT ...
        SELECT must not persist part of its rows (reference
        TableFinishOperator commits only on success)."""
        plan = optimize(plan_query(query, session), session)
        ex = _Executor(session, self.rows_per_batch, self.device)
        ex.cancel_event = cancel_event
        run_init_plans(ex, plan)
        root = plan.root
        schema = Schema([(f.name, f.type) for f in root.fields])
        out = list(ex.run(root.child))
        ex.check_errors()
        return schema, out

    def _ctas(self, stmt: A.CreateTableAsSelect, session: Session,
              cancel_event) -> QueryResult:
        conn, table = self._writable(stmt.name)
        props = dict(stmt.properties)
        part_by = props.pop("partitioned_by", ())
        if props:
            raise ValueError(
                f"unknown table properties: {sorted(props)}")
        schema, batches = self._run_to_batches(stmt.query, session,
                                               cancel_event)
        if table in conn.tables and stmt.if_not_exists:
            return QueryResult(["rows"], [T.BIGINT], [(0,)])
        if part_by:
            # the file catalogs route rows into key=value directories
            conn.create_table(table, schema,
                              if_not_exists=stmt.if_not_exists,
                              partitioned_by=list(part_by))
        else:
            conn.create_table(table, schema,
                              if_not_exists=stmt.if_not_exists)
        n = sum(conn.append(table, Batch(schema, b.columns, b.row_mask))
                for b in batches)
        return QueryResult(["rows"], [T.BIGINT], [(n,)])

    def _insert(self, stmt: A.InsertInto, session: Session,
                cancel_event) -> QueryResult:
        conn, table = self._writable(stmt.name)
        if stmt.columns:
            raise NotImplementedError(
                "INSERT INTO with a column list is not ported")
        schema, batches = self._run_to_batches(stmt.query, session,
                                               cancel_event)
        n = sum(conn.append(table, Batch(schema, b.columns, b.row_mask))
                for b in batches)
        return QueryResult(["rows"], [T.BIGINT], [(n,)])


def _literal_value(e: A.Expression):
    if isinstance(e, (A.StringLiteral, A.LongLiteral, A.DoubleLiteral,
                      A.DecimalLiteral, A.BooleanLiteral)):
        return e.value
    raise ValueError("session value must be a literal")
