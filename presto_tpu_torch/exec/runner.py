"""LocalRunner: SQL text -> result rows in one process, on one device.

The counterpart of ``presto_tpu/exec/runner.py`` (reference
presto-main/.../testing/LocalQueryRunner.java:210): parse -> analyze and
plan -> optimize -> execute, with in-process connectors, and the
reference's statement dispatch (its DataDefinitionTask role):

- queries, views (CREATE [OR REPLACE] VIEW, DROP VIEW) and prepared
  statements (PREPARE, EXECUTE ... USING, DEALLOCATE, DESCRIBE INPUT /
  OUTPUT);
- EXPLAIN as text, (FORMAT JSON), (FORMAT GRAPHVIZ), (TYPE IO) and
  (TYPE VALIDATE); EXPLAIN ANALYZE profiles the operators' device time
  and appends the trace (tracer on), kernels and verdict sections;
- SET / RESET / SHOW SESSION, SHOW CATALOGS / TABLES / COLUMNS;
- CREATE TABLE AS, INSERT INTO (with a column list naming every column
  of the table) and DROP TABLE on the writable catalogs, inside or
  outside START TRANSACTION ... COMMIT / ROLLBACK (``transaction.py``);
- roles, grants and catalog rules (``server/security.py``).

Every statement leaves a query-log entry (``system.runtime.queries``),
split and completion events (``events.py``) that feed the metrics
registry and the query history (``obs/history.py``), a structured log
line when ``obs/log.LOG`` is on, and a ``query`` span when
``obs/trace.TRACER`` is on. The serving caches of the reference (parsed
statements, compiled and template plans, results) are not ported: each
statement is parsed and planned anew.

The runner works on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present it raises rather than carry on
quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Dict, Optional

from .. import types as T
from .._devtools.lockcheck import checked_lock
from ..batch import Batch, Schema
from ..config import validate_session_property
from ..connectors.memory import MemoryConnector
from ..connectors.spi import CatalogManager, TableHandle
from ..connectors.system import QueryLogEntry, SystemConnector
from ..connectors.tpcds import TpcdsConnector
from ..connectors.tpch import TpchConnector
from ..device import resolve_device
from ..events import EventListenerManager, SplitCompletedEvent, \
    completed_event
from ..obs.history import attach_history
from ..obs.log import LOG
from ..obs.metrics import REGISTRY, attach_event_listeners
from ..obs.trace import TRACER
from ..planner.optimizer import optimize
from ..planner.plan import TableScanNode
from ..planner.planner import LogicalPlan, Session, _schema_exists, plan_query
from ..planner.printer import (
    format_cost_verdict, format_executables_summary,
    format_scan_cache_summary, format_skew_summary, format_trace_summary,
    plan_graphviz, plan_io, plan_json, print_plan,
)
from ..server.security import AccessControl, RoleManager, SecuredCatalogs
from ..sql import ast as A
from ..sql.ast import count_parameters, substitute_parameters
from ..sql.parser import parse_statement
from ..transaction import TransactionManager
from .local import QueryResult, _Executor, execute_plan, run_init_plans
from .stats import StatsCollector


#: query ids are unique in the process, not per runner: the history and
#: the metrics are process-wide, and two runners' "q_000001" would mix
#: their records in completed_queries and operator_stats
_QUERY_SEQ = itertools.count(1)


def _ok() -> QueryResult:
    return QueryResult(["result"], [T.BOOLEAN], [(True,)])


def _lines(text: str) -> QueryResult:
    return QueryResult(["Query Plan"], [T.VARCHAR],
                       [(line,) for line in text.split("\n")])


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
        if "system" not in catalogs.names():
            catalogs.register("system",
                              SystemConnector(catalogs, device=self.device))
        self.session = Session(catalogs=catalogs, catalog=catalog,
                               schema=schema)
        self.rows_per_batch = rows_per_batch
        self.transactions = TransactionManager()
        self.events = EventListenerManager()
        # query and split completion feed the process-wide metrics
        # registry (system.runtime.metrics) and leave one final record
        # per query in the history (system.runtime.completed_queries)
        attach_event_listeners(self.events)
        attach_history(self.events)
        self.access_control = AccessControl()    # allow-all until rules set
        self.roles = RoleManager()               # enforce=False by default
        self.query_log = catalogs.get("system").query_log
        #: query id -> live StatsCollector of the recent queries
        self.live_stats: Dict[str, StatsCollector] = {}
        #: the StatsCollector of the last statement (per-node walls and
        #: batches, split records, scan-cache hits, misses and stalls)
        self.last_stats: Optional[StatsCollector] = None
        self._state_lock = checked_lock("runner.state")

    def plan(self, sql: str, optimized: bool = True) -> LogicalPlan:
        stmt = parse_statement(sql)
        if not isinstance(stmt, A.Query):
            raise ValueError("plan() takes a SELECT query")
        plan = plan_query(stmt, self.session)
        return optimize(plan, self.session) if optimized else plan

    # -- public API -----------------------------------------------------------
    def execute(self, sql: str,
                properties: Optional[Dict[str, object]] = None,
                user: str = "", cancel_event=None) -> QueryResult:
        """Run one statement. ``properties`` overlays per-query session
        properties without changing the runner's session (the reference
        builds a per-query Session the same way); ``user`` scopes the
        access checks, the transaction and the query's events; a set
        ``cancel_event`` stops a running query between batches."""
        stmt = parse_statement(sql)
        with self._state_lock:
            qid = f"q_{next(_QUERY_SEQ):06d}"
            entry = QueryLogEntry(qid, "RUNNING", sql.strip(), 0.0,
                                  user=user, create_time=time.time())
            self.query_log.append(entry)
            stats = StatsCollector(count_rows=False)
            self.live_stats[qid] = stats
            if len(self.live_stats) > 200:
                running = {e.query_id for e in self.query_log
                           if e.state == "RUNNING"}
                for old in list(self.live_stats)[:-100]:
                    if old not in running:   # keep live queries visible
                        del self.live_stats[old]
        self.last_stats = stats
        t0 = time.perf_counter()
        c0 = time.process_time()
        error: Optional[str] = None
        error_code: Optional[str] = None
        rows_out: Optional[int] = None
        trace_id = None
        REGISTRY.counter("queries_started_total").inc()
        try:
            with TRACER.span("query", query_id=qid, user=user) as qspan:
                trace_id = getattr(qspan, "trace_id", None)
                out = self._execute_stmt(stmt, properties, user,
                                         cancel_event, stats)
            rows_out = len(out.rows)
            entry.state = "FINISHED"
            return out
        except Exception as e:
            entry.state = "FAILED"
            error = str(e)
            error_code = getattr(e, "name", type(e).__name__)
            raise
        finally:
            entry.elapsed_ms = (time.perf_counter() - t0) * 1e3
            entry.error = error
            with self._state_lock:
                if len(self.query_log) > 1000:
                    del self.query_log[:-500]
            self._feed_metrics(stats)
            for s in list(stats.splits):
                self.events.split_completed(SplitCompletedEvent(
                    qid, s["table"], s["split"], s["wallMs"],
                    s["batches"]))
            cpu_ms = (time.process_time() - c0) * 1e3
            self.events.query_completed(completed_event(
                qid, sql.strip(), user, entry.state, t0, error,
                history=self._history_record(
                    entry, stats, user, cpu_ms, rows_out, error_code,
                    trace_id)))
            if LOG.enabled:
                LOG.log("query_completed", query_id=qid,
                        state=entry.state, user=user,
                        elapsed_ms=round(entry.elapsed_ms, 3),
                        error=error)

    def _feed_metrics(self, stats: StatsCollector) -> None:
        """Fold one query's per-node stats into the process-wide registry
        (batches, seconds and, in analyze mode, rows per operator kind)."""
        for node, st in list(stats.by_node.items()):
            kind = type(node).__name__.replace("Node", "").lower()
            REGISTRY.counter(f"operator_batches_total.{kind}").inc(
                st.batches)
            REGISTRY.counter(f"operator_seconds_total.{kind}").inc(
                st.wall_s)
            if st.rows:
                REGISTRY.counter(f"operator_rows_total.{kind}").inc(
                    st.rows)

    def _history_record(self, entry: QueryLogEntry, stats: StatsCollector,
                        user: str, cpu_ms: float, rows_out: Optional[int],
                        error_code: Optional[str], trace_id) -> Dict:
        """The query's final record for the history: per-operator rows,
        batches and wall, and under ``profile`` the operators' device
        seconds and kernel bytes (``obs/history.py`` says what each device
        column holds); peak memory from the pool; with the tracer on, the
        plan and device-sync seconds of this query's spans."""
        by_kind: Dict[str, Dict[str, float]] = {}
        for node, st in list(stats.by_node.items()):
            agg = by_kind.setdefault(
                type(node).__name__.replace("Node", ""),
                {"rows": 0, "batches": 0, "wall_ms": 0.0,
                 "device_time_s": 0.0, "hbm_bytes": 0})
            agg["rows"] += st.rows
            agg["batches"] += st.batches
            agg["wall_ms"] += st.wall_s * 1e3
            dev = stats.device_for(node)
            if dev is not None:
                agg["device_time_s"] += dev["device_time_s"]
                agg["hbm_bytes"] += dev["bytes"]
        operators = [{"operator": k, "rows": int(v["rows"]),
                      "batches": int(v["batches"]),
                      "wall_ms": round(v["wall_ms"], 3),
                      "device_time_s": round(v["device_time_s"], 6),
                      "flops": 0.0, "hbm_bytes": int(v["hbm_bytes"])}
                     for k, v in by_kind.items()]
        pool_stats = self.session.last_memory_stats
        planning_ms = device_sync_ms = 0.0
        if TRACER.enabled and trace_id is not None:
            for s in TRACER.export(trace_id):
                dur = (float(s.get("end", 0.0))
                       - float(s.get("start", 0.0))) * 1e3
                if s.get("name") == "plan":
                    planning_ms += dur
                elif s.get("name") == "device-sync":
                    device_sync_ms += dur
        return {
            "query_id": entry.query_id, "query": entry.query,
            "user": user, "state": entry.state, "error": entry.error,
            "error_code": error_code, "create_time": entry.create_time,
            "elapsed_ms": round(entry.elapsed_ms, 3),
            "cpu_ms": round(cpu_ms, 3),
            "device_sync_ms": round(device_sync_ms, 3),
            "planning_ms": round(planning_ms, 3),
            "peak_memory_bytes": int(
                getattr(pool_stats, "peak_bytes", 0) or 0),
            "rows": rows_out, "mode": "local",
            "plan_summary": " -> ".join(by_kind),
            "operators": operators,
        }

    # -- statement dispatch ---------------------------------------------------
    def _execute_stmt(self, stmt: A.Node, properties, user: str,
                      cancel_event, stats: StatsCollector) -> QueryResult:
        session = self.session
        secured = bool(self.access_control.catalog_rules)
        if properties or secured:
            catalogs = session.catalogs
            if secured:
                catalogs = SecuredCatalogs(catalogs, user,
                                           self.access_control)
            session = dataclasses.replace(
                session, catalogs=catalogs,
                properties={**session.properties, **(properties or {})})
        if isinstance(stmt, A.Query):
            with TRACER.span("plan"):
                # planning resolves every catalog through SecuredCatalogs
                # when rules are set, so a denied catalog fails here
                plan = optimize(plan_query(stmt, session), session)
            if self.roles.enforce:
                self._check_select_privileges(plan, user)
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
        if isinstance(stmt, A.ShowCatalogs):
            return QueryResult(["Catalog"], [T.VARCHAR],
                               [(c,) for c in session.catalogs.names()])
        if isinstance(stmt, A.ShowTables):
            conn = session.catalogs.get(session.catalog)
            names = list(conn.metadata.list_tables())
            names += [v[2] for v in self.session.views
                      if v[0] == session.catalog
                      and v[1] == session.schema]
            return QueryResult(
                ["Table"], [T.VARCHAR], [(t,) for t in sorted(names)])
        if isinstance(stmt, A.ShowColumns):
            return self._show_columns(stmt.table, session)
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
        if isinstance(stmt, (A.CreateRole, A.DropRole, A.GrantRoles,
                             A.RevokeRoles, A.GrantPrivileges,
                             A.RevokePrivileges, A.SetRole, A.ShowRoles,
                             A.ShowGrants)):
            return self._security_stmt(stmt, user)
        if isinstance(stmt, A.StartTransaction):
            tx_id = self.transactions.begin(stmt.isolation,
                                            stmt.read_only, user=user)
            return QueryResult(["result"], [T.VARCHAR], [(tx_id,)])
        if isinstance(stmt, A.Commit):
            self.transactions.commit(user=user)
            return _ok()
        if isinstance(stmt, A.Rollback):
            self.transactions.rollback(user=user)
            return _ok()
        if isinstance(stmt, A.CreateTableAsSelect):
            return self._ctas(stmt, session, user, cancel_event)
        if isinstance(stmt, A.InsertInto):
            return self._insert(stmt, session, user, cancel_event)
        if isinstance(stmt, A.DropTable):
            _, conn, table = self._writable(stmt.name, user)
            conn.drop_table(table, if_exists=stmt.if_exists)
            return _ok()
        if isinstance(stmt, A.CreateView):
            return self._create_view(stmt, session)
        if isinstance(stmt, A.DropView):
            key = self._object_key(stmt.name)
            if key not in self.session.views:
                if stmt.if_exists:
                    return _ok()
                raise ValueError(f"view {'.'.join(key)} does not exist")
            del self.session.views[key]
            return _ok()
        if isinstance(stmt, A.Prepare):
            if isinstance(stmt.statement, (A.Prepare, A.ExecuteStmt,
                                           A.Deallocate)):
                raise ValueError(
                    "cannot prepare PREPARE/EXECUTE/DEALLOCATE statements")
            self.session.prepared[stmt.name] = stmt.statement
            return _ok()
        if isinstance(stmt, A.Deallocate):
            if self.session.prepared.pop(stmt.name, None) is None:
                raise ValueError(
                    f"prepared statement {stmt.name!r} not found")
            return _ok()
        if isinstance(stmt, A.ExecuteStmt):
            prepared = self._prepared(stmt.name)
            want = count_parameters(prepared)
            if len(stmt.args) != want:
                raise ValueError(
                    f"Incorrect number of parameters: expected {want} "
                    f"but found {len(stmt.args)}")
            bound = substitute_parameters(prepared, list(stmt.args))
            return self._execute_stmt(bound, properties, user,
                                      cancel_event, stats)
        if isinstance(stmt, A.DescribeOutput):
            prepared = self._prepared(stmt.name)
            if not isinstance(prepared, A.Query):
                return QueryResult(["Column Name", "Type"],
                                   [T.VARCHAR, T.VARCHAR], [])
            # bind NULL for the parameters: the output shape does not
            # depend on them
            bound = substitute_parameters(
                prepared, [A.NullLiteral()] * count_parameters(prepared))
            plan = optimize(plan_query(bound, session), session)
            return QueryResult(
                ["Column Name", "Type"], [T.VARCHAR, T.VARCHAR],
                [(f.name, f.type.display()) for f in plan.root.fields])
        if isinstance(stmt, A.DescribeInput):
            n = count_parameters(self._prepared(stmt.name))
            return QueryResult(["Position", "Type"], [T.BIGINT, T.VARCHAR],
                               [(i, "unknown") for i in range(n)])
        raise NotImplementedError(
            f"statement {type(stmt).__name__} is not supported yet")

    def _prepared(self, name: str) -> A.Node:
        prepared = self.session.prepared.get(name)
        if prepared is None:
            raise ValueError(f"prepared statement {name!r} not found")
        return prepared

    def _explain(self, stmt: A.Explain, session: Session,
                 cancel_event) -> QueryResult:
        if not isinstance(stmt.statement, A.Query):
            raise ValueError("EXPLAIN requires a query")
        if stmt.analyze and (stmt.type != "logical"
                             or stmt.format != "text"):
            raise ValueError(
                "EXPLAIN ANALYZE does not take TYPE/FORMAT options")
        t0 = time.perf_counter()
        plan = optimize(plan_query(stmt.statement, session), session)
        if stmt.type == "validate":
            return QueryResult(["Valid"], [T.BOOLEAN], [(True,)])
        if stmt.type == "io":
            return _lines(json.dumps(plan_io(plan), indent=2))
        if stmt.type == "distributed":
            raise NotImplementedError(
                "EXPLAIN (TYPE DISTRIBUTED) needs planner/fragmenter.py, "
                "which is not ported")
        if stmt.format == "json":
            return _lines(json.dumps(plan_json(plan), indent=2))
        if stmt.format == "graphviz":
            return _lines(plan_graphviz(plan))
        stats = None
        trace_spans = None
        if stmt.analyze:
            # run the query with per-operator stats, draining batches
            # without decoding rows (reference ExplainAnalyzeOperator.java)
            stats = StatsCollector(count_rows=True)
            self.last_stats = stats
            stats.planning_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            with TRACER.span("explain-analyze") as sp:
                execute_plan(plan, session, self.device, self.rows_per_batch,
                             stats=stats, collect_rows=False,
                             cancel_event=cancel_event)
            stats.total_wall_s = time.perf_counter() - t1
            tid = getattr(sp, "trace_id", None)
            if TRACER.enabled and tid is not None:
                trace_spans = TRACER.export(tid)
        text = print_plan(plan, stats)
        if trace_spans:
            text += "\n" + format_trace_summary(trace_spans)
        if stats is not None:
            for section in (format_skew_summary(stats),
                            format_scan_cache_summary(stats, self.device),
                            format_executables_summary(stats),
                            format_cost_verdict(stats)):
                if section:
                    text += "\n" + section
        return _lines(text)

    def _show_columns(self, name, session: Session) -> QueryResult:
        catalog, schema, table = self._object_key(name)
        view = self.session.views.get((catalog, schema, table))
        if view is not None:
            fields = plan_query(view, session).root.fields
        else:
            fields = session.catalogs.get(catalog).metadata.table_schema(
                TableHandle(catalog, schema, table)).fields
        return QueryResult(["Column", "Type"], [T.VARCHAR, T.VARCHAR],
                           [(f.name, f.type.display()) for f in fields])

    def _create_view(self, stmt: A.CreateView,
                     session: Session) -> QueryResult:
        key = self._object_key(stmt.name)
        if key in self.session.views and not stmt.or_replace:
            raise ValueError(f"view {'.'.join(key)} already exists")
        try:
            existing = session.catalogs.get(key[0]).metadata.list_tables()
        except Exception:   # an unknown catalog holds no table to shadow
            existing = ()
        if key[2] in existing:
            raise ValueError(
                f"table {'.'.join(key)} already exists (a view cannot "
                "shadow a table)")
        # plan now: a broken view fails CREATE, not a later SELECT
        plan_query(stmt.query, session)
        self.session.views[key] = stmt.query
        return _ok()

    # -- security (reference AccessControlManager grant paths) --------------
    def _security_stmt(self, stmt: A.Node, user: str) -> QueryResult:
        roles = self.roles
        if isinstance(stmt, A.CreateRole):
            roles.create_role(stmt.name, user)
        elif isinstance(stmt, A.DropRole):
            roles.drop_role(stmt.name, user)
        elif isinstance(stmt, A.GrantRoles):
            roles.grant_roles(stmt.roles, stmt.grantees, user)
        elif isinstance(stmt, A.RevokeRoles):
            roles.revoke_roles(stmt.roles, stmt.grantees, user)
        elif isinstance(stmt, A.GrantPrivileges):
            cat, _, tab = self._object_key(stmt.table)
            roles.grant_table(stmt.privileges, cat, tab, stmt.grantee, user)
        elif isinstance(stmt, A.RevokePrivileges):
            cat, _, tab = self._object_key(stmt.table)
            roles.revoke_table(stmt.privileges, cat, tab, stmt.grantee,
                               user)
        elif isinstance(stmt, A.SetRole):
            # session-scoped role selection; ALL / NONE are accepted (the
            # checks consult every granted role)
            self.session.properties["role"] = stmt.role
        elif isinstance(stmt, A.ShowRoles):
            return QueryResult(["Role"], [T.VARCHAR],
                               [(r,) for r in roles.list_roles()])
        else:   # ShowGrants
            tbl = None
            if stmt.table:
                cat, _, tab = self._object_key(stmt.table)
                tbl = (cat, tab)
            return QueryResult(
                ["Grantee", "Catalog", "Table", "Privilege"],
                [T.VARCHAR] * 4, roles.list_grants(tbl))
        return _ok()

    def _object_key(self, name) -> tuple:
        catalog = self.session.catalog if len(name) < 3 else name[-3]
        schema = self.session.schema if len(name) < 2 else name[-2]
        return (catalog, schema, name[-1])

    def _check_select_privileges(self, plan: LogicalPlan,
                                 user: str) -> None:
        """SQL-standard enforcement: every scanned table needs SELECT for
        the user, directly or through a role (reference
        AccessControlManager.checkCanSelectFromColumns)."""
        def walk(n):
            if isinstance(n, TableScanNode):
                self.roles.check_table_privilege(
                    user, n.catalog, n.table.table, "SELECT")
            for c in n.children:
                walk(c)
        for p in [plan.root] + list(plan.init_plans):
            walk(p)

    # -- write path (reference TableWriterOperator + finishInsert) ----------
    def _writable(self, name, user: str = ""):
        """(catalog, connector, table) of a write target, after the access
        checks; inside an explicit transaction the catalog is snapshotted
        before its first write, so ROLLBACK can restore it."""
        catalog = self.session.catalog if len(name) < 3 else name[-3]
        if len(name) == 2 and self.session.catalogs.exists(name[0]) \
                and not _schema_exists(self.session, name[0]):
            # a two-part name whose qualifier names a mounted catalog (and
            # no schema of the session catalog shadows it): catalog.table,
            # resolved as the read path's planner.plan_table does
            catalog = name[0]
        self.access_control.check_can_access_catalog(user, catalog)
        if self.roles.enforce:
            self.roles.check_table_privilege(user, catalog, name[-1],
                                             "INSERT")
        conn = self.session.catalogs.get(catalog)
        if not hasattr(conn, "create_table"):
            raise ValueError(f"catalog {catalog!r} is not writable")
        self.transactions.touch_for_write(catalog, conn, user=user)
        return catalog, conn, name[-1]

    def _run_to_batches(self, query: A.Query, session: Session,
                        cancel_event):
        """The query's schema and output batches, drained and
        error-checked BEFORE the caller writes: a failing INSERT ...
        SELECT must not persist part of its rows (reference
        TableFinishOperator commits only on success). The source query
        plans against the secured per-query session."""
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
              user: str, cancel_event) -> QueryResult:
        _, conn, table = self._writable(stmt.name, user)
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

    def _insert(self, stmt: A.InsertInto, session: Session, user: str,
                cancel_event) -> QueryResult:
        catalog, conn, table = self._writable(stmt.name, user)
        schema, batches = self._run_to_batches(stmt.query, session,
                                               cancel_event)
        order = None
        if stmt.columns:
            target = conn.metadata.table_schema(
                TableHandle(catalog, "default", table))
            order = _column_order(table, target, stmt.columns, schema)
            schema = Schema([(n, schema.types[i])
                             for n, i in zip(target.names, order)])
        n = 0
        for b in batches:
            cols = b.columns if order is None else [b.columns[i]
                                                    for i in order]
            n += conn.append(table, Batch(schema, cols, b.row_mask))
        return QueryResult(["rows"], [T.BIGINT], [(n,)])


def _column_order(table: str, target: Schema, columns, schema: Schema):
    """For INSERT INTO t (c1, ...) SELECT: the query column feeding each
    column of ``target``, in the table's order. The list must name every
    column of the table once, and the query must give one column per
    name; anything else is the schema mismatch the reference raises
    (filling the unnamed columns with NULL is not a feature of either
    package). The reference ignores the list and inserts by position,
    which stores a reordered list's values in the wrong columns."""
    names = [c.lower() for c in columns]
    if sorted(names) != sorted(target.names) or len(names) != len(schema):
        raise ValueError(
            f"insert schema mismatch for {table!r}: column list "
            f"{list(columns)} against {target!r}")
    return [names.index(n) for n in target.names]


def _literal_value(e: A.Expression):
    if isinstance(e, (A.StringLiteral, A.LongLiteral, A.DoubleLiteral,
                      A.DecimalLiteral, A.BooleanLiteral)):
        return e.value
    raise ValueError("session value must be a literal")
