"""LocalRunner: SQL text -> result rows in one process, on one device.

The counterpart of ``presto_tpu/exec/runner.py`` (reference
presto-main/.../testing/LocalQueryRunner.java:210): parse -> analyze and
plan -> optimize -> execute, with in-process connectors. It runs queries
only: no system catalog, security, history, serving caches or events.

The runner works on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present it raises rather than carry on
quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional

from ..connectors.spi import CatalogManager
from ..connectors.tpch import TpchConnector
from ..device import resolve_device
from ..planner.optimizer import optimize
from ..planner.planner import LogicalPlan, Session, plan_query
from ..sql import ast as A
from ..sql.parser import parse_statement
from .local import QueryResult, execute_plan


class LocalRunner:
    def __init__(self, catalogs: Optional[CatalogManager] = None,
                 catalog: str = "tpch", schema: str = "default",
                 tpch_sf: float = 0.01, device=None,
                 rows_per_batch: int = 1 << 17):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector(sf=tpch_sf))
        self.session = Session(catalogs=catalogs, catalog=catalog,
                               schema=schema)
        self.rows_per_batch = rows_per_batch

    def plan(self, sql: str, optimized: bool = True) -> LogicalPlan:
        stmt = parse_statement(sql)
        if not isinstance(stmt, A.Query):
            raise NotImplementedError(
                f"statement {type(stmt).__name__} is not ported")
        plan = plan_query(stmt, self.session)
        return optimize(plan, self.session) if optimized else plan

    def execute(self, sql: str) -> QueryResult:
        """Run one query and return its rows."""
        return execute_plan(self.plan(sql), self.session, self.device,
                            self.rows_per_batch)
