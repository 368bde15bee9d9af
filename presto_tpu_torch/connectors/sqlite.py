"""SQLite connector: an external data store behind the SPI.

The counterpart of ``presto_tpu/connectors/sqlite.py`` (the role of the
reference's JDBC connector framework, presto-base-jdbc/.../JdbcClient.java,
JdbcMetadata.java's TupleDomain pushdown, JdbcRecordSetProvider.java):
metadata discovery from ``sqlite_master`` and ``pragma table_info``,
rowid-range splits, the planner's (column, lo, hi) bounds rendered as
conjuncts of SQLite's own ``WHERE`` so rows are filtered before they
leave SQLite, statistics for the optimizer (row count, per-column min,
max and distinct count, cached until this connector writes), and a write
surface for CREATE TABLE AS and INSERT.

Rows come out of SQLite on the host; each ``fetchmany`` chunk becomes
one device batch on the device the scan names (the GPU when none is
named). ``connector_factory`` mounts a catalog from an etc catalog file
(``connector.name=sqlite``, ``sqlite.path=/path/db.sqlite``; see
``config.load_catalogs``).
"""
from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

import torch

from .. import types as T
from ..batch import NUMPY_DTYPE, Batch, Schema
from ..device import resolve_device
from .spi import (
    ColumnStats, Connector, ConnectorMetadata, ConnectorSplitManager,
    PageSource, Split, TableHandle, TableStats, notify_data_change,
)

#: SQLite declared-type affinity -> engine type (reference
#: base-jdbc StandardColumnMappings.java role)
_AFFINITY = (
    (("INT",), T.BIGINT),
    (("CHAR", "CLOB", "TEXT"), T.VARCHAR),
    (("REAL", "FLOA", "DOUB"), T.DOUBLE),
    (("BOOL",), T.BOOLEAN),
    (("DATE",), T.DATE),
)


def _affinity_type(decl: str) -> T.Type:
    d = (decl or "").upper()
    for keys, typ in _AFFINITY:
        if any(k in d for k in keys):
            return typ
    # SQLite NUMERIC affinity / untyped: floats round-trip exactly
    return T.DOUBLE


def _q(ident: str) -> str:
    """Quote an identifier for foreign SQL, doubling embedded double
    quotes — identifiers can't be parameterized, so this is the one
    escaping path for table/column names in every statement this
    connector renders (page source, stats, DDL, insert)."""
    return '"' + str(ident).replace('"', '""') + '"'


class _Meta(ConnectorMetadata):
    def __init__(self, conn: "SqliteConnector"):
        self._conn = conn

    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        cur = self._conn._db().execute(
            "select name from sqlite_master where type in ('table','view')"
            " and name not like 'sqlite_%' order by name")
        return [r[0] for r in cur.fetchall()]

    def table_schema(self, table: TableHandle) -> Schema:
        return self._conn._schema(table.table)

    def table_stats(self, table: TableHandle) -> TableStats:
        return self._conn._stats(table.table)


class _Splits(ConnectorSplitManager):
    def __init__(self, conn: "SqliteConnector"):
        self._conn = conn

    def splits(self, table: TableHandle, desired: int = 1) -> List[Split]:
        """Rowid-range splits (the JDBC connector's analogue of
        partitioned reads; SQLite exposes a dense-ish integer rowid)."""
        db = self._conn._db()
        row = db.execute(
            f'select min(rowid), max(rowid) from {_q(table.table)}'
        ).fetchone()
        lo, hi = row if row and row[0] is not None else (None, None)
        if lo is None:
            return [Split(table, info=(None, None))]
        desired = max(1, desired)
        span = hi - lo + 1
        per = -(-span // desired)
        out = []
        for s in range(lo, hi + 1, per):
            out.append(Split(table, info=(s, min(s + per - 1, hi))))
        return out


class _SqlitePageSource(PageSource):
    def __init__(self, conn, table: str, columns: Sequence[str],
                 schema: Schema, rowid_lo, rowid_hi, pushdown,
                 rows_per_batch: int, device: torch.device):
        self._conn = conn
        self._device = device
        self._table = table
        self._columns = list(columns)
        self._schema = schema
        self._rows_per_batch = rows_per_batch
        sel = ", ".join(_q(c) for c in self._columns) or "1"
        where, params = [], []
        if rowid_lo is not None:
            where.append("rowid between ? and ?")
            params += [rowid_lo, rowid_hi]
        # TupleDomain-equivalent pushdown rendered as foreign-SQL
        # conjuncts: filtering happens INSIDE sqlite (reference
        # JdbcMetadata.applyFilter -> QueryBuilder WHERE clause). String
        # bounds arrive as dictionary codes — untranslatable, skipped
        # (the engine's own filter still applies; pushdown is advisory).
        for name, lo, hi in (pushdown or ()):
            if name not in self._columns \
                    or self._schema.type_of(name).is_string:
                continue
            if lo is not None:
                where.append(f'{_q(name)} >= ?')
                params.append(lo)
            if hi is not None:
                where.append(f'{_q(name)} <= ?')
                params.append(hi)
        sql = f'select {sel} from {_q(table)}'
        if where:
            sql += " where " + " and ".join(where)
        self._sql, self._params = sql, params

    def batches(self) -> Iterator[Batch]:
        cur = self._conn._db().execute(self._sql, self._params)
        types = [self._schema.type_of(c) for c in self._columns]
        while True:
            rows = cur.fetchmany(self._rows_per_batch)
            if not rows:
                return
            yield self._to_batch(rows, types)

    def _to_batch(self, rows, types) -> Batch:
        n = len(rows)
        arrays, valids, dicts = [], [], []
        for i, t in enumerate(types):
            col = [r[i] for r in rows]
            valids.append(np.asarray([v is not None for v in col],
                                     dtype=bool))
            if t.is_string:
                index: Dict[str, int] = {}
                codes = np.zeros(n, dtype=np.int32)
                for j, v in enumerate(col):
                    if v is not None:
                        codes[j] = index.setdefault(str(v), len(index))
                arrays.append(codes)
                dicts.append(tuple(index))
            else:
                vals = np.zeros(n, dtype=NUMPY_DTYPE[t.storage_dtype])
                for j, v in enumerate(col):
                    if v is not None:
                        vals[j] = v
                arrays.append(vals)
                dicts.append(None)
        schema = Schema([(c, t) for c, t in zip(self._columns, types)])
        return Batch.from_arrays(schema, arrays, validity=valids,
                                 dictionaries=dicts, num_rows=n,
                                 device=self._device)


class SqliteConnector(Connector):
    """One SQLite database file as a catalog."""

    def __init__(self, path: str):
        self.name = "sqlite"
        self.path = path
        self._local = threading.local()
        self._meta = _Meta(self)
        self._split_mgr = _Splits(self)
        self._schema_cache: Dict[str, Schema] = {}
        # TableStats cost a full scan (count(*) and per-column
        # min/max/distinct): cached per table, invalidated by this
        # connector's own writes, so planning does not rescan SQLite per
        # optimizer estimate
        self._stats_cache: Dict[str, TableStats] = {}
        # monotonic per-table data versions (scan-cache key surface),
        # bumped by the SAME writes that invalidate the stats cache
        self._vseq = 0
        self._versions: Dict[str, int] = {}

    def data_version(self, table: str):
        # the write counter covers THIS connector's writes; sqlite's
        # own PRAGMA data_version covers commits from OTHER connections
        # to the same database file (it bumps per foreign commit seen
        # by this connection), so externally-modified tables miss
        # instead of serving stale cached splits
        try:
            ext = self._db().execute("pragma data_version").fetchone()[0]
        except sqlite3.Error:
            ext = None
        return (self._versions.get(table, 0), ext)

    def _db(self) -> sqlite3.Connection:
        db = getattr(self._local, "db", None)
        if db is None:
            db = self._local.db = sqlite3.connect(self.path)
        return db

    @property
    def metadata(self) -> ConnectorMetadata:
        return self._meta

    @property
    def split_manager(self) -> ConnectorSplitManager:
        return self._split_mgr

    def _schema(self, table: str) -> Schema:
        got = self._schema_cache.get(table)
        if got is None:
            info = self._db().execute(
                f'pragma table_info({_q(table)})').fetchall()
            if not info:
                raise KeyError(f"sqlite table {table!r} not found")
            got = Schema([(r[1], _affinity_type(r[2])) for r in info])
            self._schema_cache[table] = got
        return got

    def _invalidate(self, table: str) -> None:
        self._schema_cache.pop(table, None)
        self._note_write(table)

    def _note_write(self, table: str) -> None:
        """One write happened: drop the priced stats, bump the data
        version, and notify engine-side caches (the device scan cache
        invalidates through this same path)."""
        self._stats_cache.pop(table, None)
        self._vseq += 1
        self._versions[table] = self._vseq
        notify_data_change(self, table)

    def _stats(self, table: str) -> TableStats:
        got = self._stats_cache.get(table)
        if got is not None:
            return got
        db = self._db()
        try:
            n = db.execute(
                f'select count(*) from {_q(table)}').fetchone()[0]
        except sqlite3.Error:
            return TableStats()
        cols: Dict[str, ColumnStats] = {}
        schema = self._schema(table)
        for f in schema.fields:
            if f.type.is_string:
                continue
            lo, hi, d = db.execute(
                f'select min({_q(f.name)}), max({_q(f.name)}),'
                f' count(distinct {_q(f.name)}) from {_q(table)}'
            ).fetchone()
            cols[f.name] = ColumnStats(distinct_count=float(d),
                                       min_value=lo, max_value=hi)
        got = TableStats(row_count=float(n), columns=cols)
        self._stats_cache[table] = got
        return got

    def page_source(self, split: Split, columns: Sequence[str],
                    pushdown=None, rows_per_batch: int = 1 << 17, *,
                    device=None) -> PageSource:
        """The split's rows as batches on ``device`` (the GPU when none
        is named)."""
        table = split.table.table
        lo, hi = split.info
        return _SqlitePageSource(self, table, columns,
                                 self._schema(table), lo, hi, pushdown,
                                 rows_per_batch, resolve_device(device))

    # -- write surface (CTAS / INSERT ... SELECT) ----------------------------
    @property
    def tables(self) -> List[str]:
        return self._meta.list_tables()

    def create_table(self, name: str, schema: Schema,
                     if_not_exists: bool = False) -> None:
        decl = {T.BIGINT: "INTEGER", T.INTEGER: "INTEGER",
                T.BOOLEAN: "BOOLEAN", T.DOUBLE: "REAL", T.DATE: "DATE"}
        cols = ", ".join(
            f'{_q(f.name)} '
            + ("TEXT" if f.type.is_string
               else decl.get(f.type, "REAL"))
            for f in schema.fields)
        ine = "if not exists " if if_not_exists else ""
        self._db().execute(f'create table {ine}{_q(name)} ({cols})')
        self._db().commit()
        self._invalidate(name)

    def append(self, name: str, batch: Batch) -> int:
        import datetime
        import decimal
        rows = batch.to_pylist()
        if not rows:
            return 0

        def conv(v):
            # DATE stores as epoch days (matches the read path's DATE
            # affinity -> int32 mapping); decimals as REAL; numpy scalars
            # unwrap (sqlite3 would otherwise BLOB them via the buffer
            # protocol)
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, datetime.date):
                return (v - datetime.date(1970, 1, 1)).days
            if isinstance(v, decimal.Decimal):
                return float(v)
            if isinstance(v, bool):
                return int(v)
            return v

        ph = ", ".join("?" for _ in batch.schema.fields)
        self._db().executemany(
            f'insert into {_q(name)} values ({ph})',
            [tuple(conv(v) for v in r) for r in rows])
        self._db().commit()
        self._note_write(name)
        return len(rows)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        if not if_exists and name not in self.tables:
            raise KeyError(f"sqlite table {name!r} not found")
        self._db().execute(f'drop table if exists {_q(name)}')
        self._db().commit()
        self._invalidate(name)


def connector_factory(props: Dict[str, str]) -> SqliteConnector:
    """Plugin entry (plugin.py ConnectorFactory contract): etc catalog
    properties -> connector instance."""
    path = props.get("sqlite.path") or props.get("path")
    if not path:
        raise ValueError("sqlite catalog needs sqlite.path=<db file>")
    return SqliteConnector(path)
