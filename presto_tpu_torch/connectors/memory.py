"""In-memory table connector.

The counterpart of ``presto_tpu/connectors/memory.py`` (reference
presto-memory/src/main/java/io/prestosql/plugin/memory/
MemoryConnectorFactory.java, MemoryMetadata.java, MemoryPagesStore.java):
CREATE TABLE AS and INSERT append device batches to a per-table store;
scans serve them back on the device the caller names. Every write bumps
the table's data version and notifies ``spi.notify_data_change``, which
invalidates the scan cache. Transactions are not ported.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

from ..batch import Batch, Column, Schema, map_parts
from ..device import resolve_device
from .spi import (
    Connector, ConnectorMetadata, ConnectorSplitManager, PageSource,
    Split, TableHandle, TableStats, notify_data_change,
)


class MemoryPageSource(PageSource):
    def __init__(self, batches: List[Batch], columns: Sequence[str],
                 device):
        self._batches = batches
        self._columns = list(columns)
        self._device = device

    def batches(self) -> Iterator[Batch]:
        for b in self._batches:
            idx = [b.schema.index_of(n) for n in self._columns]
            cols = [b.columns[i] for i in idx]
            yield Batch(b.schema.select(self._columns),
                        [Column(c.type, map_parts(
                            c.data, lambda a: a.to(self._device)),
                                c.validity.to(self._device), c.dictionary)
                         for c in cols],
                        b.row_mask.to(self._device))


class _Metadata(ConnectorMetadata):
    def __init__(self, store: "MemoryConnector"):
        self._store = store

    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        return sorted(self._store.tables)

    def table_schema(self, table: TableHandle) -> Schema:
        if table.table not in self._store.tables:
            raise KeyError(f"table {table.table!r} does not exist")
        return self._store.schemas[table.table]

    def table_stats(self, table: TableHandle) -> TableStats:
        rows = sum(b.host_count()
                   for b in self._store.tables.get(table.table, []))
        return TableStats(row_count=float(rows))


class _SplitManager(ConnectorSplitManager):
    def splits(self, table: TableHandle, desired: int = 1) -> List[Split]:
        return [Split(table, (0,))]


class MemoryConnector(Connector):
    """Writable catalog; one split per table (its batches are partitioned
    by however they were inserted)."""

    name = "memory"

    def __init__(self):
        self.tables: Dict[str, List[Batch]] = {}
        self.schemas: Dict[str, Schema] = {}
        self._metadata = _Metadata(self)
        self._split_manager = _SplitManager()
        # monotonic per-table data versions, the scan cache's key
        # (spi.Connector.data_version), bumped on every write
        self._vseq = 0
        self._versions: Dict[str, int] = {}

    def _data_changed(self, name: str) -> None:
        self._vseq += 1
        self._versions[name] = self._vseq
        notify_data_change(self, name)

    def data_version(self, table: str):
        return self._versions.get(table, 0)

    @property
    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    @property
    def split_manager(self) -> ConnectorSplitManager:
        return self._split_manager

    def page_source(self, split: Split, columns: Sequence[str],
                    pushdown=None, rows_per_batch: int = 1 << 17, *,
                    device=None) -> PageSource:
        """The stored batches of the split's table on ``device`` (the GPU
        when none is named). A snapshot: INSERT INTO t SELECT ... FROM t
        reads the contents from before the insert."""
        return MemoryPageSource(list(self.tables.get(split.table.table, [])),
                                columns, resolve_device(device))

    # -- write surface (reference spi/connector/ConnectorPageSink.java) ------
    def create_table(self, name: str, schema: Schema,
                     if_not_exists: bool = False) -> None:
        if name in self.tables:
            if if_not_exists:
                return
            raise ValueError(f"table {name!r} already exists")
        self.tables[name] = []
        self.schemas[name] = schema
        self._data_changed(name)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        if name not in self.tables:
            if if_exists:
                return
            raise KeyError(f"table {name!r} does not exist")
        del self.tables[name]
        del self.schemas[name]
        self._data_changed(name)

    def append(self, name: str, batch: Batch) -> int:
        if name not in self.tables:
            raise KeyError(f"table {name!r} does not exist")
        expected = self.schemas[name]
        if [t.display() for t in batch.schema.types] != \
                [t.display() for t in expected.types]:
            raise ValueError(
                f"insert schema mismatch for {name!r}: "
                f"{batch.schema!r} vs {expected!r}")
        # re-label the columns with the table's own names
        relabeled = Batch(expected, batch.columns, batch.row_mask)
        self.tables[name].append(relabeled)
        self._data_changed(name)
        return relabeled.host_count()
