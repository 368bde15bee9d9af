"""Shared base of the file-format directory connectors (ORC, Parquet).

The counterpart of ``presto_tpu/connectors/filebase.py``: the minimal
shape of the reference's Hive connector (reference
presto-hive/.../HiveMetadata.java, HivePageSourceProvider.java:58,85
dispatching each split to a format page source;
BackgroundHiveSplitLoader.java:262 listing partitions and files into
splits): schema = directory, table = subdirectory (or a single
``.<ext>`` file), one split per file, footer statistics drive pruning.

Hive-style partitioning: a table directory may contain nested
``key=value`` subdirectories; the keys become trailing table columns
whose constant values attach per split (as tensors on the page source's
device), and scan pushdown bounds prune whole partitions before any file
IO (reference HivePartitionManager.java partition pruning). A ``CREATE
TABLE ... WITH (partitioned_by = ARRAY['k'])`` write routes rows into
those directories (reference HiveMetadata.finishInsert + HivePageSink
partition routing).

Concrete connectors supply the extension, the reader factory and the
writer hook; readers are cached by (path, mtime), since planning asks
for schemas and statistics repeatedly. ``data_version`` combines a
counter bumped on the connector's own writes with the table's (file,
mtime) list, so the device scan cache (``exec/scancache.py``)
invalidates on a write, including one made behind the connector's back.
"""
from __future__ import annotations

import os
import shutil
import threading
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema
from ..device import resolve_device
from ..formats import decodestats
from .spi import (
    Connector, ConnectorMetadata, ConnectorSplitManager, PageSource, Split,
    TableHandle, TableStats, notify_data_change,
)


#: Hive's directory value for a NULL partition key
NULL_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def _parse_partition_value(raw: str):
    """Hive path convention: values are strings in the path; int-looking
    values are served as BIGINT (the common date_sk-style layout), and
    ``NULL_PARTITION`` is NULL, of no type of its own: ``(None, None)``."""
    if raw == NULL_PARTITION:
        return None, None
    try:
        return int(raw), T.BIGINT
    except ValueError:
        return raw, T.VARCHAR


class _EmptySource(PageSource):
    def batches(self):
        return iter(())


class _PartitionedSource(PageSource):
    """Wraps a file page source, appending constant partition columns on
    the batches' device and re-projecting to the requested column
    order."""

    def __init__(self, inner: PageSource, columns: Sequence[str],
                 part_fields, part_values):
        self.inner = inner
        self.columns = list(columns)
        self.part_fields = part_fields        # [(name, type)]
        self.part_values = part_values        # parallel python values

    def batches(self):
        for b in self.inner.batches():
            by_name = dict(zip(b.schema.names,
                               zip(b.columns, b.schema.types)))
            for (name, t), v in zip(self.part_fields, self.part_values):
                if v is None:
                    col = Column(t, torch.full((b.capacity,),
                                               t.null_storage(),
                                               dtype=t.storage_dtype,
                                               device=b.device),
                                 torch.zeros(b.capacity, dtype=torch.bool,
                                             device=b.device),
                                 ("",) if t.is_string else None)
                elif t.is_string:
                    col = Column(t, torch.zeros(b.capacity, dtype=torch.int32,
                                                device=b.device),
                                 b.row_mask, (str(v),))
                else:
                    col = Column(t, torch.full((b.capacity,),
                                               t.to_storage(v),
                                               dtype=t.storage_dtype,
                                               device=b.device),
                                 b.row_mask, None)
                by_name[name] = (col, t)
            cols = [by_name[c][0] for c in self.columns]
            fields = [(c, by_name[c][1]) for c in self.columns]
            yield Batch(Schema(fields), cols, b.row_mask)

    def close(self):
        self.inner.close()


class FileConnectorBase(Connector):
    """Directory-of-files connector parameterized by format."""

    #: file extension including the dot, e.g. ".orc"
    extension: str = ""

    def __init__(self, root: str):
        self.root = root
        self._metadata = _Metadata(self)
        self._splits = _SplitManager(self)
        self._readers: "OrderedDict[Tuple[str, float], object]" = \
            OrderedDict()
        # scan prefetch threads open readers concurrently
        self._readers_lock = threading.Lock()
        self._declared_parts: Dict[str, List[str]] = {}
        #: partition key types of the tables this connector created: the
        #: type of a key whose every directory is NULL_PARTITION
        self._declared_part_types: Dict[str, Dict[str, T.Type]] = {}
        #: per-table partition-field cache: page_source runs once per
        #: split and must not re-walk the directory tree per file
        self._pfields_cache: Dict[str, List[Tuple[str, T.Type]]] = {}
        # per-table data versions for the device scan cache: a counter
        # bumped on this connector's OWN writes, combined with the
        # table's (file, mtime) fingerprint so files rewritten behind
        # the connector's back change the version too
        self._vseq = 0
        self._versions: Dict[str, int] = {}

    def _data_changed(self, name: str) -> None:
        self._vseq += 1
        self._versions[name] = self._vseq
        notify_data_change(self, name)

    def data_version(self, table: str):
        try:
            files = tuple(
                (os.path.relpath(f, self.root), os.path.getmtime(f))
                for f in self.table_files(table))
        except (OSError, KeyError):
            files = ()
        return (self._versions.get(table, 0), files)

    # -- format hooks --------------------------------------------------------
    def open_reader(self, path: str):
        raise NotImplementedError

    def make_page_source(self, path: str, columns: Sequence[str],
                         pushdown, device: torch.device) -> PageSource:
        raise NotImplementedError

    def write_file(self, path: str, schema: Schema, batches) -> int:
        """Write one file of this connector's format; return row count."""
        raise NotImplementedError(
            f"catalog {self.name!r} is not writable")

    # -- shared machinery ----------------------------------------------------
    def reader(self, path: str):
        key = (path, os.path.getmtime(path))
        with self._readers_lock:
            r = self._readers.get(key)
            if r is not None:
                self._readers.move_to_end(key)
                return r
        r = self.open_reader(path)
        with self._readers_lock:
            self._readers[key] = r
            while len(self._readers) > 64:
                self._readers.popitem(last=False)
        return r

    # -- partition discovery -------------------------------------------------
    def partition_keys(self, table: str) -> List[str]:
        """Partition column names, from the first key=value dir chain."""
        path = os.path.join(self.root, table)
        keys: List[str] = []
        while os.path.isdir(path):
            sub = sorted(d for d in os.listdir(path)
                         if "=" in d
                         and os.path.isdir(os.path.join(path, d)))
            if not sub:
                break
            keys.append(sub[0].split("=", 1)[0])
            path = os.path.join(path, sub[0])
        return keys

    def partitioned_files(self, table: str) -> List[Tuple[str, Tuple]]:
        """[(file path, partition value strings)] under hive layout."""
        base = os.path.join(self.root, table)
        ext = self.extension
        if not os.path.isdir(base):
            if os.path.isfile(base + ext):
                return [(base + ext, ())]
            raise KeyError(f"unknown {self.name} table {table!r}")
        out: List[Tuple[str, Tuple]] = []

        def walk(path: str, values: Tuple) -> None:
            for e in sorted(os.listdir(path)):
                full = os.path.join(path, e)
                if os.path.isdir(full) and "=" in e:
                    walk(full, values + (e.split("=", 1)[1],))
                elif e.endswith(ext):
                    out.append((full, values))

        walk(base, ())
        if not out:
            raise KeyError(
                f"unknown {self.name} table {table!r} (empty dir)")
        return out

    def table_files(self, table: str) -> List[str]:
        return [f for f, _ in self.partitioned_files(table)]

    def _partition_fields(self, table: str) -> List[Tuple[str, T.Type]]:
        cached = self._pfields_cache.get(table)
        if cached is not None:
            return cached
        keys = self.partition_keys(table)
        out: List[Tuple[str, T.Type]] = []
        if keys:
            files = self.partitioned_files(table)
            declared = self._declared_part_types.get(table, {})
            for i, k in enumerate(keys):
                # the first non-NULL directory value types the key
                t = next((_parse_partition_value(values[i])[1]
                          for _, values in files
                          if len(values) > i
                          and values[i] != NULL_PARTITION), None)
                out.append((k, t or declared.get(k, T.VARCHAR)))
        self._pfields_cache[table] = out
        return out

    @property
    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    @property
    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source(self, split: Split, columns: Sequence[str],
                    pushdown=None, rows_per_batch: int = 1 << 17, *,
                    device=None) -> PageSource:
        """One file's batches on ``device`` (the GPU when none is named).
        A file keeps its own batching: one batch per ORC stripe or
        Parquet row group, whatever ``rows_per_batch`` asks."""
        device = resolve_device(device)
        path = split.info[0]
        part_values = split.info[1] if len(split.info) > 1 else ()
        pfields = self._partition_fields(split.table.table)
        pnames = [n for n, _ in pfields]
        if pushdown:
            # partition pruning BEFORE any file IO (reference
            # HivePartitionManager prunes partitions from the metastore
            # listing; dynamic-filter bounds land here too)
            for name, lo, hi in pushdown:
                if name not in pnames:
                    continue
                raw = part_values[pnames.index(name)]
                v, _t = _parse_partition_value(raw)
                if v is None and (lo is not None or hi is not None):
                    # a NULL key satisfies no range: p = 0 never reads
                    # the NULL partition
                    decodestats.PARTITIONS_PRUNED.inc()
                    return _EmptySource()
                if not isinstance(v, int):
                    continue
                if (lo is not None and v < lo) or \
                        (hi is not None and v > hi):
                    decodestats.PARTITIONS_PRUNED.inc()
                    return _EmptySource()
        file_cols = [c for c in columns if c not in pnames]
        file_pushdown = (tuple(p for p in pushdown if p[0] not in pnames)
                         if pushdown else None)
        inner = self.make_page_source(path, file_cols, file_pushdown,
                                      device)
        if not pnames:
            return inner
        sel = [(f, _parse_partition_value(v)[0])
               for f, v in zip(pfields, part_values) if f[0] in columns]
        return _PartitionedSource(inner, columns,
                                  [f for f, _ in sel], [v for _, v in sel])

    # -- write surface (reference HiveMetadata + HivePageSink) --------------
    @property
    def tables(self) -> Dict[str, None]:
        try:
            return {t: None for t in self._metadata.list_tables()}
        except FileNotFoundError:
            return {}

    def create_table(self, name: str, schema: Schema,
                     if_not_exists: bool = False,
                     partitioned_by: Sequence[str] = ()) -> None:
        path = os.path.join(self.root, name)
        if os.path.isdir(path) or os.path.isfile(path + self.extension):
            if if_not_exists:
                return
            raise ValueError(f"table {name!r} already exists")
        for k in partitioned_by:
            if k not in schema.names:
                raise ValueError(
                    f"partition column {k!r} not in table schema")
        os.makedirs(path)
        self._declared_parts[name] = list(partitioned_by)
        self._declared_part_types[name] = {
            k: schema.types[schema.names.index(k)] for k in partitioned_by}
        self._pfields_cache.pop(name, None)
        self._data_changed(name)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        path = os.path.join(self.root, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.isfile(path + self.extension):
            os.remove(path + self.extension)
        elif not if_exists:
            raise KeyError(f"table {name!r} does not exist")
        self._declared_parts.pop(name, None)
        self._declared_part_types.pop(name, None)
        self._pfields_cache.pop(name, None)
        self._data_changed(name)

    def append(self, name: str, batch: Batch) -> int:
        part_keys = self._declared_parts.get(name)
        if part_keys is None:
            part_keys = self.partition_keys(name)
        base = os.path.join(self.root, name)
        if not os.path.isdir(base):
            raise KeyError(f"table {name!r} does not exist")
        # unique per-write file id: sequence numbers from a fresh
        # process would silently clobber files written by an earlier one
        fid = uuid.uuid4().hex[:12]
        self._pfields_cache.pop(name, None)
        if not part_keys:
            path = os.path.join(base, f"part-{fid}{self.extension}")
            n = self.write_file(path, batch.schema, [batch])
            # bump AFTER the file lands: a concurrent scan between the
            # bump and the write would cache pre-write data under the
            # post-write version and serve it forever
            self._data_changed(name)
            return n
        # route rows into key=value directories (HivePageSink role);
        # partition columns move to the path, data columns to the files
        names = list(batch.schema.names)
        part_idx = [names.index(k) for k in part_keys]
        data_idx = [i for i in range(len(names)) if i not in part_idx]
        data_schema = Schema([(names[i], batch.schema.types[i])
                              for i in data_idx])
        mask = batch.row_mask.cpu().numpy()
        part_cols = []
        for i in part_idx:
            c = batch.columns[i]
            arr = c.data.cpu().numpy()
            if c.type.is_string:
                vocab = c.dictionary or ()
                arr = np.asarray(
                    [vocab[v] if 0 <= v < len(vocab) else ""
                     for v in arr.tolist()], dtype=object)
            # a NULL key is routed by its validity, never by the storage
            # value under it (Hive's default partition)
            part_cols.append((arr, ~c.validity.cpu().numpy()))
        n = 0
        live = np.nonzero(mask)[0]
        keys_here = {tuple(None if nulls[r] else arr[r]
                           for arr, nulls in part_cols) for r in live}
        for kv in sorted(keys_here, key=str):
            sel = mask.copy()
            for (arr, nulls), v in zip(part_cols, kv):
                sel &= nulls if v is None else (~nulls & (arr == v))
            sub = Batch(data_schema, [batch.columns[i] for i in data_idx],
                        batch.row_mask
                        & torch.from_numpy(sel).to(batch.device))
            d = base
            for k, v in zip(part_keys, kv):
                v = NULL_PARTITION if v is None else v
                d = os.path.join(d, f"{k}={v}")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"part-{fid}{self.extension}")
            n += self.write_file(path, data_schema, [sub])
        self._data_changed(name)   # after every partition file landed
        return n


class _Metadata(ConnectorMetadata):
    def __init__(self, conn: FileConnectorBase):
        self.conn = conn

    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        out = []
        ext = self.conn.extension
        for entry in sorted(os.listdir(self.conn.root)):
            full = os.path.join(self.conn.root, entry)
            if os.path.isdir(full):
                try:
                    if self.conn.table_files(entry):
                        out.append(entry)
                except KeyError:
                    continue
            elif entry.endswith(ext):
                out.append(entry[:-len(ext)])
        return out

    def table_schema(self, table: TableHandle) -> Schema:
        files = self.conn.table_files(table.table)
        file_schema = self.conn.reader(files[0]).schema
        pfields = self.conn._partition_fields(table.table)
        if not pfields:
            return file_schema
        return Schema(list(zip(file_schema.names, file_schema.types))
                      + pfields)

    def table_stats(self, table: TableHandle) -> TableStats:
        rows = 0.0
        for f in self.conn.table_files(table.table):
            rows += self.conn.reader(f).num_rows
        return TableStats(row_count=rows, columns={}, primary_key=())


class _SplitManager(ConnectorSplitManager):
    def __init__(self, conn: FileConnectorBase):
        self.conn = conn

    def splits(self, table: TableHandle, desired: int = 1) -> List[Split]:
        return [Split(table, (f, values))
                for f, values in self.conn.partitioned_files(table.table)]
