"""ORC / Hive-style connector: a table is a directory of ORC files.

The counterpart of ``presto_tpu/connectors/orc.py`` (reference
presto-hive/.../HivePageSourceProvider.java:58,85 dispatches each split
to OrcPageSource.java:46; BackgroundHiveSplitLoader.java lists files
into splits) on the shared directory-connector base: one split per file,
stripe-by-stripe device decode through ``formats/orc.py`` on the page
source's device, min/max pushdown pruning files and stripes on footer
statistics (the role of TupleDomainOrcPredicate.java:77).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..formats.orc import OrcReader
from ..formats.orc_writer import write_orc
from .filebase import FileConnectorBase
from .spi import PageSource


class _OrcPageSource(PageSource):
    def __init__(self, conn: "OrcConnector", path: str,
                 columns: Sequence[str],
                 min_max: Optional[Dict[str, Tuple[int, int]]],
                 device: torch.device):
        self.conn = conn
        self.path = path
        self.columns = list(columns)
        self.min_max = min_max
        self.device = device

    def batches(self):
        yield from self.conn.reader(self.path).batches(
            self.columns, self.min_max, device=self.device)


class OrcConnector(FileConnectorBase):
    name = "orc"
    extension = ".orc"

    def open_reader(self, path: str) -> OrcReader:
        return OrcReader(path)

    def write_file(self, path: str, schema, batches) -> int:
        return write_orc(path, schema, batches)

    def make_page_source(self, path, columns, pushdown,
                         device) -> PageSource:
        # engine pushdown: ((column, lo, hi), ...) -> {column: (lo, hi)}
        min_max = ({name: (lo, hi) for name, lo, hi in pushdown}
                   if pushdown else None)
        return _OrcPageSource(self, path, columns, min_max, device)
