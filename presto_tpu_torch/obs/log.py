"""Structured JSON-lines logging correlated by query and trace ids.

The counterpart of ``presto_tpu/obs/log.py`` (the role of the
reference's airlift log and QueryMonitor audit lines): one process-wide
logger (``LOG``) that writes one JSON object per line, stamping each
record with the ``query_id`` / ``trace_id`` of the active span
(``obs.trace``), so engine log lines join query traces.

Off by default and free while off (one attribute load per call site).
Enable with ``LOG.configure(path=...)`` (append), ``stream=...`` (e.g.
``sys.stderr``), or the ``PRESTO_TPU_TORCH_LOG`` environment variable
(``1`` / ``stderr`` or a file path).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import IO, Optional

from .trace import current_span_ids


class JsonLinesLogger:
    """Process-wide structured logger; one JSON object per line."""

    def __init__(self):
        self.enabled = False
        self._stream: Optional[IO] = None
        self._path: Optional[str] = None
        self._lock = threading.Lock()
        env = os.environ.get("PRESTO_TPU_TORCH_LOG", "").strip()
        if env and env.lower() not in ("0", "false", "off", "no"):
            if env.lower() in ("1", "true", "on", "yes", "stderr"):
                self.configure(stream=sys.stderr)
            else:
                self.configure(path=env)

    def configure(self, path: Optional[str] = None,
                  stream: Optional[IO] = None) -> None:
        with self._lock:
            self._path = path
            self._stream = stream
            self.enabled = bool(path or stream)

    def close(self) -> None:
        self.configure()

    def log(self, event: str, **fields) -> None:
        """Emit one record; never raises (logging must not break
        queries). Trace-context ids are defaults — explicit kwargs
        win."""
        if not self.enabled:
            return
        doc = {"ts": round(time.time(), 6), "event": event}
        for k, v in current_span_ids().items():
            doc.setdefault(k, v)
        doc.update({k: v for k, v in fields.items() if v is not None})
        try:
            line = json.dumps(doc, default=str)
            with self._lock:
                if self._stream is not None:
                    self._stream.write(line + "\n")
                    self._stream.flush()
                elif self._path is not None:
                    with open(self._path, "a") as f:
                        f.write(line + "\n")
        except Exception:
            pass


#: the process-wide structured logger
LOG = JsonLinesLogger()
