"""Page-addressed exchange spool: durable shuffle storage.

The counterpart of ``presto_tpu/exec/spool.py`` (the role of the
reference's spooling exchange manager: fault-tolerant execution spools
every exchange page to storage every node can reach, so task retries
replay pages instead of re-running producers, and a drained worker's
output outlives its process). It is host code over host bytes: pages
are the wire format of ``exec/pages.py``, already copied off the device
by the producing task, and nothing here touches a tensor. Built on
``exec/spill.py``'s :class:`~presto_tpu_torch.exec.spill.SpillFile`:

- every output-buffer page is appended, **attempt-versioned** (the
  task id embeds the attempt suffix) and **token-addressed**, to a
  per-query directory of page logs, one
  ``<query>/<task_id>.b<buffer>.pages`` file per output buffer;
- each frame is **checksummed** (crc32) at write time and verified at
  read time: a corrupted page surfaces as :class:`SpoolCorruptionError`,
  which the exchange layer turns into an upstream-task failure, so the
  retry layer re-runs the producer instead of serving garbage;
- a ``<task_id>.done`` marker (the final token count per buffer)
  commits the attempt: readers treat a task without one as incomplete
  and fall back to normal retry semantics;
- disk usage is **accounted** against ``spool.max-bytes`` (writes past
  it raise :class:`SpoolFullError`) and **collected per query** at query
  end and abort (``release_query``), so the chaos scenarios can assert
  that no per-query directory is left behind.

Frame layout (append-only; readers ignore a partial trailing frame, so a
writer killed mid-append never corrupts earlier pages), the JAX
package's byte for byte, so either package reads the other's logs::

    [u32 token][u32 length][u32 crc32(payload)][payload bytes]

The store interface is pluggable (:class:`SpoolStore`) with two
backends. :class:`LocalDiskSpoolStore` keeps append-only page logs on a
local filesystem, which is shared storage whenever ``spool.dir`` points
every node at one filesystem (the in-process test clusters and
single-host multi-worker deployments). :class:`ObjectSpoolStore`
emulates a GCS/S3-style bucket: whole objects, content-addressed
(sha-256 digests; identical pages, as a broadcast exchange writes, are
stored once and reference-counted), committed by a manifest, with a
configured latency and bandwidth model on every put and get. The
process-wide instance is :data:`SPOOL` (a :class:`SwitchableSpoolStore`
over both backends), configured through ``spool.dir`` /
``spool.max-bytes`` / ``spool.backend`` / ``spool.object.*`` in
``etc/config.properties`` (``config.configure_spool``).

Failpoint sites (``exec/failpoints.py``): ``spool.write`` fails an
append (the producing task fails and retries); ``spool.read`` fails a
page read (the consumer treats the spool copy as lost); ``spool.corrupt``,
armed with the ``error`` action, makes the write path flip one payload
byte while recording the original checksum, planting a stored
corruption for the read path to detect; ``spool.object_put`` /
``spool.object_get`` fail one emulated object-store upload or download.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import REGISTRY
from .failpoints import FAILPOINTS, FailpointError
from .spill import SpillFile

_WRITE_BYTES = REGISTRY.counter("spool_write_bytes_total")
_READ_BYTES = REGISTRY.counter("spool_read_bytes_total")
_CORRUPTIONS = REGISTRY.counter("spool_corruption_total")
_GC_BYTES = REGISTRY.counter("spool_gc_bytes_total")
_RESIDENT = REGISTRY.gauge("spool_resident_bytes")

_OBJ_PUTS = REGISTRY.counter("spool_object_put_total")
_OBJ_GETS = REGISTRY.counter("spool_object_get_total")
_OBJ_PUT_BYTES = REGISTRY.counter("spool_object_put_bytes_total")
_OBJ_GET_BYTES = REGISTRY.counter("spool_object_get_bytes_total")
_OBJ_DEDUP = REGISTRY.counter("spool_object_dedup_total")
_OBJ_RESIDENT = REGISTRY.gauge("spool_object_resident_bytes")
_OBJ_RTT = REGISTRY.histogram("spool_object_rtt_seconds")

_FRAME = struct.Struct("<III")          # token, length, crc32
DEFAULT_MAX_BYTES = 4 << 30


class SpoolCorruptionError(RuntimeError):
    """A spooled page failed its checksum (or went unreadable): the
    spool copy is unusable and the producer must be re-run."""


class SpoolFullError(RuntimeError):
    """The store is at ``spool.max-bytes``; the writing task fails
    (and retries once queries release their spool space)."""


class SpoolWriter:
    """One task attempt's write handle: page logs for each output
    buffer plus the completion marker. Single-threaded by construction
    (the task's producer thread is the only writer)."""

    def __init__(self, store: "LocalDiskSpoolStore", query_id: str,
                 task_id: str, n_buffers: int):
        self.store = store
        self.query_id = query_id
        self.task_id = task_id
        self.n_buffers = n_buffers
        self._files: Dict[int, SpillFile] = {}
        self._closed = False

    def _file(self, buffer_id: int) -> SpillFile:
        f = self._files.get(buffer_id)
        if f is None:
            path = self.store._page_path(self.query_id, self.task_id,
                                         buffer_id, create=True)
            f = self._files[buffer_id] = SpillFile(path=path,
                                                  delete=False)
        return f

    def append(self, buffer_id: int, token: int, page: bytes) -> None:
        key = f"{self.task_id}/{buffer_id}/{token}"
        FAILPOINTS.hit("spool.write", key=key, task_id=self.task_id)
        crc = zlib.crc32(page) & 0xFFFFFFFF
        try:
            # deliberate corruption injection: the frame keeps the
            # ORIGINAL checksum while one payload byte flips — the read
            # path must catch it (chaos scenario spool_corrupt)
            FAILPOINTS.hit("spool.corrupt", key=key,
                           task_id=self.task_id)
        except FailpointError:
            page = bytes([page[0] ^ 0xFF]) + page[1:] if page else page
        frame = _FRAME.pack(token, len(page), crc) + page
        self.store._reserve(self.query_id, len(frame))
        f = self._file(buffer_id)
        f.append(frame)
        f.flush()
        _WRITE_BYTES.inc(len(frame))

    def finish(self, next_tokens: List[int]) -> None:
        """Commit the attempt: every buffer's final token count becomes
        durable BEFORE the task announces FINISHED, so a consumer that
        sees the marker can trust the page logs are complete."""
        for f in self._files.values():
            f.flush()
        doc = json.dumps({"tokens": [int(t) for t in next_tokens]})
        path = self.store._done_path(self.query_id, self.task_id,
                                     create=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(doc)
        os.replace(tmp, path)
        self.store._reserve(self.query_id, len(doc))
        self.close()

    def abandon(self) -> None:
        """Drop a failed/aborted attempt's partial page logs now (the
        per-query GC at query end is the backstop)."""
        self.close()
        self.store._drop_task(self.query_id, self.task_id,
                              self.n_buffers)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files = {}


class SpoolStore:
    """Backend interface; implementations must be safe for concurrent
    writers (distinct task attempts) and readers."""

    def writer(self, query_id: str, task_id: str,
               n_buffers: int) -> SpoolWriter:
        raise NotImplementedError

    def finished_tokens(self, query_id: str,
                        task_id: str) -> Optional[List[int]]:
        raise NotImplementedError

    def read_pages(self, query_id: str, task_id: str, buffer_id: int,
                   token: int,
                   max_bytes: int = 8 << 20) -> Tuple[List[bytes], int]:
        raise NotImplementedError

    def release_query(self, query_id: str) -> int:
        raise NotImplementedError


class _FileIndex:
    """Incremental frame index over one append-only page log: repeated
    reads re-scan only bytes appended since the last scan. Owns its
    own lock so a cold scan of a large page log (disk I/O) never
    holds the store-wide lock that every producer's per-page
    ``_reserve`` takes."""

    __slots__ = ("scanned", "frames", "lock")

    def __init__(self):
        from .._devtools.lockcheck import checked_lock
        self.scanned = 0
        self.frames: Dict[int, Tuple[int, int, int]] = {}
        # token -> (payload offset, length, crc)
        self.lock = checked_lock("spool.file-index")


class LocalDiskSpoolStore(SpoolStore):
    """Local-filesystem backend: ``<dir>/<query_id>/`` per query.
    Point ``spool.dir`` at shared storage (NFS, a host-local dir for
    in-process clusters) and every node reads every node's pages —
    the property the drain fast-exit and worker-death replay paths
    rely on."""

    def __init__(self, directory: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        from .._devtools.lockcheck import checked_lock
        self._lock = checked_lock("spool.store")
        self._dir = directory
        self.max_bytes = int(max_bytes)
        self._query_bytes: Dict[str, int] = {}
        self._index: Dict[str, _FileIndex] = {}

    # -- configuration -------------------------------------------------------
    def configure(self, directory: Optional[str] = None,
                  max_bytes: Optional[int] = None) -> None:
        """Apply ``spool.dir`` / ``spool.max-bytes`` (config boot path;
        per-node, BEFORE any query runs)."""
        with self._lock:
            if directory:
                self._dir = directory
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)

    @property
    def directory(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(
                    prefix="presto-tpu-torch-spool-")
            os.makedirs(self._dir, exist_ok=True)
            return self._dir

    # -- paths ---------------------------------------------------------------
    def _query_dir(self, query_id: str, create: bool = False) -> str:
        d = os.path.join(self.directory, query_id)
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def _page_path(self, query_id: str, task_id: str, buffer_id: int,
                   create: bool = False) -> str:
        # readers never create: a late read after release_query must
        # not resurrect an empty per-query directory (the chaos suite
        # asserts zero orphans)
        return os.path.join(self._query_dir(query_id, create=create),
                            f"{task_id}.b{buffer_id}.pages")

    def _done_path(self, query_id: str, task_id: str,
                   create: bool = False) -> str:
        return os.path.join(self._query_dir(query_id, create=create),
                            f"{task_id}.done")

    # -- accounting ----------------------------------------------------------
    def _reserve(self, query_id: str, n: int) -> None:
        with self._lock:
            total = sum(self._query_bytes.values())
            if total + n > self.max_bytes:
                raise SpoolFullError(
                    f"spool at {total} of {self.max_bytes} bytes "
                    f"(spool.max-bytes); cannot append {n}")
            self._query_bytes[query_id] = \
                self._query_bytes.get(query_id, 0) + n
            _RESIDENT.set(total + n)

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": sum(self._query_bytes.values()),
                    "queries": len(self._query_bytes),
                    "max_bytes": self.max_bytes}

    # -- write side ----------------------------------------------------------
    def writer(self, query_id: str, task_id: str,
               n_buffers: int) -> SpoolWriter:
        return SpoolWriter(self, query_id, task_id, n_buffers)

    # -- read side -----------------------------------------------------------
    def finished_tokens(self, query_id: str,
                        task_id: str) -> Optional[List[int]]:
        """The committed attempt's per-buffer token counts, or None
        while the attempt is incomplete/unknown (normal retry applies)."""
        path = self._done_path(query_id, task_id)
        try:
            with open(path, encoding="utf-8") as f:
                return [int(t) for t in json.load(f)["tokens"]]
        except (OSError, ValueError, KeyError):
            return None

    def _scan(self, idx: _FileIndex, path: str) -> None:
        """Extend the frame index over newly appended bytes (caller
        holds the INDEX lock, not the store lock). A partial trailing
        frame (writer mid-append) is left unindexed until it
        completes."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size <= idx.scanned:
            return
        with open(path, "rb") as f:
            f.seek(idx.scanned)
            off = idx.scanned
            while True:
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    break
                token, length, crc = _FRAME.unpack(head)
                if off + _FRAME.size + length > size:
                    break               # partial trailing frame
                idx.frames[token] = (off + _FRAME.size, length, crc)
                f.seek(length, os.SEEK_CUR)
                off += _FRAME.size + length
            idx.scanned = off

    def read_pages(self, query_id: str, task_id: str, buffer_id: int,
                   token: int,
                   max_bytes: int = 8 << 20) -> Tuple[List[bytes], int]:
        """Pages at/after ``token`` in token order (bounded by
        ``max_bytes``), with checksum verification. Returns
        ``(pages, next_token)``; an unreadable or checksum-failing page
        raises :class:`SpoolCorruptionError`."""
        path = self._page_path(query_id, task_id, buffer_id)
        with self._lock:
            idx = self._index.get(path)
            if idx is None:
                idx = self._index[path] = _FileIndex()
        with idx.lock:
            self._scan(idx, path)
            want: List[Tuple[int, Tuple[int, int, int]]] = []
            t = token
            while t in idx.frames:
                want.append((t, idx.frames[t]))
                t += 1
        out: List[bytes] = []
        nxt = token
        size = 0
        if not want:
            # nothing indexed at/after this token (unknown task,
            # abandoned attempt, or the writer hasn't got there yet):
            # an empty read, not an error — the caller's completion
            # marker decides whether more was promised
            return out, nxt
        try:
            with open(path, "rb") as f:
                for t, (off, length, crc) in want:
                    FAILPOINTS.hit(
                        "spool.read",
                        key=f"{task_id}/{buffer_id}/{t}",
                        task_id=task_id)
                    f.seek(off)
                    page = f.read(length)
                    if len(page) != length \
                            or (zlib.crc32(page) & 0xFFFFFFFF) != crc:
                        _CORRUPTIONS.inc()
                        raise SpoolCorruptionError(
                            f"spool page {task_id}/b{buffer_id}/t{t} "
                            f"failed checksum")
                    out.append(page)
                    _READ_BYTES.inc(len(page))
                    nxt = t + 1
                    size += length
                    if size >= max_bytes:
                        break
        except OSError as e:
            raise SpoolCorruptionError(
                f"spool page log {task_id}/b{buffer_id} unreadable: "
                f"{e}") from None
        return out, nxt

    # -- GC ------------------------------------------------------------------
    def _drop_task(self, query_id: str, task_id: str,
                   n_buffers: int) -> None:
        freed = 0
        paths = [self._done_path(query_id, task_id)] + [
            self._page_path(query_id, task_id, b)
            for b in range(n_buffers)]
        for p in paths:
            try:
                freed += os.path.getsize(p)
                os.unlink(p)
            except OSError:
                pass
            with self._lock:
                self._index.pop(p, None)
        # a straggler attempt appending AFTER its query's
        # release_query (abort sets the flag, the task thread may be
        # mid-append) briefly resurrects the per-query directory and
        # its accounting entry; its abandon() lands here — drop the
        # emptied directory and the zeroed entry so nothing orphans
        try:
            os.rmdir(os.path.join(self.directory, query_id))
        except OSError:
            pass                        # non-empty or already gone
        with self._lock:
            q = self._query_bytes.get(query_id, 0)
            if q - freed <= 0:
                self._query_bytes.pop(query_id, None)
            else:
                self._query_bytes[query_id] = q - freed
            _RESIDENT.set(sum(self._query_bytes.values()))
        if freed:
            _GC_BYTES.inc(freed)

    def release_query(self, query_id: str) -> int:
        """Remove the query's spool directory (query end / abort).
        Idempotent — coordinator and every worker may each release."""
        d = os.path.join(self.directory, query_id)
        with self._lock:
            freed = self._query_bytes.pop(query_id, 0)
            prefix = d + os.sep
            for p in [p for p in self._index if p.startswith(prefix)]:
                del self._index[p]
            _RESIDENT.set(sum(self._query_bytes.values()))
        shutil.rmtree(d, ignore_errors=True)
        if freed:
            _GC_BYTES.inc(freed)
        return freed

    def query_dirs(self) -> List[str]:
        """Per-query spool directories currently on disk (the chaos
        suite's no-orphans assertion)."""
        with self._lock:
            if self._dir is None or not os.path.isdir(self._dir):
                return []
            return sorted(
                e for e in os.listdir(self._dir)
                if os.path.isdir(os.path.join(self._dir, e)))


class ObjectSpoolWriter:
    """One task attempt's write handle against the object backend.
    Pages go up as content-addressed blobs immediately (durable before
    the buffer makes them visible); :meth:`finish` commits the attempt
    by uploading the manifest. Duck-types :class:`SpoolWriter`."""

    def __init__(self, store: "ObjectSpoolStore", query_id: str,
                 task_id: str, n_buffers: int):
        self.store = store
        self.query_id = query_id
        self.task_id = task_id
        self.n_buffers = n_buffers
        # buffer_id -> [(token, digest, length, crc), ...]
        self._entries: Dict[int, List[Tuple[int, str, int, int]]] = {}
        self._closed = False

    def append(self, buffer_id: int, token: int, page: bytes) -> None:
        key = f"{self.task_id}/{buffer_id}/{token}"
        FAILPOINTS.hit("spool.write", key=key, task_id=self.task_id)
        crc = zlib.crc32(page) & 0xFFFFFFFF
        digest = hashlib.sha256(page).hexdigest()[:32]
        try:
            # same deliberate-corruption contract as the disk backend:
            # digest and checksum are of the CLEAN page, the stored
            # blob carries one flipped byte for the read path to catch
            FAILPOINTS.hit("spool.corrupt", key=key,
                           task_id=self.task_id)
        except FailpointError:
            page = bytes([page[0] ^ 0xFF]) + page[1:] if page else page
        self.store._put_page(self.query_id, self.task_id, buffer_id,
                             token, digest, page, crc)
        self._entries.setdefault(buffer_id, []).append(
            (token, digest, len(page), crc))

    def finish(self, next_tokens: List[int]) -> None:
        """Commit the attempt: the manifest (per-buffer token counts +
        the full token -> blob map) uploads atomically BEFORE the task
        announces FINISHED — a reader that sees the manifest can trust
        every referenced blob is already durable."""
        self.store._put_manifest(
            self.query_id, self.task_id,
            {"tokens": [int(t) for t in next_tokens],
             "buffers": {str(b): [[t, d, ln, crc]
                                  for t, d, ln, crc in entries]
                         for b, entries in self._entries.items()}})
        self.close()

    def abandon(self) -> None:
        """Drop a failed/aborted attempt: decrement the blob refcounts
        this writer took and delete anything unreferenced now (the
        per-query GC at query end is the backstop)."""
        self.close()
        self.store._abandon_task(self.query_id, self.task_id,
                                 self._entries)
        self._entries = {}

    def close(self) -> None:
        self._closed = True


class ObjectSpoolStore(SpoolStore):
    """Emulated object-store backend: one "bucket" directory with
    whole-object puts/gets, per-query prefixes, and a config-injected
    latency/bandwidth model (``spool.object.put-latency-ms`` /
    ``get-latency-ms`` / ``bandwidth-mbps``) standing in for GCS/S3
    round trips.

    Layout under the bucket::

        <query_id>/blobs/<sha256-digest>       content-addressed pages
        <query_id>/manifests/<task_id>.json    the attempt commit marker

    Pages are content-addressed: identical payloads (broadcast
    exchange pages fan the same bytes to every consumer buffer) store
    ONE blob, reference-counted in process. A task attempt becomes
    visible to remote readers only when its manifest commits
    (atomic whole-object put), so a writer killed mid-upload leaves
    garbage blobs for query GC, never a torn attempt. Uncommitted
    pages remain readable to the OWNING process through a live
    in-memory index — the worker's own output buffer serves
    spool-evicted tokens from it before the attempt commits."""

    def __init__(self, directory: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 put_latency_s: float = 0.0,
                 get_latency_s: float = 0.0,
                 bandwidth_bytes_per_s: float = 0.0):
        from .._devtools.lockcheck import checked_lock
        self._lock = checked_lock("spool.object-store")
        self._dir = directory
        self.max_bytes = int(max_bytes)
        self.put_latency_s = float(put_latency_s)
        self.get_latency_s = float(get_latency_s)
        #: 0 = infinite (latency-only model)
        self.bandwidth_bytes_per_s = float(bandwidth_bytes_per_s)
        self._query_bytes: Dict[str, int] = {}
        #: query -> digest -> refcount (in-process; cross-process
        #: deployments fall back to query-end GC for shared blobs)
        self._refs: Dict[str, Dict[str, int]] = {}
        #: (query, task, buffer) -> {token: (digest, length, crc)} —
        #: the uncommitted-attempt index for the owning process
        self._live: Dict[Tuple[str, str, int],
                         Dict[int, Tuple[str, int, int]]] = {}
        #: committed manifests, cached (immutable once committed)
        self._manifests: Dict[Tuple[str, str], Dict] = {}

    # -- configuration -------------------------------------------------------
    def configure(self, directory: Optional[str] = None,
                  max_bytes: Optional[int] = None,
                  put_latency_s: Optional[float] = None,
                  get_latency_s: Optional[float] = None,
                  bandwidth_bytes_per_s: Optional[float] = None) -> None:
        with self._lock:
            if directory:
                self._dir = directory
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            if put_latency_s is not None:
                self.put_latency_s = float(put_latency_s)
            if get_latency_s is not None:
                self.get_latency_s = float(get_latency_s)
            if bandwidth_bytes_per_s is not None:
                self.bandwidth_bytes_per_s = float(bandwidth_bytes_per_s)

    @property
    def directory(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(
                    prefix="presto-tpu-torch-objspool-")
            os.makedirs(self._dir, exist_ok=True)
            return self._dir

    # -- the emulated wire ---------------------------------------------------
    def _transfer(self, n_bytes: int, latency_s: float) -> None:
        """Pay one modeled object-store round trip (outside any lock)."""
        delay = latency_s
        if self.bandwidth_bytes_per_s > 0:
            delay += n_bytes / self.bandwidth_bytes_per_s
        if delay > 0:
            time.sleep(delay)
        _OBJ_RTT.observe(delay)

    # -- paths ---------------------------------------------------------------
    def _blob_path(self, query_id: str, digest: str,
                   create: bool = False) -> str:
        d = os.path.join(self.directory, query_id, "blobs")
        if create:
            os.makedirs(d, exist_ok=True)
        return os.path.join(d, digest)

    def _manifest_path(self, query_id: str, task_id: str,
                       create: bool = False) -> str:
        d = os.path.join(self.directory, query_id, "manifests")
        if create:
            os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{task_id}.json")

    def _atomic_put(self, path: str, payload: bytes) -> None:
        tmp = f"{path}.up.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    # -- accounting ----------------------------------------------------------
    def _reserve_locked(self, query_id: str, n: int) -> None:
        total = sum(self._query_bytes.values())
        if total + n > self.max_bytes:
            raise SpoolFullError(
                f"object spool at {total} of {self.max_bytes} bytes "
                f"(spool.max-bytes); cannot put {n}")
        self._query_bytes[query_id] = \
            self._query_bytes.get(query_id, 0) + n
        _OBJ_RESIDENT.set(total + n)

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": sum(self._query_bytes.values()),
                    "queries": len(self._query_bytes),
                    "max_bytes": self.max_bytes}

    # -- write side ----------------------------------------------------------
    def writer(self, query_id: str, task_id: str,
               n_buffers: int) -> ObjectSpoolWriter:
        return ObjectSpoolWriter(self, query_id, task_id, n_buffers)

    def _put_page(self, query_id: str, task_id: str, buffer_id: int,
                  token: int, digest: str, page: bytes,
                  crc: int) -> None:
        key = f"{task_id}/{buffer_id}/{token}"
        FAILPOINTS.hit("spool.object_put", key=key, task_id=task_id)
        with self._lock:
            refs = self._refs.setdefault(query_id, {})
            fresh = refs.get(digest, 0) == 0
            if fresh:
                self._reserve_locked(query_id, len(page))
            refs[digest] = refs.get(digest, 0) + 1
        if fresh:
            self._transfer(len(page), self.put_latency_s)
            self._atomic_put(
                self._blob_path(query_id, digest, create=True), page)
            _OBJ_PUTS.inc()
            _OBJ_PUT_BYTES.inc(len(page))
            _WRITE_BYTES.inc(len(page))
        else:
            # content-addressing pays off: the blob is already up —
            # one latency-only round trip confirms it
            self._transfer(0, self.put_latency_s)
            _OBJ_DEDUP.inc()
        with self._lock:
            self._live.setdefault((query_id, task_id, buffer_id), {})[
                token] = (digest, len(page), crc)

    def _put_manifest(self, query_id: str, task_id: str,
                      doc: Dict) -> None:
        FAILPOINTS.hit("spool.object_put", key=f"{task_id}/manifest",
                       task_id=task_id)
        payload = json.dumps(doc).encode()
        with self._lock:
            self._reserve_locked(query_id, len(payload))
        self._transfer(len(payload), self.put_latency_s)
        self._atomic_put(
            self._manifest_path(query_id, task_id, create=True), payload)
        _OBJ_PUTS.inc()
        _OBJ_PUT_BYTES.inc(len(payload))
        _WRITE_BYTES.inc(len(payload))
        with self._lock:
            self._manifests[(query_id, task_id)] = doc
            for k in [k for k in self._live
                      if k[0] == query_id and k[1] == task_id]:
                del self._live[k]

    def _abandon_task(self, query_id: str, task_id: str,
                      entries: Dict[int, List[Tuple[int, str, int, int]]]
                      ) -> None:
        doomed: List[Tuple[str, int]] = []
        with self._lock:
            refs = self._refs.get(query_id, {})
            for buf_entries in entries.values():
                for _t, digest, length, _crc in buf_entries:
                    n = refs.get(digest, 0) - 1
                    if n <= 0:
                        refs.pop(digest, None)
                        doomed.append((digest, length))
                    else:
                        refs[digest] = n
            for k in [k for k in self._live
                      if k[0] == query_id and k[1] == task_id]:
                del self._live[k]
            freed = sum(ln for _d, ln in doomed)
            q = self._query_bytes.get(query_id, 0)
            if q - freed <= 0:
                self._query_bytes.pop(query_id, None)
            else:
                self._query_bytes[query_id] = q - freed
            _OBJ_RESIDENT.set(sum(self._query_bytes.values()))
        for digest, _ln in doomed:
            try:
                os.unlink(self._blob_path(query_id, digest))
            except OSError:
                pass
        try:
            os.unlink(self._manifest_path(query_id, task_id))
        except OSError:
            pass
        if doomed:
            _GC_BYTES.inc(sum(ln for _d, ln in doomed))

    # -- read side -----------------------------------------------------------
    def _get_manifest(self, query_id: str, task_id: str
                      ) -> Optional[Dict]:
        with self._lock:
            doc = self._manifests.get((query_id, task_id))
        if doc is not None:
            return doc
        path = self._manifest_path(query_id, task_id)
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        self._transfer(size, self.get_latency_s)
        _OBJ_GETS.inc()
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            doc["tokens"]
        except (OSError, ValueError, KeyError):
            # a torn/garbled manifest is an UNCOMMITTED attempt, not a
            # corruption: readers fall back to normal retry semantics
            return None
        _OBJ_GET_BYTES.inc(size)
        with self._lock:
            self._manifests[(query_id, task_id)] = doc
        return doc

    def finished_tokens(self, query_id: str,
                        task_id: str) -> Optional[List[int]]:
        doc = self._get_manifest(query_id, task_id)
        if doc is None:
            return None
        try:
            return [int(t) for t in doc["tokens"]]
        except (ValueError, TypeError, KeyError):
            return None

    def _frames_for(self, query_id: str, task_id: str, buffer_id: int
                    ) -> Dict[int, Tuple[str, int, int]]:
        """token -> (digest, length, crc), committed or live."""
        doc = self._get_manifest(query_id, task_id)
        if doc is not None:
            out: Dict[int, Tuple[str, int, int]] = {}
            for t, digest, length, crc in \
                    doc.get("buffers", {}).get(str(buffer_id), ()):
                out[int(t)] = (digest, int(length), int(crc))
            return out
        with self._lock:
            live = self._live.get((query_id, task_id, buffer_id))
            return dict(live) if live else {}

    def read_pages(self, query_id: str, task_id: str, buffer_id: int,
                   token: int,
                   max_bytes: int = 8 << 20) -> Tuple[List[bytes], int]:
        frames = self._frames_for(query_id, task_id, buffer_id)
        out: List[bytes] = []
        nxt = token
        size = 0
        t = token
        while t in frames:
            digest, length, crc = frames[t]
            key = f"{task_id}/{buffer_id}/{t}"
            FAILPOINTS.hit("spool.read", key=key, task_id=task_id)
            FAILPOINTS.hit("spool.object_get", key=key, task_id=task_id)
            self._transfer(length, self.get_latency_s)
            try:
                with open(self._blob_path(query_id, digest), "rb") as f:
                    page = f.read()
            except OSError as e:
                raise SpoolCorruptionError(
                    f"spool object {task_id}/b{buffer_id}/t{t} "
                    f"unreadable: {e}") from None
            _OBJ_GETS.inc()
            if len(page) != length \
                    or (zlib.crc32(page) & 0xFFFFFFFF) != crc:
                _CORRUPTIONS.inc()
                raise SpoolCorruptionError(
                    f"spool page {task_id}/b{buffer_id}/t{t} "
                    f"failed checksum")
            out.append(page)
            _READ_BYTES.inc(len(page))
            _OBJ_GET_BYTES.inc(len(page))
            nxt = t + 1
            size += length
            t += 1
            if size >= max_bytes:
                break
        return out, nxt

    # -- GC ------------------------------------------------------------------
    def release_query(self, query_id: str) -> int:
        """Delete the query's object prefix (query end / abort).
        Idempotent; zero orphaned objects is the chaos contract."""
        d = os.path.join(self.directory, query_id)
        with self._lock:
            freed = self._query_bytes.pop(query_id, 0)
            self._refs.pop(query_id, None)
            for k in [k for k in self._live if k[0] == query_id]:
                del self._live[k]
            for k in [k for k in self._manifests if k[0] == query_id]:
                del self._manifests[k]
            _OBJ_RESIDENT.set(sum(self._query_bytes.values()))
        shutil.rmtree(d, ignore_errors=True)
        if freed:
            _GC_BYTES.inc(freed)
        return freed

    def query_dirs(self) -> List[str]:
        with self._lock:
            if self._dir is None or not os.path.isdir(self._dir):
                return []
            return sorted(
                e for e in os.listdir(self._dir)
                if os.path.isdir(os.path.join(self._dir, e)))


class SwitchableSpoolStore(SpoolStore):
    """The process-wide facade over both backends. Call sites
    (``SPOOL.writer/finished_tokens/read_pages/release_query``)
    delegate to whichever backend ``spool.backend`` selected; switching
    applies to queries that START after the switch — an in-flight
    query must finish on the backend it began on (the config boot path
    switches before any query runs; chaos switches between queries)."""

    def __init__(self):
        self._local = LocalDiskSpoolStore()
        self._object = ObjectSpoolStore()
        self._impl: SpoolStore = self._local

    @property
    def backend(self) -> str:
        return "object" if self._impl is self._object else "local"

    @property
    def object_store(self) -> ObjectSpoolStore:
        return self._object

    @property
    def local_store(self) -> LocalDiskSpoolStore:
        return self._local

    def configure(self, directory: Optional[str] = None,
                  max_bytes: Optional[int] = None,
                  backend: Optional[str] = None,
                  object_dir: Optional[str] = None,
                  object_put_latency_s: Optional[float] = None,
                  object_get_latency_s: Optional[float] = None,
                  object_bandwidth_mbps: Optional[float] = None) -> None:
        """Apply ``spool.*`` config (boot path / chaos harness)."""
        self._local.configure(directory=directory, max_bytes=max_bytes)
        bw = None if object_bandwidth_mbps is None \
            else float(object_bandwidth_mbps) * 1e6 / 8.0
        self._object.configure(
            directory=object_dir, max_bytes=max_bytes,
            put_latency_s=object_put_latency_s,
            get_latency_s=object_get_latency_s,
            bandwidth_bytes_per_s=bw)
        if backend is not None:
            if backend not in ("local", "object"):
                raise ValueError(
                    f"spool.backend must be local or object, "
                    f"got {backend!r}")
            self._impl = self._object if backend == "object" \
                else self._local

    def settings(self) -> tuple:
        """The store's configuration (backend, both directories, the
        object store's modeled wire), for :meth:`restore`: a harness
        that reconfigures the process-wide store puts it back after."""
        o = self._object
        with self._local._lock:
            local_dir = self._local._dir
        with o._lock:
            return (self._impl, local_dir, o._dir, o.put_latency_s,
                    o.get_latency_s, o.bandwidth_bytes_per_s)

    def restore(self, settings: tuple) -> None:
        o = self._object
        impl, local_dir, *wire = settings
        with self._local._lock:
            self._local._dir = local_dir
        with o._lock:
            (o._dir, o.put_latency_s, o.get_latency_s,
             o.bandwidth_bytes_per_s) = wire
        self._impl = impl

    def writer(self, query_id: str, task_id: str, n_buffers: int):
        return self._impl.writer(query_id, task_id, n_buffers)

    def finished_tokens(self, query_id: str,
                        task_id: str) -> Optional[List[int]]:
        return self._impl.finished_tokens(query_id, task_id)

    def read_pages(self, query_id: str, task_id: str, buffer_id: int,
                   token: int,
                   max_bytes: int = 8 << 20) -> Tuple[List[bytes], int]:
        return self._impl.read_pages(query_id, task_id, buffer_id,
                                     token, max_bytes)

    def release_query(self, query_id: str) -> int:
        freed = 0
        # never-touched backends (no directory yet) have nothing to
        # free — skip them so release doesn't materialize temp dirs
        if self._local._dir is not None:
            freed += self._local.release_query(query_id)
        if self._object._dir is not None:
            freed += self._object.release_query(query_id)
        return freed

    def usage(self) -> Dict[str, int]:
        return self._impl.usage()

    def query_dirs(self) -> List[str]:
        """Union across backends (the chaos no-orphans sweep must see
        leftovers no matter which backend a query ran on)."""
        return sorted(set(self._local.query_dirs())
                      | set(self._object.query_dirs()))


#: the process-wide store (every worker/coordinator in this process
#: shares it; separate processes share through ``spool.dir`` /
#: ``spool.object.dir`` pointing at common storage)
SPOOL = SwitchableSpoolStore()
