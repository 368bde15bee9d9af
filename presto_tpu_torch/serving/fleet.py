"""Coordinator fleet membership: coherent caches + federated admission.

The counterpart of ``presto_tpu/serving/fleet.py``. One
:class:`FleetMember` rides inside each coordinator
(server/protocol.PrestoTpuServer.enable_fleet) and makes N stateless
coordinators behave like one serving plane (the reference's dispatcher
split: scale the front door by replicating dispatch, carry correctness
in versioned invalidation rather than shared memory). Host code only:
what crosses the wire is JSON, and no tensor is involved.

**Cache coherence (write bumps).** Every coordinator's plan, template,
result and scan caches subscribe to ``connectors.spi.on_data_change``
and invalidate eagerly on LOCAL connector writes. The member adds the
wire hop: a local write broadcasts a monotonic ``(connector_id, table,
data_version, write_epoch)`` bump to every peer (``POST
/v1/fleet/bump``); the receiving member resolves ``connector_id`` (the
catalog name, the only cross-process-stable connector identity) to ITS
OWN connector instance and folds the bump by calling
``spi.notify_data_change`` on it. Folding through the spi path, never
by poking caches directly, runs every cache's registered ``_on_write``
listener, each one bumping its write epoch BEFORE dropping entries, so
a remote bump racing a local plan, template or result insert vetoes
that insert exactly like a local write would. Bumps are deduped per
``(origin, connector, table)`` by the origin's monotonic sequence; the
dedupe high-water mark is advanced only AFTER the fold so a failed fold
is retried, never silently skipped. A coordinator that misses a
broadcast entirely (peer crash, armed ``fleet.broadcast`` failpoint)
still fails safe: every cache hit revalidates its stamped
``data_version`` against the connector before serving.

**Federated admission (heartbeats).** Resource-group limits are
per-tenant promises, not per-coordinator ones. Members exchange
per-group ``{running, queued, memory}`` counts on the heartbeat
cadence (``POST /v1/fleet/heartbeat``); the local
``ResourceGroupManager`` consults the federated view (it installs
this member as its ``federation`` provider) so ``can_run_more`` sums
remote running counts and remote memory into every limit check.
Remote snapshots older than the staleness grace (default 3 heartbeats)
are ignored, bounded staleness: a dead peer's counts expire instead
of hard-blocking the fleet, and the first grace expiry per peer counts
``coordinator_lost_total`` (a clean drain sends a final ``leaving``
heartbeat and is NOT a loss). Heartbeats also carry the per-group
``serving_*`` SLO counters; the receiver feeds them into the local
time-series store through its federated ``record()`` path (origin-
tagged series), so any coordinator's health plane can aggregate the
fleet's per-tenant traffic.

**Failure model.** Coordinator death is a non-event: the client
(client.FleetClient) round-robins statements and retries a failed
dispatch on the next coordinator; queued queries blocked on a dead
peer's federated counts unblock after the grace; caches self-heal via
hit-time revalidation. There is no fleet consensus and no leader:
members are peers, and every message is idempotent or monotonic.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
import weakref
from typing import Dict, List, Optional, Tuple

from .._devtools.lockcheck import checked_lock
from ..connectors import spi
from ..exec.failpoints import FAILPOINTS, FailpointError
from ..obs.metrics import REGISTRY

_BUMP_BROADCAST = REGISTRY.counter("fleet_bump_broadcast_total")
_BUMP_DROPPED = REGISTRY.counter("fleet_bump_dropped_total")
_BUMP_FOLD = REGISTRY.counter("fleet_bump_fold_total")
_BUMP_STALE = REGISTRY.counter("fleet_bump_stale_total")
_BUMP_UNKNOWN = REGISTRY.counter("fleet_bump_unknown_catalog_total")
_PEER_POST_FAILURE = REGISTRY.counter("fleet_peer_post_failure_total")
_HEARTBEAT = REGISTRY.counter("fleet_heartbeat_total")
_HEARTBEAT_FOLD = REGISTRY.counter("fleet_heartbeat_fold_total")
_REMOTE_BLOCKED = REGISTRY.counter(
    "fleet_admission_remote_blocked_total")
_COORDINATOR_LOST = REGISTRY.counter("coordinator_lost_total")

#: serving counter families a heartbeat federates: the cumulative
#: per-group SLO feeds (quantile points are derived locally, never
#: shipped).  ``serving_latency_seconds`` is a histogram — only its
#: flattened ``.count``/``.sum`` rows are cumulative.
_SERVING_FAMILIES = ("serving_requests_total.",
                     "serving_errors_total.")
_SERVING_HIST_TAILS = (".count", ".sum")
_SERVING_HIST_PREFIX = "serving_latency_seconds."


def _is_federated_serving(name: str) -> bool:
    if name.startswith(_SERVING_FAMILIES):
        return True
    return (name.startswith(_SERVING_HIST_PREFIX)
            and name.endswith(_SERVING_HIST_TAILS))


def _post_json(url: str, doc: dict, timeout: float) -> None:
    body = json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout):
        pass


def _jsonable(v):
    """Data versions are connector-defined (tuples of (file, mtime),
    ints, ...); the bump carries a JSON-safe rendering, advisory only —
    the receiver's caches re-read their OWN connector's version at
    hit time."""
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class FleetMember:
    """One coordinator's seat in the fleet. Stateless beyond soft
    state: the bump dedupe marks and remote heartbeat snapshots both
    rebuild from the wire after a restart."""

    def __init__(self, node_id: str, self_url: str, catalogs=None,
                 resource_groups=None, discovery=None,
                 peers=(), heartbeat_s: float = 1.0,
                 staleness_grace_s: Optional[float] = None,
                 post_timeout_s: float = 5.0):
        self.node_id = node_id
        self.self_url = self_url.rstrip("/")
        self._catalogs = catalogs
        self._manager = resource_groups
        self._discovery = discovery
        self.heartbeat_s = float(heartbeat_s)
        #: bounded staleness: remote counts older than this are ignored
        #: by admission and the origin is declared lost (once)
        self.staleness_grace_s = (3.0 * self.heartbeat_s
                                  if staleness_grace_s is None
                                  else float(staleness_grace_s))
        self.post_timeout_s = float(post_timeout_s)
        self._lock = checked_lock("fleet.member")
        self._peers: List[str] = [p.rstrip("/") for p in peers
                                  if p.rstrip("/") != self.self_url]
        self._seq = 0                      # local bump sequence
        self._hb_seq = 0
        #: (origin, connector_id, table) -> highest folded seq
        self._seen: Dict[Tuple[str, str, str], int] = {}
        #: origin -> {"t": recv monotonic, "groups": {path: counts}}
        self._remote: Dict[str, dict] = {}
        self._lost: set = set()
        self._stopped = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # the spi listener list is append-only; register a weak
        # trampoline so a dead member (tests build many) costs one
        # dead-ref check per write, never a broadcast
        ref = weakref.ref(self)

        def _listener(conn, table, _ref=ref):
            m = _ref()
            if m is not None:
                m._on_local_write(conn, table)
        spi.on_data_change(_listener)
        if resource_groups is not None:
            # admission federation: can_run_more() consults this member
            resource_groups.federation = self
        if discovery is not None:
            # coordinators are discovery citizens too (role-tagged so
            # they never enter the worker scheduling sweep)
            discovery.announce(node_id, self.self_url, role="coordinator")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Begin the heartbeat loop (idempotent)."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._stopped.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"fleet-hb-{self.node_id}",
            daemon=True)
        self._hb_thread.start()

    def stop(self) -> None:
        """Hard stop (the process-death stand-in in tests): heartbeats
        cease, peers notice via the staleness grace. A heartbeat in
        flight lands before this returns."""
        self._stopped.set()
        if self._hb_thread is not None \
                and self._hb_thread is not threading.current_thread():
            self._hb_thread.join(timeout=10.0)

    def leave(self) -> None:
        """Clean drain: stop the loop, then one final ``leaving``
        heartbeat so peers drop this member's counts NOW (and never count
        it as lost). The loop stops first: a beat still in flight would
        otherwise land after the farewell and count the member back in."""
        self.stop()
        self.heartbeat_once(leaving=True)

    def set_peers(self, peers) -> None:
        with self._lock:
            self._peers = [p.rstrip("/") for p in peers
                           if p.rstrip("/") != self.self_url]

    def peers(self) -> List[str]:
        with self._lock:
            return list(self._peers)

    # -- write bumps: broadcast side -----------------------------------------
    def _catalog_of(self, conn) -> Optional[str]:
        """The cross-process-stable connector identity: its catalog
        name in THIS coordinator's catalog manager. A connector not
        registered here (another embedded server's catalog in the same
        process) is not ours to broadcast."""
        cm = self._catalogs
        if cm is None:
            return None
        try:
            for name in cm.names():
                if cm.get(name) is conn:
                    return name
        except Exception:
            return None
        return None

    _folding = threading.local()

    def _on_local_write(self, conn, table: str) -> None:
        """spi.on_data_change listener: broadcast a LOCAL connector
        write to every peer. Folds of REMOTE bumps re-enter spi inside
        the same thread; the thread-local gate keeps them from
        re-broadcasting (no bump storms, no loops)."""
        if self._stopped.is_set():
            return
        if getattr(FleetMember._folding, "active", False):
            return
        cid = self._catalog_of(conn)
        if cid is None:
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
            peers = list(self._peers)
        try:
            dv = conn.data_version(table)
        except Exception:
            dv = None
        doc = {"origin": self.node_id, "seq": seq,
               "connectorId": cid, "table": table,
               "dataVersion": _jsonable(dv), "writeEpoch": seq}
        for peer in peers:
            try:
                FAILPOINTS.hit("fleet.broadcast",
                               key=f"{cid}/{table}@{peer}")
            except FailpointError:
                # armed drop: the peer never hears about this write —
                # its hit-time data_version revalidation is the net
                _BUMP_DROPPED.inc()
                continue
            try:
                _post_json(f"{peer}/v1/fleet/bump", doc,
                           self.post_timeout_s)
                _BUMP_BROADCAST.inc()
            except Exception:
                # a dead peer must not fail the local write; it will
                # revalidate (and be declared lost on the hb cadence)
                _PEER_POST_FAILURE.inc()

    # -- write bumps: fold side ----------------------------------------------
    def fold_bump(self, doc: dict) -> bool:
        """Fold one remote write bump into the local caches, through
        the SAME audited ``spi.notify_data_change`` path a local write
        takes — every registered cache listener runs its normal
        note_write (epoch bump) + invalidate sequence, so the
        epoch-before-deps veto protects in-flight local inserts against
        this remote write exactly as against a local one.

        Dedupe is per ``(origin, connector, table)`` on the origin's
        monotonic ``seq``; the high-water mark advances only AFTER the
        notify so a fold that dies is retried by the next bump, never
        recorded as delivered."""
        origin = str(doc.get("origin") or "")
        cid = str(doc.get("connectorId") or "")
        table = str(doc.get("table") or "")
        try:
            seq = int(doc.get("seq") or 0)
        except (TypeError, ValueError):
            return False
        if not origin or not cid or not table or origin == self.node_id:
            return False
        key = (origin, cid, table)
        with self._lock:
            if seq <= self._seen.get(key, 0):
                _BUMP_STALE.inc()
                return False
        cm = self._catalogs
        conn = None
        if cm is not None:
            try:
                conn = cm.get(cid)
            except KeyError:
                conn = None
        if conn is None:
            _BUMP_UNKNOWN.inc()
            return False
        FleetMember._folding.active = True
        try:
            spi.notify_data_change(conn, table)
        finally:
            FleetMember._folding.active = False
        with self._lock:
            if seq > self._seen.get(key, 0):
                self._seen[key] = seq
        _BUMP_FOLD.inc()
        return True

    # -- heartbeats ----------------------------------------------------------
    def _serving_counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in REGISTRY.snapshot():
            if _is_federated_serving(m["name"]):
                out[m["name"]] = m["value"]
        return out

    def heartbeat_once(self, leaving: bool = False) -> None:
        """Push this coordinator's per-group counts (and serving SLO
        counters) to every peer, then sweep for peers gone past the
        staleness grace."""
        groups = {}
        if self._manager is not None:
            groups = self._manager.group_counts()
        with self._lock:
            self._hb_seq += 1
            doc = {"origin": self.node_id, "hbSeq": self._hb_seq,
                   "leaving": bool(leaving), "groups": groups,
                   "serving": self._serving_counters(),
                   # self-identification makes peering dynamic: a
                   # scaled-up coordinator heartbeats its way into
                   # every member's peer list, and a leaving farewell
                   # prunes it back out (autoscaled coordinator tier)
                   "url": self.self_url,
                   "ts": time.time()}
            peers = list(self._peers)
        for peer in peers:
            try:
                _post_json(f"{peer}/v1/fleet/heartbeat", doc,
                           self.post_timeout_s)
                _HEARTBEAT.inc()
            except Exception:
                _PEER_POST_FAILURE.inc()
        self._sweep_lost()

    def _sweep_lost(self) -> None:
        """Declare peers lost (once each) when their last heartbeat
        ages past the grace; their federated counts stop binding
        admission at the same moment (remote_running skips stale
        snapshots), so a queued query blocked on a dead peer's slots
        needs one dispatch kick to proceed."""
        now = time.monotonic()
        kicked = False
        with self._lock:
            for origin, snap in list(self._remote.items()):
                if now - snap["t"] > self.staleness_grace_s \
                        and origin not in self._lost:
                    self._lost.add(origin)
                    # drop the corpse's per-group counts: the
                    # survivors absorb its admission share at the
                    # same instant the loss is declared
                    self._remote.pop(origin, None)
                    _COORDINATOR_LOST.inc()
                    kicked = True
        if kicked and self._manager is not None:
            self._manager._dispatch()

    def fold_heartbeat(self, doc: dict) -> bool:
        origin = str(doc.get("origin") or "")
        if not origin or origin == self.node_id:
            return False
        leaving = bool(doc.get("leaving"))
        url = str(doc.get("url") or "").rstrip("/")
        with self._lock:
            if leaving:
                # clean drain: counts drop immediately, and the member
                # is forgotten — NOT a loss. The EXPLICIT deregister
                # (vs waiting out the staleness grace): its url leaves
                # the peer list now, so no further broadcast/heartbeat
                # is ever addressed to the drained coordinator
                self._remote.pop(origin, None)
                self._lost.discard(origin)
                if url and url in self._peers:
                    self._peers.remove(url)
            else:
                self._remote[origin] = {
                    "t": time.monotonic(),
                    "groups": dict(doc.get("groups") or {})}
                self._lost.discard(origin)
                # dynamic peering: an autoscaled-up coordinator only
                # knows the incumbents — its first heartbeat teaches
                # each of them its url (docs without "url" — older
                # members, hand-built tests — change nothing)
                if url and url != self.self_url \
                        and url not in self._peers:
                    self._peers.append(url)
        if leaving and self._discovery is not None:
            # drop its coordinator record from the shared membership
            # immediately too (role="coordinator" entries never enter
            # worker scheduling, but status surfaces read them)
            self._discovery.remove(origin)
        _HEARTBEAT_FOLD.inc()
        # federate the peer's serving counters into the local store
        # (the record() path, origin-tagged like worker series):
        # any coordinator's SLO plane can aggregate fleet-wide traffic
        from ..obs.timeseries import TIMESERIES
        for name, v in (doc.get("serving") or {}).items():
            if isinstance(name, str) and _is_federated_serving(name):
                try:
                    TIMESERIES.record(f"{name}.{origin}", float(v),
                                      kind="counter")
                except (TypeError, ValueError):
                    pass
        # remote counts may have DECREASED — wake queued admissions
        if self._manager is not None:
            self._manager._dispatch()
        return True

    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_s):
            try:
                self.heartbeat_once()
            except Exception:
                pass

    # -- federation provider (resource_groups.can_run_more) ------------------
    def remote_running(self, path: str) -> int:
        """Sum of fresh remote running counts for one group path.
        Called under manager.lock — takes only the fleet lock (lock
        order manager.lock -> fleet.member; the fold side never calls
        back into the manager while holding the fleet lock)."""
        now = time.monotonic()
        total = 0
        with self._lock:
            for snap in self._remote.values():
                if now - snap["t"] > self.staleness_grace_s:
                    continue
                g = snap["groups"].get(path)
                if g:
                    total += int(g.get("running", 0) or 0)
        return total

    def remote_memory(self, path: str) -> int:
        now = time.monotonic()
        total = 0
        with self._lock:
            for snap in self._remote.values():
                if now - snap["t"] > self.staleness_grace_s:
                    continue
                g = snap["groups"].get(path)
                if g:
                    total += int(g.get("memory", 0) or 0)
        return total

    def note_remote_blocked(self) -> None:
        """Admission accounting hook: a query a coordinator-local view
        would have admitted was blocked by federated counts."""
        _REMOTE_BLOCKED.inc()

    # -- introspection -------------------------------------------------------
    def status(self) -> dict:
        now = time.monotonic()
        workers: List[str] = []
        if self._discovery is not None:
            try:
                workers = self._discovery.active_urls()
            except Exception:
                workers = []
        with self._lock:
            return {
                "nodeId": self.node_id,
                "url": self.self_url,
                "peers": list(self._peers),
                "workers": sorted(workers),
                "seq": self._seq,
                "heartbeatS": self.heartbeat_s,
                "stalenessGraceS": self.staleness_grace_s,
                "remote": {o: {"age_s": round(now - s["t"], 3),
                               "groups": s["groups"]}
                           for o, s in sorted(self._remote.items())},
                "lost": sorted(self._lost),
            }
