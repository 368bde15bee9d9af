"""Discovery: dynamic worker membership by announcement.

The counterpart of ``presto_tpu/exec/discovery.py`` (the role of the
reference's embedded discovery service and node manager,
metadata/DiscoveryNodeManager.java:68 tracking active workers from
announcements; server/EmbeddedDiscoveryConfig.java). Nodes POST
``/v1/announce`` to a coordinator on a heartbeat cadence; entries expire
after a TTL so vanished nodes drop out without explicit deregistration.
Host code only: membership holds no tensor.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Tuple


class DiscoveryNodeManager:
    """Coordinator-side registry of announced workers. Announcements
    carry the node's lifecycle state: a draining worker (graceful
    shutdown) re-announces as ``SHUTTING_DOWN`` so the scheduler stops
    assigning new tasks to it without waiting for the next ``/v1/info``
    heartbeat sweep."""

    def __init__(self, ttl_s: float = 15.0):
        self.ttl_s = ttl_s
        self._nodes: Dict[str, Tuple[str, float, str, str]] = {}
        self._lock = threading.Lock()

    def announce(self, node_id: str, url: str,
                 state: str = "ACTIVE", role: str = "worker") -> None:
        """Join/refresh membership — any time, mid-query included (the
        scheduler's next sweep sees the node and re-created tasks land
        on it). State ``GONE`` is an explicit leave: the node drops
        out immediately instead of waiting out the TTL. ``role``
        separates the planes sharing this registry: ``worker`` nodes
        enter task scheduling; ``coordinator`` peers (the serving
        fleet) are membership-only."""
        if state == "GONE":
            self.remove(node_id)
            return
        with self._lock:
            self._nodes[node_id] = (url, time.monotonic(),
                                    state or "ACTIVE",
                                    role or "worker")

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def active_urls(self) -> List[str]:
        """Fresh WORKER announcements, draining nodes included — they
        still serve their running tasks' buffers; ``states()`` is the
        scheduler's don't-assign filter. Coordinator-role peers never
        appear here: the scheduler must not ship tasks to a fleet
        frontend."""
        now = time.monotonic()
        with self._lock:
            return sorted(url
                          for url, seen, _, role in self._nodes.values()
                          if role == "worker"
                          and now - seen <= self.ttl_s)

    def peer_urls(self, self_url: str = "") -> List[str]:
        """Fresh coordinator-role peers (the serving fleet), excluding
        ``self_url`` — the fleet member's broadcast fan-out set when
        peers are discovered rather than configured."""
        now = time.monotonic()
        me = self_url.rstrip("/")
        with self._lock:
            return sorted(url
                          for url, seen, _, role in self._nodes.values()
                          if role == "coordinator"
                          and now - seen <= self.ttl_s
                          and url.rstrip("/") != me)

    def states(self) -> Dict[str, str]:
        """url -> last announced lifecycle state (workers only — the
        consumer is the scheduler's don't-assign filter)."""
        with self._lock:
            return {url: state
                    for url, _, state, role in self._nodes.values()
                    if role == "worker"}

    def nodes(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            return [{"nodeId": nid, "uri": url,
                     "age_s": round(now - seen, 3),
                     "state": state, "role": role,
                     "active": now - seen <= self.ttl_s}
                    for nid, (url, seen, state, role)
                    in sorted(self._nodes.items())]


class Announcer:
    """Worker-side announce loop (the airlift Announcer role).

    ``discovery_uri`` may be a single coordinator URI or a list: a
    worker in a multi-coordinator fleet announces to EVERY coordinator
    each beat, so all fleet members schedule over the same pool without
    any cross-coordinator membership relay. The list follows the fleet's
    membership: each beat first reads a coordinator's ``GET /v1/fleet``
    and adds its URL and peers, so a coordinator that joins after the
    worker started hears of it within a beat of its first fleet
    heartbeat, with no worker restart (a coordinator that is no fleet
    member answers 404 and adds nothing)."""

    def __init__(self, discovery_uri, node_id: str, self_url: str,
                 interval_s: float = 5.0, role: str = "worker"):
        uris = ([discovery_uri] if isinstance(discovery_uri, str)
                else list(discovery_uri))
        self.discovery_uris = [u.rstrip("/") for u in uris]
        # single-URI callers keep reading .discovery_uri
        self.discovery_uri = self.discovery_uris[0]
        self.node_id = node_id
        self.self_url = self_url
        self.interval_s = interval_s
        self.role = role
        self.state = "ACTIVE"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def set_state(self, state: str) -> None:
        """Change the announced lifecycle state and push it out
        immediately (a draining worker must not wait one announce
        interval before the scheduler stops feeding it)."""
        self.state = state
        self.announce_once()

    def announce_once(self) -> bool:
        body = json.dumps({"nodeId": self.node_id,
                           "uri": self.self_url,
                           "state": self.state,
                           "role": self.role}).encode()
        ok = False
        for uri in self.discovery_uris:
            req = urllib.request.Request(
                f"{uri}/v1/announce", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=5):
                    ok = True
            except Exception:
                # one dead coordinator must not stop the others from
                # hearing about this worker
                continue
        return ok

    def start(self) -> None:
        self.announce_once()
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and wait for a beat in flight to land."""
        self._stop.set()
        if self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    def deregister(self) -> None:
        """Explicit leave: stop the loop and push one final ``GONE``
        announcement so the coordinator drops this node now (elastic
        scale-in), not after the TTL. The loop is joined first: a beat
        still in flight would otherwise land after the ``GONE`` and
        announce the node back as ``ACTIVE``."""
        self.stop()
        self.state = "GONE"
        self.announce_once()

    def follow_once(self) -> None:
        """Add the fleet members the first answering coordinator lists
        (its own URL and its peers) to the announce list. The list is
        replaced, never mutated, so a concurrent announce iterates a
        whole one."""
        for uri in list(self.discovery_uris):
            try:
                with urllib.request.urlopen(f"{uri}/v1/fleet",
                                            timeout=2) as r:
                    doc = json.loads(r.read().decode("utf-8"))
            except Exception:
                # not a fleet member (404), or gone: ask the next one
                continue
            members = [doc.get("url") or ""] + list(doc.get("peers") or ())
            new = [m.rstrip("/") for m in members
                   if m and m.rstrip("/") not in self.discovery_uris]
            if new:
                self.discovery_uris = self.discovery_uris + new
            return

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.follow_once()
            self.announce_once()
