"""Coordinator-fleet launcher: N statement servers, one worker pool, each
a process of its own.

The counterpart of the JAX package's ``tools/fleet.py``. Every
coordinator is a full ``PrestoTpuServer`` over a ``ClusterRunner`` (its
own caches, resource groups and SLO plane) joined into a fleet with
``enable_fleet``. Workers announce to every coordinator, so the fleet
shares one worker pool through discovery while clients spread statements
across coordinators with ``client.FleetClient``. Every child runs its
tasks on ``--device`` (the GPU when none is named; it raises without
one). Coordinator caches are per process, so horizontal scale needs
real processes: this module is both the child entry point and the
parent-side launcher.

Child modes (one process each, tethered to stdin: EOF stops it)::

    python -m presto_tpu_torch._devtools.fleet --serve-coordinator \\
        --device cuda --port P --node-id c0 \\
        --peers http://127.0.0.1:P1,http://127.0.0.1:P2 --sf 0.01
    python -m presto_tpu_torch._devtools.fleet --serve-worker \\
        --device cuda --port P --coordinators http://127.0.0.1:P0,... \\
        --sf 0.01

Parent API::

    fleet = launch_fleet(n_coordinators=3, sf=0.01, workers=1,
                         device="cuda")
    fleet.urls                 # coordinator base URLs
    fleet.metrics(1)           # GET /v1/metrics of coordinator 1
    fleet.kill_coordinator(0)  # SIGKILL: chaos, no drain
    fleet.scale_up(reason)     # the autoscaler's coordinator_scaler
    fleet.stop()
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: the serving shape of the fleet's children (two weighted tenants, both
#: under an SLO), as the reference launcher's children use
_SLO_SPEC = {"latencyTargetMs": 2000, "latencyObjective": 0.95,
             "availabilityObjective": 0.99}
SERVING_GROUPS = {
    "rootGroups": [
        {"name": "serving", "hardConcurrencyLimit": 8,
         "maxQueued": 10_000,
         "subGroups": [
             {"name": "dash", "hardConcurrencyLimit": 8,
              "schedulingWeight": 2, "slo": dict(_SLO_SPEC)},
             {"name": "adhoc", "hardConcurrencyLimit": 8,
              "schedulingWeight": 1, "slo": dict(_SLO_SPEC)}]}],
    "selectors": [{"user": "dash-.*", "group": "serving.dash"},
                  {"group": "serving.adhoc"}]}


def _build_catalogs(sf: float, sqlite_path: Optional[str], device):
    from ..connectors.memory import MemoryConnector
    from ..connectors.spi import CatalogManager
    from ..connectors.system import SystemConnector
    from ..connectors.tpch import TpchConnector

    catalogs = CatalogManager()
    catalogs.register("tpch", TpchConnector(sf=sf))
    catalogs.register("memory", MemoryConnector())
    if sqlite_path:
        # the fleet's shared writable catalog: one database file, every
        # coordinator (and worker) a connection over it
        from ..connectors.sqlite import SqliteConnector
        catalogs.register("fleetdb", SqliteConnector(sqlite_path))
    catalogs.register("system", SystemConnector(catalogs, device=device))
    return catalogs


def _stdin_tether(cleanup) -> None:
    """Block until stdin's EOF (the parent stopped or died), then clean
    up and exit: an orphaned child stops instead of holding its device.
    The exit skips interpreter teardown, which daemon threads still
    inside torch or CUDA can turn into an abort (as ``server/worker.py``
    does after a drain)."""
    try:
        while sys.stdin.buffer.read(4096):
            pass
    except OSError:
        pass
    cleanup()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def serve_coordinator(args) -> None:
    from ..device import resolve_device
    from ..exec.cluster import ClusterRunner
    from ..exec.discovery import DiscoveryNodeManager
    from ..obs.timeseries import TIMESERIES
    from ..server.protocol import PrestoTpuServer

    device = resolve_device(args.device)
    catalogs = _build_catalogs(args.sf, args.sqlite, device)
    discovery = DiscoveryNodeManager()
    runner = ClusterRunner(catalogs=catalogs, discovery=discovery,
                           tpch_sf=args.sf, device=device)
    runner.session.properties.update({"plan_template_cache": True,
                                      "result_cache": True})
    groups = (json.loads(args.groups_json) if args.groups_json
              else SERVING_GROUPS)
    # dense sampling: fleet runs are short; the SLO timeline needs
    # windowed points per phase
    TIMESERIES.configure(sample_interval_s=0.2)
    srv = PrestoTpuServer(runner, port=args.port,
                          resource_groups=groups, discovery=discovery)
    srv.start()
    peers = [u.strip() for u in (args.peers or "").split(",")
             if u.strip()]
    srv.enable_fleet(args.node_id, peers=peers,
                     heartbeat_s=args.heartbeat_s,
                     staleness_grace_s=args.staleness_grace_s or None)
    print(json.dumps({"ok": True, "role": "coordinator",
                      "nodeId": args.node_id,
                      "url": f"http://127.0.0.1:{srv.port}"}),
          flush=True)

    def stop():
        srv.stop()
        runner.detector.stop()
    _stdin_tether(stop)


def serve_worker(args) -> None:
    from ..device import resolve_device
    from ..server.worker import WorkerServer

    device = resolve_device(args.device)
    catalogs = _build_catalogs(args.sf, args.sqlite, device)
    w = WorkerServer(catalogs=catalogs, port=args.port,
                     node_id=args.node_id or None, device=device)
    w.start()
    uris = [u.strip() for u in (args.coordinators or "").split(",")
            if u.strip()]
    # announce to every coordinator: one worker pool, fleet-wide; the
    # 1 s beat keeps membership fresh inside discovery's TTL, and the
    # announce list follows the fleet, so a coordinator added later
    # (add_coordinator, the autoscaler's scale_up) sees this worker
    w.start_announcing(uris, interval_s=1.0)
    print(json.dumps({"ok": True, "role": "worker",
                      "nodeId": w.node_id,
                      "url": f"http://127.0.0.1:{w.port}"}),
          flush=True)
    _stdin_tether(w.stop)


# -- parent side --------------------------------------------------------------

def _free_ports(n: int) -> List[int]:
    """Reserve n distinct ephemeral ports (bind, record, close). The
    window between the close and the child's bind is racy in principle;
    the kernel does not reissue a just-closed ephemeral port that soon."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


class FleetHandle:
    """A running fleet: the coordinator and worker subprocess records,
    the scrape and chaos surface, and the autoscaler's coordinator
    scaler (``scale_up`` / ``scale_down``)."""

    def __init__(self, coordinators: List[dict], workers: List[dict],
                 sqlite_path: Optional[str],
                 spawn_cfg: Optional[dict] = None):
        self.coordinators = coordinators   # {proc, url, node_id, port}
        self.workers = workers
        self.sqlite_path = sqlite_path
        #: launch parameters, kept so the coordinator tier can scale up
        #: after launch (the autoscaler's scale_coordinator decisions)
        self.spawn_cfg = dict(spawn_cfg or {})

    @property
    def urls(self) -> List[str]:
        return [c["url"] for c in self.coordinators]

    def live_urls(self) -> List[str]:
        return [c["url"] for c in self.coordinators
                if c["proc"].poll() is None]

    def metrics(self, i: int) -> Dict[str, float]:
        """Coordinator ``i``'s ``/v1/metrics`` back as the registry's
        dotted names (``fam{key="sub"}`` -> ``fam.sub``); samples with
        other labels (le, quantile, node) are dropped."""
        from ..obs.exposition import parse_exposition
        url = self.coordinators[i]["url"] + "/v1/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            text = r.read().decode("utf-8")
        samples, _types = parse_exposition(text)
        out: Dict[str, float] = {}
        for (name, labels), value in samples.items():
            labels = dict(labels)
            key = labels.pop("key", "")
            if labels:
                continue
            out[f"{name}.{key}" if key else name] = value
        return out

    def slo(self, i: int) -> dict:
        return _get_json(self.coordinators[i]["url"] + "/v1/slo")

    def fleet_status(self, i: int) -> dict:
        return _get_json(self.coordinators[i]["url"] + "/v1/fleet")

    def add_coordinator(self) -> dict:
        """Scale the coordinator tier up: spawn one more fleet member
        peered with the live coordinators. Its first heartbeat teaches
        every incumbent its URL, so it joins the fleet without a
        restart of anyone."""
        cfg = self.spawn_cfg
        # records stay listed after a kill or a drain: ids never repeat
        node_id = f"coord-{len(self.coordinators)}"
        (port,) = _free_ports(1)
        argv = ["--serve-coordinator", "--port", str(port),
                "--node-id", node_id,
                "--peers", ",".join(self.live_urls()),
                "--sf", str(cfg.get("sf", 0.01)),
                "--heartbeat-s", str(cfg.get("heartbeat_s", 0.5)),
                "--device", cfg["device"]]
        if self.sqlite_path:
            argv += ["--sqlite", self.sqlite_path]
        if cfg.get("staleness_grace_s"):
            argv += ["--staleness-grace-s",
                     str(cfg["staleness_grace_s"])]
        if cfg.get("groups"):
            argv += ["--groups-json", json.dumps(cfg["groups"])]
        rec = {"proc": _spawn(argv), "node_id": node_id, "port": port,
               "url": f"http://127.0.0.1:{port}"}
        try:
            _await_ready(rec, cfg.get("ready_timeout_s", 300.0))
        except BaseException:
            _reap(rec["proc"])
            raise
        self.coordinators.append(rec)
        return rec

    def drain_coordinator(self, i: int, timeout_s: float = 60.0) -> bool:
        """Scale the coordinator tier down the polite way: ``PUT
        /v1/info/state SHUTTING_DOWN`` (the member's ``leaving``
        farewell drops its federated counts and its peer entry at once),
        running queries page out, then the process exits. Never a
        kill."""
        rec = self.coordinators[i]
        p = rec["proc"]
        if p.poll() is not None:
            return False
        req = urllib.request.Request(
            rec["url"] + "/v1/info/state", data=b'"SHUTTING_DOWN"',
            method="PUT", headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                r.read()
        except OSError:
            return False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                _get_json(rec["url"] + "/v1/info", timeout=2)
            except urllib.error.HTTPError:
                pass
            except OSError:
                break                  # socket refused: drained
            time.sleep(0.1)
        if p.stdin:
            try:
                p.stdin.close()
            except OSError:
                pass
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            return False
        return True

    # -- the autoscaler's coordinator_scaler (exec/autoscale.py) -------------
    def scale_up(self, reason: str = "") -> bool:
        """Admission-bound: one more coordinator is one more set of
        hard-concurrency slots over the same worker pool."""
        self.add_coordinator()
        return True

    def scale_down(self, reason: str = "") -> bool:
        live = [i for i, c in enumerate(self.coordinators)
                if c["proc"].poll() is None]
        if len(live) <= 2:             # a fleet needs >= 2 members
            return False
        return self.drain_coordinator(live[-1])

    def kill_coordinator(self, i: int) -> None:
        """SIGKILL, the chaos primitive: no drain, no farewell; peers
        learn through the staleness grace, clients through transport
        errors (``FleetClient`` fails over)."""
        p = self.coordinators[i]["proc"]
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)

    def stop(self) -> None:
        procs = ([c["proc"] for c in self.coordinators]
                 + [w["proc"] for w in self.workers])
        for p in procs:
            if p.poll() is None and p.stdin:
                try:
                    p.stdin.close()   # tether EOF: the child stops
                except OSError:
                    pass
        deadline = time.monotonic() + 20
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1,
                                       deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
            for f in (p.stdin, p.stdout):
                if f is not None:
                    f.close()


def _spawn(argv: List[str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch._devtools.fleet"] + argv,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, cwd=_REPO_ROOT,
        start_new_session=True)


def _reap(p: subprocess.Popen) -> None:
    if p.poll() is None:
        p.kill()
    p.wait(timeout=10)
    for f in (p.stdin, p.stdout):
        if f is not None:
            f.close()


def _await_ready(rec: dict, timeout_s: float) -> None:
    """Read the child's one-line ready document (printed after the torch
    import and the server's start), within ``timeout_s``. A thread reads
    it, so any thread may launch (the autoscaler's loop does)."""
    p = rec["proc"]
    line: List[bytes] = []
    t = threading.Thread(target=lambda: line.append(p.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    if not line:
        raise TimeoutError(
            f"fleet child {rec['node_id']} not ready in {timeout_s}s")
    if not line[0]:
        raise RuntimeError(
            f"fleet child {rec['node_id']} died before ready "
            f"(rc={p.poll()})")
    doc = json.loads(line[0])
    if not doc.get("ok"):
        raise RuntimeError(f"fleet child {rec['node_id']}: {doc}")
    rec["url"] = doc["url"]


def launch_fleet(n_coordinators: int = 3, sf: float = 0.01,
                 workers: int = 1, sqlite_path: Optional[str] = None,
                 heartbeat_s: float = 0.5,
                 staleness_grace_s: Optional[float] = None,
                 groups: Optional[dict] = None,
                 ready_timeout_s: float = 300.0,
                 device=None) -> FleetHandle:
    """Spawn the fleet: ``n_coordinators`` statement servers (each a
    fleet member, peered all to all) and ``workers`` worker processes
    announcing to every coordinator, all on ``device`` (the GPU when
    none is named; raises without one). Blocks until every child printed
    its ready line and every coordinator sees every worker."""
    from ..device import resolve_device
    device = str(resolve_device(device))
    if n_coordinators < 2:
        raise ValueError("a fleet needs >= 2 coordinators")
    ports = _free_ports(n_coordinators + workers)
    coord_ports = ports[:n_coordinators]
    urls = [f"http://127.0.0.1:{p}" for p in coord_ports]
    coords: List[dict] = []
    wrecs: List[dict] = []
    handle = FleetHandle(
        coords, wrecs, sqlite_path,
        spawn_cfg={"sf": sf, "heartbeat_s": heartbeat_s,
                   "staleness_grace_s": staleness_grace_s,
                   "groups": groups, "device": device,
                   "ready_timeout_s": ready_timeout_s})
    try:
        for i, port in enumerate(coord_ports):
            node_id = f"coord-{i}"
            peers = ",".join(u for j, u in enumerate(urls) if j != i)
            argv = ["--serve-coordinator", "--port", str(port),
                    "--node-id", node_id, "--peers", peers,
                    "--sf", str(sf), "--heartbeat-s", str(heartbeat_s),
                    "--device", device]
            if sqlite_path:
                argv += ["--sqlite", sqlite_path]
            if staleness_grace_s:
                argv += ["--staleness-grace-s", str(staleness_grace_s)]
            if groups:
                argv += ["--groups-json", json.dumps(groups)]
            coords.append({"proc": _spawn(argv), "node_id": node_id,
                           "port": port, "url": urls[i]})
        for i, port in enumerate(ports[n_coordinators:]):
            node_id = f"fleet-worker-{i}"
            argv = ["--serve-worker", "--port", str(port),
                    "--node-id", node_id,
                    "--coordinators", ",".join(urls), "--sf", str(sf),
                    "--device", device]
            if sqlite_path:
                argv += ["--sqlite", sqlite_path]
            wrecs.append({"proc": _spawn(argv), "node_id": node_id,
                          "port": port,
                          "url": f"http://127.0.0.1:{port}"})
        for rec in coords + wrecs:
            _await_ready(rec, ready_timeout_s)
        # a coordinator that sees no worker fails SELECTs: hold the
        # ready barrier until every coordinator sees the whole pool
        deadline = time.monotonic() + ready_timeout_s
        for i in range(len(coords)):
            while True:
                seen = len(handle.fleet_status(i).get("workers", ()))
                if seen >= workers:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"coordinator {coords[i]['node_id']} sees "
                        f"{seen}/{workers} workers")
                time.sleep(0.1)
    except BaseException:
        handle.stop()
        raise
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="presto_tpu_torch._devtools.fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--serve-coordinator", action="store_true")
    ap.add_argument("--serve-worker", action="store_true")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--node-id", default="")
    ap.add_argument("--peers", default="")
    ap.add_argument("--coordinators", default="")
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--sqlite", default="")
    ap.add_argument("--heartbeat-s", type=float, default=0.5)
    ap.add_argument("--staleness-grace-s", type=float, default=0.0)
    ap.add_argument("--groups-json", default="")
    ap.add_argument("--device", default=None,
                    help="torch device of the child (default: the GPU, "
                         "which must exist; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.serve_coordinator:
        serve_coordinator(args)
        return 0
    if args.serve_worker:
        serve_worker(args)
        return 0
    ap.error("pick one of --serve-coordinator / --serve-worker")
    return 2


if __name__ == "__main__":
    sys.exit(main())
