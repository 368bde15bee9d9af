"""Session-property registry and config-directory boot of the port.

The counterpart of ``presto_tpu/config.py``:

- the session-property registry (the reference's
  SystemSessionProperties.java role): one declaration per session
  property that the port's code reads, with its type, default and
  meaning. ``SET SESSION`` on an unknown or mistyped name raises instead
  of storing a value no code will ever read;
- the config directory (the reference's airlift bootstrap config binding,
  server/PrestoServer.java:86, and StaticCatalogStore loading
  etc/catalog/*.properties through the ConnectorFactory named by
  ``connector.name``)::

      etc/
        config.properties        node.id, coordinator, http-server.http.port,
                                 cache and sampler sizes, failpoints,
                                 plugin.modules / plugin.dir, session
                                 defaults (session.<name>=<value>)
        catalog/
          tpch.properties        connector.name=tpch
                                 tpch.scale-factor=1
          warehouse.properties   connector.name=orc
                                 orc.root=/data/warehouse
        resource-groups.json     root groups and selectors

  ``server_from_etc`` boots a statement server from it on a device (the
  GPU unless one is named), and a worker (``server/worker.py
  --etc-dir``) boots from the same loaders. ``NodeConfig`` parses every
  key the JAX package parses, so one etc directory boots both packages.
  ``spool.*`` configures the exchange spool (``configure_spool``);
  ``autoscale.enabled=true`` attaches and starts an
  ``exec/autoscale.AutoscaleController`` over subprocess workers on the
  boot's device (``autoscale.*`` sets its policy).

Environment defaults (read where the property is resolved, when the
session leaves it unset): ``PRESTO_TPU_TORCH_MESH_EXECUTION`` for
``mesh_execution`` and ``PRESTO_TPU_TORCH_MESH_FLIGHT`` for
``mesh_flight`` (``exec/distributed.py``); ``PRESTO_TPU_TORCH_MESH_SLOTS``
sets the mesh slots per visible device (``parallel/mesh.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SessionProperty:
    name: str
    type: str           # boolean | integer | double | varchar
    default: object     # documentation only; read sites supply defaults
    doc: str
    #: canonicalizes (or rejects) an already type-coerced value
    validator: Optional[Callable] = None


class SessionPropertyError(ValueError):
    """User-facing SET SESSION rejection (unknown name / bad type)."""

    name = "INVALID_SESSION_PROPERTY"


SESSION_PROPERTIES: Dict[str, SessionProperty] = {}


def _sp(name: str, type_: str, default, doc: str,
        validator: Optional[Callable] = None) -> None:
    SESSION_PROPERTIES[name] = SessionProperty(name, type_, default, doc,
                                               validator)


def _valid_retry_policy(v):
    p = str(v).upper()
    if p not in ("TASK", "QUERY", "NONE"):
        raise SessionPropertyError(
            f"retry_policy must be TASK, QUERY or NONE, got {v!r}")
    return p


def _valid_duration(v):
    from .exec.cluster import parse_duration_s
    try:
        parse_duration_s(v)
    except ValueError as e:
        raise SessionPropertyError(str(e)) from None
    return v


_sp("broadcast_join_row_limit", "integer", 4_000_000,
    "build sides at or under this many estimated rows broadcast; "
    "larger ones hash-partition")
_sp("cluster_memory_limit", "integer", None,
    "cluster-wide reservation cap in bytes; the coordinator memory "
    "manager kills the largest query above it")
_sp("dense_grouping", "boolean", True,
    "allow the stats-bounded dense (scatter-path) GROUP BY plan")
_sp("enable_dynamic_filtering", "boolean", True,
    "build-side key bounds filter the probe side at runtime")
_sp("exchange_failure_timeout_s", "double", 45.0,
    "seconds an exchange client retries transport loss before failing "
    "the upstream task")
_sp("fair_scheduling", "boolean", True,
    "time-slice concurrent queries through the device scheduler")
_sp("fused_compact_floor", "integer", 1 << 17,
    "skip fused-chain compaction below this batch capacity")
_sp("fused_compact_window", "integer", 4,
    "fused-chain liveness readbacks amortize over this many batches")
_sp("fused_pipeline", "boolean", True,
    "run chains of unique-build inner/left joins (with the filters and "
    "projections between them) as one head/tail program pair "
    "(exec/fused.py)")
_sp("grouped_execution", "boolean", True,
    "run a join of two tables co-partitioned on its keys one partition "
    "(lifespan) at a time")
_sp("join_dense_path", "boolean", True,
    "stats-driven dense-key direct-address join builds")
_sp("join_pallas_probe", "boolean", True,
    "accepted for the JAX package's sessions, where it chooses between "
    "its fused Pallas probe and a plain XLA gather; it changes no row. "
    "The port's unique-build probe is always the CUDA kernel on the GPU "
    "(csrc/probe.cu) and its plain version on the CPU, whatever the "
    "value")


def _valid_mesh_execution(v):
    m = str(v).lower()
    if m not in ("auto", "on", "off"):
        raise SessionPropertyError(
            f"mesh_execution must be auto, on or off, got {v!r}")
    return m


_sp("mesh_execution", "varchar", "auto",
    "SPMD execution on a mesh of device slots: auto runs SQL on the "
    "mesh whenever more than one slot is visible and the plan "
    "fragments into mesh stages, on forces it, off pins the "
    "single-device path (PRESTO_TPU_TORCH_MESH_EXECUTION overrides the "
    "unset default)", _valid_mesh_execution)
_sp("mesh_devices", "integer", 0,
    "slots in the execution mesh (0 = every visible slot); 1 behaves "
    "like mesh_execution=off under auto")
def _valid_fused_exchange(v):
    if isinstance(v, bool):
        return v
    m = str(v).strip().lower()
    if m == "auto":
        return m
    if m in _TRUE + _FALSE:
        return m in _TRUE
    raise SessionPropertyError(
        f"mesh_fused_exchange must be auto, true or false, got {v!r}")


_sp("mesh_fused_exchange", "varchar", "auto",
    "fused SPMD exchange (exec/distributed.py): compute + bucket-count "
    "+ ship collapse into one program per round, stats-bounded "
    "aggregation stages run several rounds in one dispatch, and "
    "control scalars are fetched once per stage; false is the "
    "per-round host control plane. auto (the default) is true except "
    "for the hash exchange's ship when slots share a device, which "
    "takes the counted plane there (the fused quota would hold n^2 x C "
    "lanes on the shared device); true forces the fused ship",
    _valid_fused_exchange)
_sp("mesh_fused_loop_rounds", "integer", 32,
    "cap on chunks one fused aggregation wave may take (bounds resident "
    "memory: the wave holds every chunk on the device at once); "
    "minimum 1")
_sp("mesh_flight", "boolean", True,
    "mesh flight recorder (obs/flight.py): record every round of a "
    "mesh-path query (dispatch, staging, control sync, repartition, "
    "stall) for the post-query wall-clock attribution surfaced in "
    "EXPLAIN ANALYZE, system.runtime.mesh_rounds and the mesh_attr_* "
    "metric families; off skips recording entirely "
    "(PRESTO_TPU_TORCH_MESH_FLIGHT overrides the unset default)")
_sp("plan_template_cache", "boolean", False,
    "fingerprint the PARAMETERIZED statement shape (literals "
    "hole-punched) so a fleet of bindings shares one optimized plan; "
    "optimizer decisions that consulted a literal record equality "
    "guards and fall back to per-binding fingerprints when a binding "
    "flips them (serving/template.py)")
_sp("plan_cache", "boolean", True,
    "serve repeated statements from the compiled-plan cache "
    "(fingerprinted bound AST; skips parse/plan/optimize)")
_sp("probe_prefetch", "boolean", True,
    "run a join's probe side on a producer thread while its build side "
    "drains")
_sp("profile", "boolean", False,
    "time each operator's frames and each kernel launch on the device "
    "(obs/profiler.py; always on under EXPLAIN ANALYZE)")
_sp("push_partial_aggregation_through_join", "boolean", True,
    "eager aggregation below joins when the grouping key covers the "
    "probe join key")
_sp("query_max_memory", "integer", None,
    "per-query memory pool limit in bytes (join builds, aggregation "
    "states and sorts spill beyond it)")

_sp("query_max_run_time", "duration", None,
    "wall-clock deadline (e.g. 30s, 500ms); the query aborts past it",
    _valid_duration)
_sp("query_queued_timeout", "duration", None,
    "admission deadline (e.g. 5s): a statement still queued in its "
    "resource group past it fails with QUERY_QUEUED_TIMEOUT "
    "(server/protocol.py)", _valid_duration)
_sp("query_retry_attempts", "integer", 1,
    "whole-query re-runs under retry_policy=QUERY")
_sp("result_cache", "boolean", False,
    "serve repeated statements from the versioned result cache "
    "(serving/resultcache.py): stored host rows when every scanned "
    "table's data_version matches, changed-split delta recompute + "
    "distributive merge when a file table grew append-only")
_sp("retry_policy", "varchar", "TASK",
    "fault-tolerance mode: TASK, QUERY or NONE", _valid_retry_policy)
_sp("role", "varchar", None,
    "active role for access-control checks (SET ROLE)")
_sp("scan_cache", "boolean", True,
    "serve repeated scans from the device-resident scan cache")
_sp("scan_pad_batches", "boolean", True,
    "pad ragged final split chunks to the stream's capacity bucket")
_sp("scan_prefetch", "boolean", True,
    "generate and stage splits on background threads ahead of the "
    "consumer")
_sp("scan_prefetch_depth", "integer", 4,
    "buffered batches per split in the prefetch pipeline")
_sp("scan_threads", "integer", 2,
    "background scan threads per table scan (and splits asked for)")
_sp("shared_scan", "boolean", True,
    "attach concurrent identical-split scan misses to one in-flight "
    "decode instead of racing duplicates")
_sp("speculative_execution", "boolean", True,
    "duplicate straggler tasks on another node, first finished wins")
_sp("speculative_spool_reads", "boolean", True,
    "on an exchange transport failure with a committed spool copy, "
    "race the spool replay against a resumed live pull (first "
    "complete remainder wins, loser cancelled) instead of committing "
    "to the replay")
_sp("spill_partitions", "integer", 16,
    "hash partitions of spilled join builds and aggregation states")
_sp("spool_exchange", "boolean", True,
    "write exchange pages through to the durable page-addressed spool "
    "under retry_policy=TASK (false keeps acked pages in the workers' "
    "memory instead)")
_sp("spill_path", "varchar", None,
    "directory for second-tier disk spill pages")
_sp("spill_to_disk_bytes", "integer", 4 << 30,
    "host bytes staged by a query's spill stores before they flush "
    "compressed pages to disk")
_sp("stats_bounded_grouping", "boolean", True,
    "attach hard per-key bounds from connector stats to aggregations")
_sp("task_concurrency", "integer", 1,
    "driver threads running a grouped aggregation's partial step")
_sp("task_retry_attempts", "integer", 2,
    "per-task retry budget under retry_policy=TASK")
_sp("task_retry_backoff_s", "double", 0.05,
    "base backoff between task retry attempts (exponential)")

_TRUE = ("true", "1", "on", "yes")
_FALSE = ("false", "0", "off", "no")


def validate_session_property(name: str, value):
    """Coerced canonical value for ``SET SESSION name = value``; raises
    :class:`SessionPropertyError` on an unknown name or a value that does
    not parse as the declared type."""
    sp = SESSION_PROPERTIES.get(name)
    if sp is None:
        raise SessionPropertyError(
            f"unknown session property {name!r} "
            f"(known: {', '.join(sorted(SESSION_PROPERTIES))})")

    def bad():
        return SessionPropertyError(
            f"session property {name!r} expects a {sp.type}, "
            f"got {value!r}")

    out = value
    if sp.type == "boolean":
        if isinstance(value, bool):
            out = value
        elif isinstance(value, str) \
                and value.strip().lower() in _TRUE + _FALSE:
            out = value.strip().lower() in _TRUE
        else:
            raise bad()
    elif sp.type in ("integer", "double"):
        cast = int if sp.type == "integer" else float
        accepted = (int, str) if sp.type == "integer" else (int, float, str)
        if isinstance(value, bool) or not isinstance(value, accepted):
            raise bad()
        try:
            out = cast(value.strip() if isinstance(value, str) else value)
        except (TypeError, ValueError):
            raise bad() from None
    elif sp.type == "varchar" and not isinstance(value, str) \
            and not (isinstance(value, bool) and sp.validator is not None):
        # a validated varchar may also take booleans (mesh_fused_exchange)
        raise bad()
    if sp.validator is not None:
        out = sp.validator(out)
    return out


# -- node config (config.properties) ------------------------------------------
#: every key the port reads from a parsed ``*.properties`` file
#: (config.properties, catalog/*.properties): the declarations the
#: static analyzer (``_devtools/analyze/registries.py``) resolves each
#: read against; a ``*`` entry covers a family of keys
CONFIG_KEYS: Dict[str, str] = {
    "node.id": "stable node identity (defaults to worker-<port>)",
    "coordinator": "true/false: run the coordinator role",
    "http-server.http.port": "statement/worker HTTP port (0 = ephemeral)",
    "discovery.uri": "coordinator discovery endpoint workers announce to",
    "session.catalog": "default catalog for new sessions",
    "session.schema": "default schema for new sessions",
    "session.*": "session-property defaults (validated against "
                 "SESSION_PROPERTIES at boot)",
    "scan-cache.max-bytes": "device scan-cache resident limit per device "
                            "(exec/scancache.py)",
    "result-cache.max-bytes": "result-cache host-row budget "
                              "(serving/resultcache.py; default 256 MiB)",
    "timeseries.sample-interval-s": "time-series sampler cadence in "
                                    "seconds (obs/timeseries.py; "
                                    "default 5)",
    "timeseries.retention-points": "bounded ring size per series "
                                   "(default 360 = 30 min at the "
                                   "default cadence)",
    "spool.dir": "exchange spool directory (exec/spool.py); point every "
                 "node at shared storage for cross-node replay",
    "spool.max-bytes": "spool disk budget (default 4 GiB)",
    "spool.backend": "local (append-only page logs, the default) or "
                     "object (the content-addressed emulated bucket)",
    "spool.object.*": "object-backend bucket directory and its modeled "
                      "put/get latency and bandwidth",
    "autoscale.*": "the autoscaling coordinator: enabled, min-workers, "
                   "max-workers, scale-step, cooldown-s, interval-s",
    "failpoints": "deterministic fault-injection spec "
                  "(exec/failpoints.py grammar)",
    "connector.name": "catalog properties: which connector factory",
    "tpch.scale-factor": "tpch catalog scale factor",
    "tpcds.scale-factor": "tpcds catalog scale factor",
    "orc.root": "orc catalog data directory",
    "parquet.root": "parquet catalog data directory",
    "sqlite.path": "sqlite catalog database file",
    "path": "sqlite catalog database file (the older alias)",
    "plugin.modules": "comma-separated plugin modules to import",
    "plugin.dir": "directory of plugin modules to load",
}

#: the node-config keys that size the process-wide caches and the
#: time-series sampler (``apply_node_config``; ``NodeConfig`` parses the
#: rest)
NODE_CONFIG_KEYS: Dict[str, str] = {
    k: CONFIG_KEYS[k] for k in (
        "scan-cache.max-bytes", "result-cache.max-bytes",
        "timeseries.sample-interval-s", "timeseries.retention-points")}

#: every environment variable the port (or its chip script) reads: the
#: same two-way contract as the other string-keyed registries: each
#: ``PRESTO_TPU_TORCH_*`` read must resolve to an entry here, each entry
#: must be read somewhere, and the table in docs/torch_static_analysis.md
#: round-trips both ways
ENV_VARS: Dict[str, str] = {
    "PRESTO_TPU_TORCH_LOCKCHECK": "force the runtime lock-order "
                                  "validator on/off (default: on under "
                                  "pytest only)",
    "PRESTO_TPU_TORCH_LOG": "structured JSON-lines log destination "
                            "(obs/log.py; empty = disabled)",
    "PRESTO_TPU_TORCH_TRACE": "enable the span tracer outside explicit "
                              "--trace-out runs (obs/trace.py)",
    "PRESTO_TPU_TORCH_MESH_EXECUTION": "environment default of the "
                                       "mesh_execution session property "
                                       "(auto/on/off)",
    "PRESTO_TPU_TORCH_MESH_FLIGHT": "environment default of the "
                                    "mesh_flight session property "
                                    "(on/off; default on)",
    "PRESTO_TPU_TORCH_MESH_SLOTS": "see every visible device as N mesh "
                                   "slots (read at each routing "
                                   "decision)",
    "PRESTO_TPU_TORCH_FAILPOINTS": "failpoint arming spec applied at "
                                   "import (exec/failpoints.py grammar)",
    "PRESTO_TPU_TORCH_DEVICE_FLOOR_MS": "modeled per-quantum and "
                                        "per-scanned-batch device floor "
                                        "in ms (exec/taskexec.py; 0 = "
                                        "off): the load ramp's "
                                        "fixed-throughput device model",
    "PRESTO_TPU_TORCH_TIMESERIES": "set to 'off' to disable the "
                                   "background health-plane sampler "
                                   "(obs/timeseries.py)",
    "SERVING_INLINE_LANE": "set to 0 to disable the statement POST "
                           "inline lane; default on",
    "ELASTIC_OUT": "write the chaos drills' recovery-time summary here "
                   "(_devtools/chaos.py)",
}


def apply_node_config(props: Dict[str, str]) -> None:
    """Apply a parsed ``config.properties`` dict's cache and time-series
    keys to the process-wide scan cache, result cache and time-series
    store, as the JAX package's ``server_from_etc`` does at boot; an
    absent key keeps the built-in default."""
    raw = props.get("scan-cache.max-bytes")
    if raw:
        from .exec.scancache import CACHE
        CACHE.set_limit(int(raw))
    raw = props.get("result-cache.max-bytes")
    if raw:
        from .serving.resultcache import RESULTS
        RESULTS.set_limit(int(raw))
    raw_ts = props.get("timeseries.sample-interval-s")
    raw_tr = props.get("timeseries.retention-points")
    if raw_ts or raw_tr:
        from .obs.timeseries import TIMESERIES
        TIMESERIES.configure(
            sample_interval_s=float(raw_ts) if raw_ts else None,
            retention_points=int(raw_tr) if raw_tr else None)


def parse_properties(path: str) -> Dict[str, str]:
    """key=value lines; '#' comments; whitespace-tolerant (the reference
    uses java.util.Properties semantics)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"{path}: malformed line {line!r}")
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


# -- connector factory registry (the Plugin/ConnectorFactory role) ----------

def _tpch_factory(props):
    from .connectors.tpch import TpchConnector
    return TpchConnector(sf=float(props.get("tpch.scale-factor", "1")))


def _tpcds_factory(props):
    from .connectors.tpcds import TpcdsConnector
    return TpcdsConnector(sf=float(props.get("tpcds.scale-factor", "1")))


def _memory_factory(props):
    from .connectors.memory import MemoryConnector
    return MemoryConnector()


def _orc_factory(props):
    from .connectors.orc import OrcConnector
    return OrcConnector(props["orc.root"])


def _parquet_factory(props):
    from .connectors.parquet import ParquetConnector
    return ParquetConnector(props["parquet.root"])


def _sqlite_factory(props):
    from .connectors.sqlite import connector_factory
    return connector_factory(props)


CONNECTOR_FACTORIES: Dict[str, Callable] = {
    "tpch": _tpch_factory,
    "tpcds": _tpcds_factory,
    "memory": _memory_factory,
    "orc": _orc_factory,
    "parquet": _parquet_factory,
    "sqlite": _sqlite_factory,
}


def register_connector_factory(name: str, factory: Callable) -> None:
    """Third-party connector registration (the Plugin.getConnectorFactories
    surface)."""
    CONNECTOR_FACTORIES[name] = factory


def load_catalogs(etc_dir: str, catalogs=None, device=None):
    """etc/catalog/*.properties -> mounted connectors (reference
    StaticCatalogStore.loadCatalogs), then the ``system`` catalog over
    them, made for ``device`` (the GPU when none is named: it lists that
    device as the node). Connectors take their device per scan."""
    from .connectors.spi import CatalogManager
    from .connectors.system import SystemConnector
    catalogs = catalogs if catalogs is not None else CatalogManager()
    cat_dir = os.path.join(etc_dir, "catalog")
    if os.path.isdir(cat_dir):
        for entry in sorted(os.listdir(cat_dir)):
            if not entry.endswith(".properties"):
                continue
            props = parse_properties(os.path.join(cat_dir, entry))
            name = entry[:-len(".properties")]
            kind = props.get("connector.name")
            if kind is None:
                raise ValueError(f"{entry}: missing connector.name")
            factory = CONNECTOR_FACTORIES.get(kind)
            if factory is None:
                raise ValueError(
                    f"{entry}: unknown connector.name {kind!r} "
                    f"(registered: {sorted(CONNECTOR_FACTORIES)})")
            catalogs.register(name, factory(props))
    if "system" not in catalogs.names():
        catalogs.register("system", SystemConnector(catalogs, device=device))
    return catalogs


def _opt(props: Dict[str, str], key: str, cast, default=None):
    raw = props.get(key)
    return cast(raw) if raw else default


class NodeConfig:
    """Parsed etc/config.properties (reference ServerConfig, NodeConfig
    and the session-default slice of SystemSessionProperties). Every key
    of the JAX package's ``NodeConfig`` is parsed; the ``spool.*`` block
    goes to ``configure_spool``, and the ``autoscale.*`` block to the
    controller ``server_from_etc`` attaches."""

    def __init__(self, props: Dict[str, str]):
        self.props = props
        self.node_id: Optional[str] = props.get("node.id")
        self.coordinator = props.get("coordinator", "true") \
            .lower() == "true"
        self.http_port = int(props.get("http-server.http.port", "0"))
        self.discovery_uri = props.get("discovery.uri")
        self.catalog = props.get("session.catalog", "tpch")
        self.schema = props.get("session.schema", "default")
        #: process-wide device scan-cache resident limit
        #: (exec/scancache.py); None keeps the built-in default
        self.scan_cache_bytes = _opt(props, "scan-cache.max-bytes", int)
        #: process-wide result-cache host-row budget
        #: (serving/resultcache.py); None keeps the built-in default
        self.result_cache_bytes = _opt(props, "result-cache.max-bytes", int)
        #: exchange-spool backend config (exec/spool.py SPOOL)
        self.spool_dir = props.get("spool.dir")
        self.spool_max_bytes = _opt(props, "spool.max-bytes", int)
        self.spool_backend = props.get("spool.backend")
        self.spool_object_dir = props.get("spool.object.dir")
        put = _opt(props, "spool.object.put-latency-ms", float)
        self.spool_object_put_latency_s = \
            put / 1e3 if put is not None else None
        get = _opt(props, "spool.object.get-latency-ms", float)
        self.spool_object_get_latency_s = \
            get / 1e3 if get is not None else None
        self.spool_object_bandwidth_mbps = _opt(
            props, "spool.object.bandwidth-mbps", float)
        #: elasticity control loop (the JAX package's exec/autoscale.py)
        self.autoscale_enabled = props.get(
            "autoscale.enabled", "false").lower() == "true"
        self.autoscale_min_workers = _opt(
            props, "autoscale.min-workers", int, 1)
        self.autoscale_max_workers = _opt(
            props, "autoscale.max-workers", int, 8)
        self.autoscale_scale_step = _opt(
            props, "autoscale.scale-step", int, 1)
        self.autoscale_cooldown_s = _opt(
            props, "autoscale.cooldown-s", float, 30.0)
        self.autoscale_interval_s = _opt(
            props, "autoscale.interval-s", float, 5.0)
        #: deterministic fault-injection spec (exec/failpoints.py
        #: grammar, ';'-separated)
        self.failpoints = props.get("failpoints")
        #: health-plane sampler cadence / per-series ring size
        #: (obs/timeseries.py); None keeps the built-in defaults
        self.timeseries_interval_s = _opt(
            props, "timeseries.sample-interval-s", float)
        self.timeseries_retention = _opt(
            props, "timeseries.retention-points", int)
        #: session property defaults: session.<name>=<value>
        self.session_defaults = {
            k[len("session."):]: v for k, v in props.items()
            if k.startswith("session.")
            and k not in ("session.catalog", "session.schema")}


def load_node_config(etc_dir: str) -> NodeConfig:
    path = os.path.join(etc_dir, "config.properties")
    return NodeConfig(parse_properties(path) if os.path.isfile(path)
                      else {})


def load_resource_groups(etc_dir: str):
    """etc/resource-groups.json -> ResourceGroupManager config dict (the
    file-backed half of the reference's
    FileResourceGroupConfigurationManager; selectors and limits keep this
    engine's JSON shape). None when the file is absent."""
    path = os.path.join(etc_dir, "resource-groups.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def configure_spool(cfg: NodeConfig,
                    directory: Optional[str] = None) -> None:
    """Apply a NodeConfig's ``spool.*`` block to the process-wide store
    (both the coordinator and the worker boot paths come here); a config
    without one leaves the store as it is."""
    if not (directory or cfg.spool_dir or cfg.spool_max_bytes is not None
            or cfg.spool_backend or cfg.spool_object_dir
            or cfg.spool_object_put_latency_s is not None
            or cfg.spool_object_get_latency_s is not None
            or cfg.spool_object_bandwidth_mbps is not None):
        return
    from .exec.spool import SPOOL
    SPOOL.configure(
        directory=directory or cfg.spool_dir,
        max_bytes=cfg.spool_max_bytes,
        backend=cfg.spool_backend,
        object_dir=cfg.spool_object_dir,
        object_put_latency_s=cfg.spool_object_put_latency_s,
        object_get_latency_s=cfg.spool_object_get_latency_s,
        object_bandwidth_mbps=cfg.spool_object_bandwidth_mbps)


def server_from_etc(etc_dir: str, host: str = "127.0.0.1",
                    port: Optional[int] = None, device=None):
    """Boot a statement server from a config directory, the
    PrestoServer.run analogue (reference server/PrestoServer.java:86:
    config binding, plugins, catalog store, resource groups). Its runner
    runs on ``device``: the GPU when none is named, and the boot raises
    without one. Returns ``(server, NodeConfig)``; the caller starts the
    server.

    With ``autoscale.enabled=true`` the server's ``autoscaler`` is a
    started ``AutoscaleController`` (policy from ``autoscale.*``) whose
    ``LocalProcessProvider`` launches workers on the same device from
    the same directory, and the runner is a ``ClusterRunner`` over the
    server's discovery, so the statements run on the workers the
    controller launches; the boot seats ``autoscale.min-workers`` of
    them. (The JAX package's boot keeps a ``LocalRunner`` there, which
    its autoscaled workers never serve.)"""
    from .device import resolve_device
    from .exec.runner import LocalRunner
    from .plugin import load_plugins_from_config
    from .server.protocol import PrestoTpuServer
    device = resolve_device(device)
    cfg = load_node_config(etc_dir)
    # plugins install connector factories / functions BEFORE catalogs
    # mount (reference PrestoServer.run: loadPlugins then catalog store)
    load_plugins_from_config(cfg.props)
    catalogs = load_catalogs(etc_dir, device=device)
    apply_node_config(cfg.props)
    configure_spool(cfg)
    if cfg.failpoints:
        from .exec.failpoints import FAILPOINTS
        FAILPOINTS.configure_from_spec(cfg.failpoints)
    discovery = None
    if cfg.autoscale_enabled:
        from .exec.cluster import ClusterRunner
        from .exec.discovery import DiscoveryNodeManager
        discovery = DiscoveryNodeManager()
        runner = ClusterRunner(catalogs=catalogs, catalog=cfg.catalog,
                               schema=cfg.schema, device=device,
                               discovery=discovery)
    else:
        runner = LocalRunner(catalogs=catalogs, catalog=cfg.catalog,
                             schema=cfg.schema, device=device)
    # session.<name> defaults go through the same registry gate as SET
    # SESSION: a typo'd default fails the boot, not a dashboard
    runner.session.properties.update(
        {k: validate_session_property(k, v)
         for k, v in cfg.session_defaults.items()})
    srv = PrestoTpuServer(
        runner=runner, host=host,
        port=cfg.http_port if port is None else port,
        resource_groups=load_resource_groups(etc_dir), discovery=discovery)
    if cfg.autoscale_enabled:
        # close the elasticity loop: signals feed -> rules -> subprocess
        # workers on the boot's device, announcing back to this
        # coordinator. The loop starts now (harmless before the server
        # does) and stops with the server (PrestoTpuServer.stop)
        from .exec.autoscale import (AutoscaleController, AutoscalePolicy,
                                     LocalProcessProvider)
        policy = AutoscalePolicy(
            min_workers=cfg.autoscale_min_workers,
            max_workers=cfg.autoscale_max_workers,
            scale_step=cfg.autoscale_scale_step,
            cooldown_s=cfg.autoscale_cooldown_s,
            interval_s=cfg.autoscale_interval_s)
        provider = LocalProcessProvider(
            [f"http://{host}:{srv.port}"], spool_dir=cfg.spool_dir,
            etc_dir=etc_dir, device=device)
        try:
            # the floor: a cluster runner with no worker fails every
            # SELECT, so no queue could ever build to scale it up
            for _ in range(policy.min_workers):
                provider.launch()
        except BaseException:
            provider.stop_all()
            srv.stop()
            runner.detector.stop()
            raise
        srv.autoscaler = AutoscaleController(provider, policy=policy)
        srv.autoscaler.start()
    return srv, cfg
