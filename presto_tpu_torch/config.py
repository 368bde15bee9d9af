"""Session-property registry of the port.

The counterpart of the registry half of ``presto_tpu/config.py`` (the
reference's SystemSessionProperties.java role): one declaration per
session property that the port's code reads, with its type, default and
meaning. ``SET SESSION`` on an unknown or mistyped name raises instead of
storing a value no code will ever read. Of the JAX package's config-file
loaders, only the node-config keys of the caches and the time-series
plane are ported (``apply_node_config``); the rest wait for the
statement server.

Environment defaults (read where the property is resolved, when the
session leaves it unset): ``PRESTO_TPU_TORCH_MESH_EXECUTION`` for
``mesh_execution`` and ``PRESTO_TPU_TORCH_MESH_FLIGHT`` for
``mesh_flight`` (``exec/distributed.py``); ``PRESTO_TPU_TORCH_MESH_SLOTS``
sets the mesh slots per visible device (``parallel/mesh.py``).
"""
from __future__ import annotations

import dataclasses
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


_sp("broadcast_join_row_limit", "integer", 4_000_000,
    "build sides at or under this many estimated rows broadcast; "
    "larger ones hash-partition")
_sp("dense_grouping", "boolean", True,
    "allow the stats-bounded dense (scatter-path) GROUP BY plan")
_sp("enable_dynamic_filtering", "boolean", True,
    "build-side key bounds filter the probe side at runtime")
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
_sp("result_cache", "boolean", False,
    "serve repeated statements from the versioned result cache "
    "(serving/resultcache.py): stored host rows when every scanned "
    "table's data_version matches, changed-split delta recompute + "
    "distributive merge when a file table grew append-only")
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
_sp("spill_partitions", "integer", 16,
    "hash partitions of spilled join builds and aggregation states")
_sp("spill_path", "varchar", None,
    "directory for second-tier disk spill pages")
_sp("spill_to_disk_bytes", "integer", 4 << 30,
    "host bytes staged by a query's spill stores before they flush "
    "compressed pages to disk")
_sp("stats_bounded_grouping", "boolean", True,
    "attach hard per-key bounds from connector stats to aggregations")
_sp("task_concurrency", "integer", 1,
    "driver threads running a grouped aggregation's partial step")

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
#: the node-config keys the port reads: the slice of the JAX package's
#: ``NodeConfig`` that sizes the process-wide caches and the time-series
#: sampler (the statement server's keys wait for it)
NODE_CONFIG_KEYS: Dict[str, str] = {
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
