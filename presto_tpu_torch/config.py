"""Session-property registry of the port.

The counterpart of the registry half of ``presto_tpu/config.py`` (the
reference's SystemSessionProperties.java role): one declaration per
session property that the port's code reads, with its type, default and
meaning. ``SET SESSION`` on an unknown or mistyped name raises instead of
storing a value no code will ever read. The config-file loaders of the
JAX package are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class SessionProperty:
    name: str
    type: str           # boolean | integer | double | varchar
    default: object     # documentation only; read sites supply defaults
    doc: str


class SessionPropertyError(ValueError):
    """User-facing SET SESSION rejection (unknown name / bad type)."""

    name = "INVALID_SESSION_PROPERTY"


SESSION_PROPERTIES: Dict[str, SessionProperty] = {}


def _sp(name: str, type_: str, default, doc: str) -> None:
    SESSION_PROPERTIES[name] = SessionProperty(name, type_, default, doc)


_sp("broadcast_join_row_limit", "integer", 4_000_000,
    "build sides at or under this many estimated rows broadcast; "
    "larger ones hash-partition")
_sp("dense_grouping", "boolean", True,
    "allow the stats-bounded dense (scatter-path) GROUP BY plan")
_sp("enable_dynamic_filtering", "boolean", True,
    "build-side key bounds filter the probe side at runtime")
_sp("fused_compact_floor", "integer", 1 << 17,
    "skip fused-chain compaction below this batch capacity")
_sp("fused_compact_window", "integer", 4,
    "fused-chain liveness readbacks amortize over this many batches")
_sp("fused_pipeline", "boolean", True,
    "run chains of unique-build inner/left joins (with the filters and "
    "projections between them) as one head/tail program pair "
    "(exec/fused.py)")
_sp("join_dense_path", "boolean", True,
    "stats-driven dense-key direct-address join builds")
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
    elif sp.type == "varchar" and not isinstance(value, str):
        raise bad()
    return out
