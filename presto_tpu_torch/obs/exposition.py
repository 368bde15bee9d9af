"""Prometheus / OpenMetrics text exposition of the metrics registry.

The counterpart of ``presto_tpu/obs/exposition.py``.

The scrape surface the reference leaves to its JMX exporter agents:
``GET /v1/metrics`` (the statement server's, ``server/protocol.py``) renders
``MetricsRegistry.collect()`` in the Prometheus text format —
``# TYPE`` lines, counter/gauge samples, histogram ``_bucket``/
``_sum``/``_count`` series plus derived ``_quantile`` gauges — ending
with the OpenMetrics ``# EOF`` marker.

The engine's dotted metric names (``operator_batches_total.tablescan``)
become labeled series (``operator_batches_total{key="tablescan"}``),
and the coordinator passes its ``NodeRegistry`` so per-node series
(``node_heartbeat_age_seconds{node="worker-1"}``) are re-published from
one federating scrape endpoint.

``parse_exposition`` is the matching tiny parser: tests round-trip the
rendered text through it, and it is enough to point a real Prometheus
at the endpoint and get the same numbers.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry, NodeRegistry

#: Prometheus metric-name charset; anything else is collapsed to "_"
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _name(raw: str) -> str:
    return _NAME_OK.sub("_", raw)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Family:
    def __init__(self, kind: str):
        self.kind = kind
        self.samples: List[Tuple[str, Dict[str, str], float]] = []


def render_exposition(registry: Optional[MetricsRegistry] = None,
                      nodes: Optional[NodeRegistry] = None) -> str:
    """Registry (and optionally node-registry) state as Prometheus text
    exposition. Deterministic ordering: families sorted by name."""
    reg = registry if registry is not None else REGISTRY
    fams: Dict[str, _Family] = {}

    def family(name: str, kind: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(kind)
        return f

    for m in reg.collect():
        base, _, sub = m["name"].partition(".")
        base = _name(base)
        labels = {"key": sub} if sub else {}
        if m["kind"] in ("counter", "gauge"):
            family(base, m["kind"]).samples.append(
                (base, labels, float(m["value"])))
            continue
        # histogram: cumulative buckets + sum/count, then quantile
        # gauges derived from the same buckets (p50/p95/p99)
        f = family(base, "histogram")
        for le, cum in m["buckets"]:
            f.samples.append((f"{base}_bucket",
                              {**labels, "le": _fmt(le)}, float(cum)))
        f.samples.append((f"{base}_sum", labels, float(m["sum"])))
        f.samples.append((f"{base}_count", labels, float(m["count"])))
        for q, v in sorted((m.get("quantiles") or {}).items()):
            family(f"{base}_quantile", "gauge").samples.append(
                (f"{base}_quantile",
                 {**labels, "quantile": _fmt(q)}, float(v)))

    # windowed quantile gauges from the time-series store
    # (obs/timeseries.py): the ``_quantile`` gauges above are
    # process-LIFETIME estimates (kept for back-compat); these
    # ``*_p95_5m``-style series difference the cumulative buckets
    # between samples, so they mean "over the last 5 minutes".
    # Absent until the sampler has two points in the window.
    from .timeseries import TIMESERIES
    for series in (TIMESERIES.series_names()
                   if reg is TIMESERIES.registry else ()):
        if TIMESERIES.kind(series) != "histogram":
            continue
        base, _, sub = series.partition(".")
        base = _name(base)
        labels = {"key": sub} if sub else {}
        for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = TIMESERIES.window_quantile(series, 300.0, q)
            if v is None:
                continue
            fam_name = f"{base}_{tag}_5m"
            family(fam_name, "gauge").samples.append(
                (fam_name, labels, float(v)))

    if nodes is not None:
        for n in nodes.snapshot():
            lab = {"node": str(n.get("node_id", ""))}
            family("node_up", "gauge").samples.append(
                ("node_up", lab,
                 1.0 if n.get("state") == "ACTIVE" else 0.0))
            family("node_heartbeat_age_seconds", "gauge").samples.append(
                ("node_heartbeat_age_seconds", lab,
                 float(n.get("heartbeat_age_s", math.inf))))
            family("node_active_tasks", "gauge").samples.append(
                ("node_active_tasks", lab,
                 float(n.get("active_tasks", 0) or 0)))
            family("node_mem_pool_peak_bytes", "gauge").samples.append(
                ("node_mem_pool_peak_bytes", lab,
                 float(n.get("mem_pool_peak_bytes", 0) or 0)))
            # HBM telemetry federated from worker heartbeats
            # (device.memory_stats() sums; absent on nodes that never
            # reported one, so a CPU-only cluster adds no noise)
            if n.get("hbm_in_use_bytes") is not None:
                family("node_hbm_in_use_bytes", "gauge").samples.append(
                    ("node_hbm_in_use_bytes", lab,
                     float(n.get("hbm_in_use_bytes") or 0)))
                family("node_hbm_peak_bytes", "gauge").samples.append(
                    ("node_hbm_peak_bytes", lab,
                     float(n.get("hbm_peak_bytes") or 0)))

    lines: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        lines.append(f"# TYPE {name} {f.kind}")
        for sample, labels, value in f.samples:
            lines.append(f"{sample}{_labels(labels)} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_exposition(text: str):
    """Parse Prometheus text exposition back into
    ``(samples, types)``: ``samples`` maps
    ``(sample_name, ((label, value), ...))`` to a float, ``types`` maps
    family name to its declared type. Raises ValueError on malformed
    lines — the round-trip test is a format validator."""
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: bad sample {line!r}")
        name, labelstr, value = m.groups()
        labels = []
        if labelstr:
            matched = _LABEL.findall(labelstr)
            stripped = _LABEL.sub("", labelstr).replace(",", "").strip()
            if stripped:
                raise ValueError(
                    f"line {lineno}: bad labels {labelstr!r}")
            labels = [(k, v.replace('\\"', '"').replace("\\n", "\n")
                       .replace("\\\\", "\\")) for k, v in matched]
        samples[(name, tuple(sorted(labels)))] = float(value)
    return samples, types
