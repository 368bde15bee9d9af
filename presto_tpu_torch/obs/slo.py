"""Per-resource-group SLOs: error budgets, multi-window burn rates, and
an OK→WARN→PAGE alert state machine with hysteresis.

The counterpart of ``presto_tpu/obs/slo.py``.

Objectives are declared on serving resource groups (the
``ResourceGroupManager`` config of ``server/resource_groups.py``)::

    {"name": "dash", "hardConcurrencyLimit": 4,
     "slo": {"latencyTargetMs": 500, "latencyObjective": 0.95,
             "availabilityObjective": 0.999, "windows": [300, 3600]}}

reads "95% of dash queries finish under 500 ms, 99.9% succeed".  The
tracker re-reads the live group tree on every evaluation (weak manager
registry in ``serving/groups.py``), so objectives follow whatever
server(s) the process is running — no registration dance.

The math is the Google SRE multi-window burn-rate recipe:

- error fraction over a trailing window comes from the time-series
  store (``obs/timeseries.py``): latency objectives difference the
  cumulative bucket counts of ``serving_latency_seconds.<group>`` (the
  front door observes each served query's wall there) and
  count observations over the threshold as errors; availability
  objectives difference ``serving_errors_total.<group>`` against
  ``serving_requests_total.<group>``;
- ``burn = error_fraction / (1 - objective)`` — burn 1.0 spends the
  budget exactly at the sustainable rate, burn 10 spends a 30-day
  budget in 3 days;
- an alert escalates only when **every** window burns (short window =
  fast detection, long window = noise floor): ``min(burns) >=
  PAGE_ENTER_BURN`` pages, ``>= WARN_ENTER_BURN`` warns;
- hysteresis on the way down: the state steps down only after the burn
  stays below ``EXIT_FRACTION`` of the current state's entry threshold
  for ``CLEAR_AFTER`` consecutive evaluations — a series hovering on
  the boundary cannot flap.

Transitions land in a bounded alert log (``system.runtime.alerts``),
current state in ``system.runtime.slo``, and the registry grows
``slo_burn_rate_ratio`` / ``slo_error_budget_remaining_ratio`` gauges
plus ``slo_alert_transitions_total``.  Latency thresholds snap **up**
to the histogram bucket ladder (``obs.metrics.DEFAULT_BUCKETS``), so
pick thresholds on bucket bounds for exact semantics.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .._devtools.lockcheck import checked_lock
from .metrics import REGISTRY
from .timeseries import TIMESERIES, TimeSeriesStore

#: Alert rule registry: every alert the tracker can raise, by name;
#: :func:`alert_rule` rejects a name not declared here.
ALERT_RULES: Dict[str, str] = {
    "latency_burn": ("multi-window burn of a latency objective: too "
                     "many queries over the group's latency threshold"),
    "availability_burn": ("multi-window burn of an availability "
                          "objective: too many failed queries"),
}


def alert_rule(name: str) -> str:
    """Validate ``name`` against :data:`ALERT_RULES` and return it."""
    if name not in ALERT_RULES:
        raise ValueError(f"unknown alert rule {name!r}; "
                         f"declared: {sorted(ALERT_RULES)}")
    return name


DEFAULT_WINDOWS: Tuple[float, float] = (300.0, 3600.0)  # 5m + 1h
WARN_ENTER_BURN = 2.0
PAGE_ENTER_BURN = 10.0
EXIT_FRACTION = 0.5     # step down below half the entry threshold...
CLEAR_AFTER = 2         # ...held for this many consecutive evaluations

_RANK = {"OK": 0, "WARN": 1, "PAGE": 2}


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective on one resource group."""
    group: str                  # dotted group path, e.g. "serving.dash"
    objective: str              # "latency" | "availability"
    target: float               # good fraction, e.g. 0.95
    threshold_s: Optional[float] = None   # latency objectives only
    windows: Tuple[float, ...] = DEFAULT_WINDOWS

    @property
    def rule(self) -> str:
        if self.objective == "latency":
            return alert_rule("latency_burn")
        return alert_rule("availability_burn")

    @property
    def key(self) -> Tuple[str, str]:
        return (self.group, self.objective)


def burn_rate(error_fraction: float, target: float) -> float:
    """``error_fraction / (1 - target)`` — 1.0 spends the budget exactly
    at the sustainable rate."""
    allowed = max(1e-9, 1.0 - float(target))
    return max(0.0, float(error_fraction)) / allowed


def objectives_from_spec(group_path: str,
                         spec: Optional[dict]) -> List[SloObjective]:
    """Parse one group's normalized ``slo`` block into objectives."""
    if not spec:
        return []
    windows = tuple(float(w) for w in spec.get("windows",
                                               DEFAULT_WINDOWS))
    if len(windows) < 1:
        windows = DEFAULT_WINDOWS
    out: List[SloObjective] = []
    if spec.get("latencyObjective") is not None:
        thr_ms = spec.get("latencyTargetMs")
        if thr_ms is None:
            raise ValueError(
                f"group {group_path!r}: latencyObjective requires "
                "latencyTargetMs")
        out.append(SloObjective(group_path, "latency",
                                float(spec["latencyObjective"]),
                                threshold_s=float(thr_ms) / 1000.0,
                                windows=windows))
    if spec.get("availabilityObjective") is not None:
        out.append(SloObjective(group_path, "availability",
                                float(spec["availabilityObjective"]),
                                windows=windows))
    return out


class _AlertState:
    __slots__ = ("state", "since", "ok_streak")

    def __init__(self, now: float) -> None:
        self.state = "OK"
        self.since = now
        self.ok_streak = 0


class SloTracker:
    """Evaluates every declared objective against the time-series store.

    Driven by the store's sampler listener hook in production
    (:meth:`install`); tests call :meth:`evaluate` with explicit
    timestamps for deterministic time.
    """

    ALERT_LOG_POINTS = 256
    HISTORY_POINTS = 512

    def __init__(self, store: Optional[TimeSeriesStore] = None) -> None:
        self._store = store if store is not None else TIMESERIES
        self._lock = checked_lock("slo.tracker")
        self._states: Dict[Tuple[str, str], _AlertState] = {}
        self._alerts: deque = deque(maxlen=self.ALERT_LOG_POINTS)
        self._history: deque = deque(maxlen=self.HISTORY_POINTS)

    def install(self) -> None:
        """Hook :meth:`evaluate` after every sampler tick (idempotent)."""
        self._store.add_listener(self.evaluate)

    # -- objective discovery ------------------------------------------------

    def objectives(self) -> List[SloObjective]:
        """Objectives of every live manager's group tree, deduplicated
        by (group path, objective kind) — first manager wins."""
        from ..serving.groups import live_managers
        out: List[SloObjective] = []
        seen = set()
        for mgr in live_managers():
            stack = list(mgr.info())
            while stack:
                g = stack.pop()
                for obj in objectives_from_spec(g["id"], g.get("slo")):
                    if obj.key not in seen:
                        seen.add(obj.key)
                        out.append(obj)
                stack.extend(g["subGroups"])
        out.sort(key=lambda o: o.key)
        return out

    # -- burn math ----------------------------------------------------------

    def _error_fraction(self, obj: SloObjective, window: float,
                        now: float) -> Optional[float]:
        """Fraction of bad events over the trailing window, or ``None``
        when the window saw no traffic (no burn without evidence)."""
        if obj.objective == "latency":
            delta = self._store.window_counts(
                f"serving_latency_seconds.{obj.group}", window, now=now)
            if delta is None:
                return None
            count, _total, cum_counts, bounds = delta
            if count <= 0:
                return None
            # good = observations at or under the threshold, read off
            # the cumulative window delta at the first bound >= the
            # threshold (thresholds snap UP to the bucket ladder)
            good = count
            for i, bound in enumerate(bounds):
                if bound >= obj.threshold_s:
                    good = cum_counts[i]
                    break
            else:
                return 0.0  # threshold above the ladder: all good
            return (count - good) / count
        req = self._store.rate(f"serving_requests_total.{obj.group}",
                               window, now=now)
        err = self._store.rate(f"serving_errors_total.{obj.group}",
                               window, now=now)
        if req is None or req <= 0:
            return None
        return min(1.0, max(0.0, (err or 0.0) / req))

    def burns(self, obj: SloObjective,
              now: Optional[float] = None) -> Dict[float, Optional[float]]:
        """Burn rate per window; ``None`` where the window has no data."""
        t = time.time() if now is None else float(now)
        out: Dict[float, Optional[float]] = {}
        for w in obj.windows:
            frac = self._error_fraction(obj, w, t)
            out[w] = None if frac is None else burn_rate(frac,
                                                         obj.target)
        return out

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass over every declared objective.

        Returns the alert-log entries appended by this pass (normally
        empty).  Gauges and the history ring update every pass.
        """
        t = time.time() if now is None else float(now)
        transitions: List[dict] = []
        for obj in self.objectives():
            burns = self.burns(obj, now=t)
            known = [b for b in burns.values() if b is not None]
            # escalate only when EVERY window burns; windows with no
            # data hold the alert down (no page without evidence)
            min_burn = min(known) if len(known) == len(burns) else 0.0
            long_w = max(obj.windows)
            long_burn = burns.get(long_w)
            budget = max(0.0, 1.0 - long_burn) if long_burn is not None \
                else 1.0
            label = f"{obj.group}:{obj.objective}"
            for w, b in burns.items():
                REGISTRY.gauge(
                    f"slo_burn_rate_ratio.{label}:{int(w)}s").set(
                        b if b is not None else 0.0)
            REGISTRY.gauge(
                f"slo_error_budget_remaining_ratio.{label}").set(budget)
            with self._lock:
                st = self._states.get(obj.key)
                if st is None:
                    st = self._states[obj.key] = _AlertState(t)
                new_state = self._step(st, min_burn)
                if new_state != st.state:
                    entry = {
                        "ts": t, "group": obj.group,
                        "objective": obj.objective, "rule": obj.rule,
                        "from": st.state, "to": new_state,
                        "burn": {str(int(w)): b
                                 for w, b in burns.items()},
                    }
                    self._alerts.append(entry)
                    transitions.append(entry)
                    st.state = new_state
                    st.since = t
                    st.ok_streak = 0
                    REGISTRY.counter(
                        f"slo_alert_transitions_total.{label}").inc()
                point = {"t": t, "group": obj.group,
                         "objective": obj.objective,
                         "burn": {str(int(w)): b
                                  for w, b in burns.items()},
                         "state": st.state}
                if obj.objective == "latency":
                    p95 = self._store.window_quantile(
                        f"serving_latency_seconds.{obj.group}",
                        min(obj.windows), 0.95, now=t)
                    point["p95_ms"] = (p95 * 1000.0
                                       if p95 is not None else None)
                self._history.append(point)
        return transitions

    @staticmethod
    def _step(st: _AlertState, min_burn: float) -> str:
        """State-machine step: immediate escalation, hysteretic decay."""
        desired = ("PAGE" if min_burn >= PAGE_ENTER_BURN else
                   "WARN" if min_burn >= WARN_ENTER_BURN else "OK")
        if _RANK[desired] > _RANK[st.state]:
            return desired
        if _RANK[desired] < _RANK[st.state]:
            entry = (PAGE_ENTER_BURN if st.state == "PAGE"
                     else WARN_ENTER_BURN)
            if min_burn < entry * EXIT_FRACTION:
                st.ok_streak += 1
                if st.ok_streak >= CLEAR_AFTER:
                    return desired
            else:
                st.ok_streak = 0
        else:
            st.ok_streak = 0
        return st.state

    # -- read surfaces ------------------------------------------------------

    def state_of(self, group: str, objective: str) -> str:
        with self._lock:
            st = self._states.get((group, objective))
            return st.state if st is not None else "OK"

    def snapshot_rows(self, now: Optional[float] = None) -> List[Tuple]:
        """``system.runtime.slo`` rows: one per objective."""
        t = time.time() if now is None else float(now)
        rows: List[Tuple] = []
        for obj in self.objectives():
            burns = self.burns(obj, now=t)
            short_w, long_w = min(obj.windows), max(obj.windows)
            long_burn = burns.get(long_w)
            budget = max(0.0, 1.0 - long_burn) if long_burn is not None \
                else 1.0
            with self._lock:
                st = self._states.get(obj.key)
                state = st.state if st is not None else "OK"
                since = st.since if st is not None else None
            rows.append((
                obj.group, obj.objective, obj.rule, obj.target,
                obj.threshold_s * 1000.0 if obj.threshold_s is not None
                else None,
                state, since,
                burns.get(short_w), long_burn, budget))
        return rows

    def alert_rows(self) -> List[Tuple]:
        """``system.runtime.alerts`` rows, oldest first."""
        with self._lock:
            entries = list(self._alerts)
        rows = []
        for e in entries:
            burns = e["burn"]
            keys = sorted(burns, key=float)
            short = burns[keys[0]] if keys else None
            long_ = burns[keys[-1]] if keys else None
            rows.append((e["ts"], e["group"], e["objective"], e["rule"],
                         e["from"], e["to"], short, long_))
        return rows

    def alert_log(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._alerts]

    def history(self) -> List[dict]:
        """Per-evaluation burn/p95 timeline (bench ``slo`` block feed)."""
        with self._lock:
            return [dict(e) for e in self._history]

    def reset(self) -> None:
        with self._lock:
            self._states.clear()
            self._alerts.clear()
            self._history.clear()


SLO = SloTracker()


def slo_block(store: Optional[TimeSeriesStore] = None,
              tracker: Optional[SloTracker] = None,
              max_timeline_points: int = 240) -> dict:
    """The serving ``slo`` block: declared objectives with final
    burn/budget/state, every alert transition, and the per-evaluation
    burn timeline (windowed p95 alongside, for latency objectives).

    The same block the JAX package's server serves on ``GET /v1/slo``
    and its serving benchmark records."""
    store = store if store is not None else TIMESERIES
    tracker = tracker if tracker is not None else SLO
    tracker.evaluate()  # flush a final point so the timeline ends "now"
    objectives = []
    for (group, objective, rule, target, threshold_ms, state, _since,
         burn_short, burn_long, budget) in tracker.snapshot_rows():
        objectives.append({
            "group": group, "objective": objective, "rule": rule,
            "target": target, "threshold_ms": threshold_ms,
            "state": state,
            "burn_short": burn_short and round(burn_short, 4),
            "burn_long": burn_long and round(burn_long, 4),
            "budget_remaining": round(budget, 4)})
    alerts = [{"ts": round(e["ts"], 3), "group": e["group"],
               "objective": e["objective"], "rule": e["rule"],
               "from": e["from"], "to": e["to"]}
              for e in tracker.alert_log()]
    timeline = []
    for e in tracker.history():
        burns = [b for b in e["burn"].values() if b is not None]
        pt = {"t": round(e["t"], 3), "group": e["group"],
              "objective": e["objective"],
              "burn": round(max(burns), 4) if burns else None,
              "state": e["state"]}
        if e.get("p95_ms") is not None:
            pt["p95_ms"] = round(e["p95_ms"], 2)
        timeline.append(pt)
    # keep the pin readable: stride the timeline down, always keeping
    # the final point of each objective
    if len(timeline) > max_timeline_points:
        stride = ((len(timeline) + max_timeline_points - 1)
                  // max_timeline_points)
        tail = timeline[-len(objectives):] if objectives else []
        timeline = [p for i, p in enumerate(timeline)
                    if i % stride == 0 or p in tail]
    return {"sample_interval_s": store.sample_interval_s,
            "objectives": objectives, "alerts": alerts,
            "timeline": timeline}
