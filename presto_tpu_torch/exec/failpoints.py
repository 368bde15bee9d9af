"""Deterministic fault-injection harness (named failpoints).

The counterpart of ``presto_tpu/exec/failpoints.py`` (the role of the
reference's ``@Failpoint``-style fault hooks): production code calls
``FAILPOINTS.hit("site.name", key=...)`` at interesting seams (scan
decode, mesh repartition, the worker task run, exchange pull, heartbeat
ping and spool I/O), and the
call is a dictionary miss unless a test or the
``PRESTO_TPU_TORCH_FAILPOINTS`` environment variable armed that site.

Armed sites trigger deterministically:

- ``times``/``skip``: trigger on hits ``skip+1 .. skip+times``
  (``times=None`` = unlimited), so "fail the first task, then recover"
  is one line of config;
- ``probability`` + ``seed``: a per-rule ``random.Random(seed)`` makes
  probabilistic chaos runs replayable given the same hit sequence;
- ``match``: a regex applied to the hit's ``key`` (task id, url, split)
  so a rule can target one partition or one node.

Actions: ``error`` (raise :class:`FailpointError`), ``sleep`` (inject
latency: the straggler story), and ``callback`` (test API only: run
arbitrary harness code). Multiple rules may be armed on one site; every
matching rule fires in configuration order.

Spec grammar (environment variable), ``;``-separated entries::

    site.name=action[:arg][,times:N][,skip:N][,prob:P][,seed:S][,match:RE]

    PRESTO_TPU_TORCH_FAILPOINTS='mesh.repartition=error:boom,times:1;\
scan.decode=sleep:0.5,prob:0.1,seed:7'

Sites in use in the port: ``scan.decode`` (``exec/scancache.py``),
``mesh.repartition`` (``exec/distributed.py``), ``worker.task_run``,
``exchange.pull``, ``exchange.spec_live`` and ``exchange.spec_replay``
(``server/worker.py``), ``heartbeat.ping`` (``exec/cluster.py``), the
``spool.*`` sites (``exec/spool.py``) and the serving plane's
(``protocol.serve``, ``plancache.plan``, ``resultcache.*``).
"""
from __future__ import annotations

import os
import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["FailpointError", "FailpointRegistry", "FAILPOINTS", "SITES"]

#: declared failpoint sites: every production ``FAILPOINTS.hit(...)``
#: call names one of these, and arming a site outside this table via
#: the spec grammar raises at parse time instead of silently never
#: firing (a typo'd chaos config that injects nothing "passes" every
#: recovery test it was meant to exercise).
SITES: Dict[str, str] = {
    "worker.task_run": "worker begins executing a task attempt "
                       "(server/worker.py)",
    "exchange.pull": "exchange client pulls a page from an upstream "
                     "task (server/worker.py)",
    "heartbeat.ping": "coordinator failure-detector pings a worker "
                      "/v1/info (exec/cluster.py)",
    "scan.decode": "scan pipeline decodes one split batch, before "
                   "staging (exec/scancache.py)",
    "spool.write": "exchange spool appends one output-buffer page "
                   "(exec/spool.py); error fails the producing task",
    "spool.read": "exchange spool reads one page back "
                  "(exec/spool.py); error loses the spool copy",
    "spool.corrupt": "error action flips one byte of the page being "
                     "spooled while keeping the original checksum — "
                     "plants an on-disk corruption for the read path "
                     "to detect (exec/spool.py)",
    "spool.object_put": "object-store spool uploads one blob/manifest "
                        "(exec/spool.py ObjectSpoolStore); error fails "
                        "the writing task before the object lands",
    "spool.object_get": "object-store spool downloads one page blob "
                        "(exec/spool.py ObjectSpoolStore); error loses "
                        "the object copy",
    "exchange.spec_live": "speculative exchange read: the live-pull "
                          "arm is about to issue one HTTP pull "
                          "(server/worker.py); an error rule forces "
                          "the spool-replay arm to win the race",
    "exchange.spec_replay": "speculative exchange read: the "
                            "spool-replay arm is about to start "
                            "(server/worker.py); a sleep/error rule "
                            "forces the live arm to win the race",
    "mesh.repartition": "mesh executor ships one hash-exchange batch "
                        "between mesh slots (exec/distributed.py); error fails "
                        "the query before the collective dispatches",
    "protocol.serve": "statement producer granted its resource-group "
                      "slot, about to execute (server/protocol.py); "
                      "key = group path — a sleep rule injects "
                      "user-visible serving latency, error injects "
                      "availability failures (SLO chaos drills)",
    "plancache.plan": "plan/template cache captured its write epoch "
                      "and is about to plan+optimize (serving/"
                      "plancache.py, serving/template.py) — the "
                      "TOCTOU window; the interleaving explorer "
                      "deschedules here to land a write mid-plan",
    "resultcache.stamp": "result cache captured its write epoch and "
                         "is about to stamp plan deps (serving/"
                         "resultcache.py begin()) — the "
                         "epoch-before-deps window",
    "resultcache.partial": "result cache resolved a partial hit and "
                           "is about to recompute the delta "
                           "(serving/resultcache.py serve()) — the "
                           "double-apply window",
    "fleet.broadcast": "fleet member about to POST one write bump to "
                       "one peer (serving/fleet.py); key = "
                       "connector/table@peer — an error rule DROPS the "
                       "broadcast, leaving that peer to the hit-time "
                       "data_version revalidation backstop (coherence "
                       "chaos drills)",
}


class FailpointError(RuntimeError):
    """An injected failure (never raised by real engine conditions)."""


class _Rule:
    __slots__ = ("site", "action", "message", "sleep_s", "times", "skip",
                 "probability", "pattern", "rng", "callback", "hits",
                 "triggers")

    def __init__(self, site: str, action: str, message: Optional[str],
                 sleep_s: float, times: Optional[int], skip: int,
                 probability: Optional[float], match: Optional[str],
                 seed: int, callback: Optional[Callable]):
        if action not in ("error", "sleep", "callback"):
            raise ValueError(f"unknown failpoint action {action!r}")
        if action == "callback" and callback is None:
            raise ValueError("callback action requires callback=")
        self.site = site
        self.action = action
        self.message = message or f"injected failure at {site}"
        self.sleep_s = float(sleep_s)
        self.times = times            # None = unlimited triggers
        self.skip = int(skip)
        self.probability = probability
        self.pattern = re.compile(match) if match else None
        # seeded per-rule RNG: probabilistic runs replay exactly given
        # the same hit sequence (the determinism contract of the harness)
        self.rng = random.Random(seed)
        self.callback = callback
        self.hits = 0                 # matching hits seen
        self.triggers = 0             # times the action actually fired

    def _should_trigger(self, key: str) -> bool:
        if self.pattern is not None and not self.pattern.search(key):
            return False
        self.hits += 1
        if self.hits <= self.skip:
            return False
        if self.times is not None and self.triggers >= self.times:
            return False
        if self.probability is not None \
                and self.rng.random() >= self.probability:
            return False
        self.triggers += 1
        return True


class FailpointRegistry:
    """Process-wide named-failpoint table. ``hit`` is the production
    call site; everything else is the test/config API."""

    def __init__(self, sites: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        #: when set, configure() rejects sites outside this table (the
        #: process-wide registry passes SITES; unit-test registries that
        #: exercise the rule machinery on synthetic names pass None)
        self._sites = sites

    # -- configuration (test API) --------------------------------------------
    def configure(self, site: str, action: str = "error",
                  message: Optional[str] = None, sleep_s: float = 0.0,
                  times: Optional[int] = 1, skip: int = 0,
                  probability: Optional[float] = None,
                  match: Optional[str] = None, seed: int = 0,
                  callback: Optional[Callable] = None) -> None:
        """Arm one rule on ``site`` (appends — multiple rules per site
        evaluate in configuration order)."""
        if self._sites is not None and site not in self._sites:
            raise ValueError(
                f"unknown failpoint site {site!r} — it would never "
                f"fire (registered: {sorted(self._sites)})")
        rule = _Rule(site, action, message, sleep_s, times, skip,
                     probability, match, seed, callback)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)

    def configure_from_spec(self, spec: str) -> None:
        """Parse the ``;``-separated spec grammar (env var / config)."""
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(f"malformed failpoint entry {entry!r}")
            site, value = entry.split("=", 1)
            parts = value.split(",")
            action, _, arg = parts[0].partition(":")
            kw: Dict = {}
            if action == "sleep":
                kw["sleep_s"] = float(arg or "0")
            elif action == "error":
                if arg:
                    kw["message"] = arg
            else:
                raise ValueError(
                    f"failpoint spec only supports error/sleep "
                    f"actions, got {action!r} (callback is test-only)")
            for opt in parts[1:]:
                k, _, v = opt.partition(":")
                k = k.strip()
                if k == "times":
                    kw["times"] = None if v == "inf" else int(v)
                elif k == "skip":
                    kw["skip"] = int(v)
                elif k == "prob":
                    kw["probability"] = float(v)
                elif k == "seed":
                    kw["seed"] = int(v)
                elif k == "match":
                    kw["match"] = v
                else:
                    raise ValueError(f"unknown failpoint option {k!r}")
            self.configure(site.strip(), action=action, **kw)

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._rules.clear()
            else:
                self._rules.pop(site, None)

    # -- introspection -------------------------------------------------------
    def hits(self, site: str) -> int:
        with self._lock:
            return sum(r.hits for r in self._rules.get(site, ()))

    def triggers(self, site: str) -> int:
        with self._lock:
            return sum(r.triggers for r in self._rules.get(site, ()))

    def active(self) -> bool:
        return bool(self._rules)

    # -- the production call site --------------------------------------------
    def hit(self, site: str, key: str = "", **ctx) -> None:
        """Evaluate ``site``'s rules against ``key``. No rules armed
        anywhere = one falsy check; no rules on this site = one dict
        miss. May raise :class:`FailpointError`, sleep, or run a test
        callback (callbacks run outside the lock and receive
        ``key=...`` plus the caller's context kwargs)."""
        if not self._rules:
            return
        fired: List[_Rule] = []
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return
            for r in rules:
                if r._should_trigger(key):
                    fired.append(r)
        for r in fired:
            if r.action == "sleep":
                time.sleep(r.sleep_s)
            elif r.action == "callback":
                r.callback(key=key, **ctx)
            else:
                raise FailpointError(f"failpoint {site}: {r.message}")


#: the process-wide registry (site names validated against SITES)
FAILPOINTS = FailpointRegistry(sites=SITES)

_env_spec = os.environ.get("PRESTO_TPU_TORCH_FAILPOINTS")
if _env_spec:
    FAILPOINTS.configure_from_spec(_env_spec)
