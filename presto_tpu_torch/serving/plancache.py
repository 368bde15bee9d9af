"""Compiled-plan cache: repeated statements skip parse, plan and optimize.

The counterpart of ``presto_tpu/serving/plancache.py``. A dashboard fires
the same statement hundreds of times; the reference re-plans every
EXECUTE (presto-main/.../execution/SqlQueryExecution.java builds a fresh
plan per query). This module keeps whole optimized plans, with the scan
cache's invalidation idioms:

- **Key**: sha256 fingerprint of the canonical bound AST (frozen
  dataclasses, so ``repr`` is canonical), the session's catalog and
  schema, the mounted connectors' identities, the full session-property
  overlay, the view definitions and, when access control is active, the
  user. EXECUTE substitutes parameters before planning, so two EXECUTEs
  of one prepared statement with the same arguments share an entry.
- **Validation**: each entry records the connector ``data_version`` of
  every table its plan scans (captured at plan time). A hit re-checks
  versions; any drift drops the entry (``plan_cache_invalidated_total``)
  and replans. Connector writes also invalidate eagerly through
  ``spi.on_data_change``. Plans over versionless connectors
  (``data_version`` -> None, e.g. live system tables) are never cached.
- **Safety**: plan nodes are frozen dataclasses and all executor state
  (dynamic filters, materialization, lifespans, stats) lives in the
  per-query ``_Executor``, so one plan object can be executed by any
  number of concurrent queries.

Session knob: ``plan_cache`` (default true). The capacity is
process-wide (plans are small; 256 entries).

Metrics: ``plan_cache_{hit,miss,invalidated,evicted}_total`` in
``obs/metrics.REGISTRY`` (``system.runtime.metrics``).
"""
from __future__ import annotations

import hashlib
import weakref
from collections import OrderedDict
from typing import List, Optional, Tuple

from .._devtools.lockcheck import checked_lock, guarded_by
from ..exec.failpoints import FAILPOINTS
from ..obs.metrics import REGISTRY

DEFAULT_CAPACITY = 256


def _freeze(v):
    """Hashable/comparable form of a connector data-version payload
    (mirrors exec/scancache._freeze — versions are opaque and may carry
    lists/dicts)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


class IdentMemo:
    """Identity-keyed LRU for artifacts derived from interned objects
    (parse_cached returns the SAME AST per repeated text). Entries PIN
    their key object, so an id() can never be reused while its entry
    lives; bounded like the statement cache itself. Shared by the
    canonical-repr memo here and the template parameterization memo
    (serving/template.py) — one implementation owns the id-reuse pin
    and cap policy."""

    #: guarded-field contract (lockcheck): the memo map may only be
    #: touched under this instance's lock
    _entries = guarded_by(attr="_lock")

    def __init__(self, cap: int = 512, lock_name: str = "plancache.memo"):
        self._cap = cap
        self._entries: "OrderedDict[int, Tuple]" = OrderedDict()
        self._lock = checked_lock(lock_name)

    def get(self, obj, compute):
        key = id(obj)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] is obj:
                self._entries.move_to_end(key)
                return hit[1]
        value = compute(obj)
        with self._lock:
            self._entries[key] = (obj, value)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
        return value


class _Entry:
    __slots__ = ("plan", "deps")

    def __init__(self, plan, deps):
        self.plan = plan
        #: [(connector weakref, catalog, table, frozen data version)]
        self.deps: List[Tuple] = deps


class PlanCache:
    """Process-wide LRU of optimized logical plans. ``metrics`` names the counter
    family (the template cache instantiates a second PlanCache under
    ``plan_template_cache``); ``get`` returns what ``put`` stored — by
    default the plan itself, or an arbitrary payload (template entries
    carry plan + guards) whose deps still come from the plan."""

    #: guarded-field contracts (lockcheck): the entry map and the write
    #: epoch may only be touched under this instance's lock — the
    #: attr= form resolves the required lock NAME per instance, since
    #: the template cache instantiates this class under its own name
    _entries = guarded_by(attr="_lock")
    _epoch = guarded_by(attr="_lock")

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 metrics: str = "plan_cache",
                 lock_name: str = "plancache.entries"):
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        #: bumped on every connector write notification; plans begun
        #: before a write may not insert after it (see put())
        self._epoch = 0
        self._lock = checked_lock(lock_name)
        self._hits = REGISTRY.counter(f"{metrics}_hit_total")
        self._misses = REGISTRY.counter(f"{metrics}_miss_total")
        self._invalidated = REGISTRY.counter(f"{metrics}_invalidated_total")
        self._evicted = REGISTRY.counter(f"{metrics}_evicted_total")

    # -- keying ---------------------------------------------------------------
    #: statement-repr memo: a serving query fingerprints twice
    #: (template + bound key) — the O(tree) repr is paid once
    _repr_memo = IdentMemo(lock_name="plancache.reprs")

    @classmethod
    def _stmt_repr(cls, stmt) -> bytes:
        return cls._repr_memo.get(stmt, lambda s: repr(s).encode())

    @classmethod
    def session_fragment(cls, session, user: str = "") -> bytes:
        """Everything :meth:`fingerprint` hashes beyond the statement
        repr. Exposed so a caller keying SEVERAL statements against one
        (session, user) — a serving query fingerprints both its bound
        form and its parameterized template — pays the session-slice
        walk once and hands the bytes to each call."""
        cats = getattr(session.catalogs, "_inner", session.catalogs)
        # connector identities: two runners mounting same-named catalogs
        # over DIFFERENT connector instances (separate datasets) must
        # not share fingerprints — plans embed stats/bounds captured
        # from one instance's data. id() reuse after GC is covered by
        # the entry's weakref deps check (a dead dep drops the entry).
        try:
            ids = sorted((n, id(cats.get(n))) for n in cats.names())
        except Exception:
            ids = [("<unresolvable>", 0)]
        return b"".join((
            repr((session.catalog, session.schema)).encode(),
            repr(ids).encode(),
            repr(sorted((k, repr(v)) for k, v in
                        session.properties.items())).encode(),
            repr(sorted((k, repr(v)) for k, v in
                        session.views.items())).encode(),
            user.encode(),
        ))

    @classmethod
    def fingerprint(cls, stmt, session, user: str = "",
                    fragment: Optional[bytes] = None) -> bytes:
        """Canonical statement fingerprint. The AST and its literals are
        frozen dataclasses, so ``repr`` is a stable canonical form; the
        session slice covers everything that can change what ``optimize``
        produces (properties drive optimizer gates, views expand at plan
        time, the user scopes secured-catalog resolution). ``fragment``
        must be this (session, user)'s :meth:`session_fragment` when
        supplied."""
        h = hashlib.sha256()
        h.update(cls._stmt_repr(stmt))
        h.update(fragment if fragment is not None
                 else cls.session_fragment(session, user))
        return h.digest()

    @staticmethod
    def _plan_deps(plan, session) -> Optional[List[Tuple]]:
        """Data-version deps of every table the plan scans, or None when
        any scanned connector cannot attest a version (uncacheable)."""
        from ..planner.plan import TableScanNode
        deps: List[Tuple] = []
        seen = set()

        def walk(node):
            if isinstance(node, TableScanNode):
                key = (node.catalog, node.table.table)
                if key not in seen:
                    seen.add(key)
                    conn = session.catalogs.get(node.catalog)
                    ver_fn = getattr(conn, "data_version", None)
                    version = ver_fn(node.table.table) if ver_fn else None
                    if version is None:
                        return False
                    deps.append((weakref.ref(conn), node.catalog,
                                 node.table.table, _freeze(version)))
            return all(walk(c) for c in node.children)

        for root in [plan.root] + list(plan.init_plans):
            if not walk(root):
                return None
        return deps

    @staticmethod
    def _dep_live(dep) -> bool:
        conn_ref, _catalog, table, version = dep
        conn = conn_ref()
        if conn is None:
            return False
        ver_fn = getattr(conn, "data_version", None)
        if ver_fn is None:
            return False
        return _freeze(ver_fn(table)) == version

    # -- lookup / insert ------------------------------------------------------
    def epoch(self) -> int:
        """Current write epoch — capture BEFORE planning and hand to
        :meth:`put` so a write landing mid-plan can veto the insert."""
        with self._lock:
            return self._epoch

    def note_write(self) -> None:
        with self._lock:
            self._epoch += 1

    def get(self, key: bytes):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._misses.inc()
                return None
            deps = list(e.deps)
        # revalidate OUTSIDE the lock: data_version may touch the
        # filesystem (filebase stats every table file) and must not
        # serialize every concurrent warm query behind one connector's
        # I/O on the latency-critical fast path
        if not all(self._dep_live(d) for d in deps):
            # a write landed since this plan was optimized: its
            # attached stats/bounds may be stale — replan
            with self._lock:
                if self._entries.get(key) is e:
                    del self._entries[key]
                    self._invalidated.inc()
            self._misses.inc()
            return None
        with self._lock:
            if self._entries.get(key) is e:
                self._entries.move_to_end(key)
        self._hits.inc()
        return e.plan

    def put(self, key: bytes, plan, session,
            epoch: Optional[int] = None, payload=None) -> bool:
        """Insert a freshly-optimized plan. ``epoch`` is the write epoch
        captured BEFORE planning began: any connector write notifying
        during the plan/optimize window bumps the epoch and vetoes the
        insert — the version stamps read here (post-plan) would
        otherwise validate a plan whose optimizer-time stats predate
        the write (TOCTOU). External mutations that bypass
        notify_data_change are caught by get()'s per-hit revalidation
        instead (data_version fingerprints file mtimes). ``payload``
        (default: the plan) is what a later get() returns."""
        deps = self._plan_deps(plan, session)
        if deps is None:
            return False
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False
            if key in self._entries:
                return True            # first planner won; identical plan
            self._entries[key] = _Entry(
                payload if payload is not None else plan, deps)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evicted.inc()
            return True

    # -- invalidation ---------------------------------------------------------
    def invalidate(self, conn=None, table: Optional[str] = None) -> None:
        """Drop entries depending on a connector (and optionally one
        table) — the eager half of write invalidation, riding the same
        ``spi.notify_data_change`` path as the scan cache."""
        with self._lock:
            victims = []
            for key, e in self._entries.items():
                for conn_ref, _cat, tab, _ver in e.deps:
                    ref = conn_ref()
                    if ref is None:
                        victims.append(key)
                        break
                    if conn is not None and ref is not conn:
                        continue
                    if table is not None and tab != table:
                        continue
                    victims.append(key)
                    break
            for key in victims:
                del self._entries[key]
            if victims:
                self._invalidated.inc(len(victims))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: the process-wide cache (plans are connector-bound via their deps, so
#: one cache serves every runner in the process, like exec/scancache)
PLANS = PlanCache()

from ..connectors import spi  # noqa: E402


def _on_write(conn, table) -> None:
    PLANS.note_write()
    PLANS.invalidate(conn, table)


spi.on_data_change(_on_write)


# -- statement (parse) cache -------------------------------------------------
# The front half of the repeated-statement fast path: identical SQL text
# reuses the parsed AST (frozen dataclasses — reusable across queries),
# so a warm statement pays neither parse nor plan. Small and capped: SQL
# text keys can be long, but serving traffic repeats a handful of shapes.

_STMT_CAP = 512
_STMT_MAX_LEN = 1 << 16
_stmt_entries: "OrderedDict[str, object]" = OrderedDict()
_stmt_lock = checked_lock("plancache.statements")


def parse_cached(sql: str):
    """``sql.parser.parse_statement`` with text-keyed memoization."""
    from ..sql.parser import parse_statement
    if len(sql) > _STMT_MAX_LEN:
        return parse_statement(sql)
    with _stmt_lock:
        stmt = _stmt_entries.get(sql)
        if stmt is not None:
            _stmt_entries.move_to_end(sql)
            return stmt
    stmt = parse_statement(sql)
    with _stmt_lock:
        _stmt_entries[sql] = stmt
        while len(_stmt_entries) > _STMT_CAP:
            _stmt_entries.popitem(last=False)
    return stmt


def key_fragment(session, user: str = "",
                 secured: bool = False) -> bytes:
    """The (session, user) fragment under the same key rule as
    :func:`bound_fingerprint` — compute once, pass to several
    ``bound_fingerprint`` calls keying against the same session."""
    return PlanCache.session_fragment(session,
                                      user=user if secured else "")


def bound_fingerprint(stmt, session, user: str = "",
                      secured: bool = False,
                      fragment: Optional[bytes] = None) -> bytes:
    """THE bound-statement key rule (user folds in only when access
    control is active) — every consumer (plan cache, template cache's
    fallback key, result cache, EXPLAIN ANALYZE's probe) must go
    through here so they can never diverge on what a key covers.
    ``fragment``, when supplied, must come from :func:`key_fragment`
    with the same (session, user, secured)."""
    return PlanCache.fingerprint(stmt, session,
                                 user=user if secured else "",
                                 fragment=fragment)


def cached_plan(stmt, session, user: str = "", secured: bool = False):
    """Optimized plan for a SELECT statement, served from :data:`PLANS`
    when the ``plan_cache`` session property (default true) allows and
    the statement's tables are version-attested. ``secured`` folds the
    user into the key so access-control outcomes can never be shared
    across principals."""
    from ..planner.optimizer import optimize
    from ..planner.planner import bool_property, plan_query
    if not bool_property(session, "plan_cache", True):
        return optimize(plan_query(stmt, session), session)
    key = PlanCache.fingerprint(stmt, session,
                                user=user if secured else "")
    plan = PLANS.get(key)
    if plan is not None:
        return plan
    epoch = PLANS.epoch()      # before planning: a mid-plan write vetoes
    # the TOCTOU window: the interleaving explorer deschedules here
    # (_devtools/interleave.py) to land a connector write mid-plan and
    # assert the epoch veto holds
    FAILPOINTS.hit("plancache.plan", key=key.hex()[:12])
    plan = optimize(plan_query(stmt, session), session)
    PLANS.put(key, plan, session, epoch=epoch)
    return plan
