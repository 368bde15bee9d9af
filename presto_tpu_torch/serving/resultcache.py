"""Versioned result/subplan cache with incremental maintenance.

The counterpart of ``presto_tpu/serving/resultcache.py``:
materialized-view semantics without the DDL. A standing query (a
dashboard refresh, a feature recompute) keyed by its full
bound-statement fingerprint serves its stored rows as long as every
scanned table's connector ``data_version`` still matches, and when only
some SPLITS of one table changed, recomputes just the changed-split
partial and merges.

Three outcomes per lookup:

- **hit**: every dep's current ``data_version`` equals the stamp the
  entry recorded at insert. Serve the stored host rows; no planning, no
  device work.
- **partial**: exactly one dep drifted, its connector attests per-file
  versions (filebase-style ``(seq, ((relpath, mtime), ...))`` tokens),
  the drift is APPEND-ONLY (every old file unchanged, new files added),
  and the plan qualified for incremental maintenance at insert time.
  The engine re-runs the plan's aggregation subtree (the designated
  *subplan*) restricted to the new splits only (``execute_plan``'s
  ``split_restrict``), merges the delta into the cached subplan rows
  (distributive merge: sum/count add, min/max extremize), replays the
  merged rows through the plan suffix via a ValuesNode, and re-stamps
  the entry.
- **miss**: anything else (rewritten or removed files, more than one
  drifted dep, a non-distributive plan). The query runs cold; an
  eligible result inserts with a write-epoch veto mirroring the plan
  cache's: deps are stamped BEFORE execution, and a connector write
  notifying mid-run bumps the epoch and refuses the insert.

Incremental eligibility (computed once at insert):

- single-child chain from the root down to ONE AggregationNode
  (Output/Project/Filter/Sort/TopN/Limit/Distinct suffix: the suffix
  re-executes over the merged subplan rows, so HAVING/ORDER/LIMIT are
  all fine);
- the aggregation is ``step == "single"`` with distributive functions
  only (sum/count/min/max, no DISTINCT);
- below it only Filter/Project over EXACTLY ONE TableScanNode, whose
  connector exposes per-file versions, and no other scan anywhere in
  the plan (init plans included);
- the subplan result fits one batch (``MAX_SUBPLAN_ROWS``).

The delta, the subplan capture and the suffix replay run on the device
the query runs on (``device`` of :func:`begin`, :func:`serve` and
:func:`store`).

Memory: entries account host-row bytes against a dedicated
``memory.QueryMemoryPool`` (``result-cache.max-bytes`` config key,
``config.apply_node_config``; default 256 MiB) with LRU eviction. Eager
invalidation rides ``spi.on_data_change`` like every other cache in the
engine.

Metrics: ``result_cache_{hit,miss,partial,invalidated,evicted}_total``
and ``result_cache_resident_bytes``. Session knob: ``result_cache``
(default false).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .._devtools.lockcheck import checked_lock, guarded_by
from ..exec.failpoints import FAILPOINTS
from ..memory import QueryMemoryPool
from ..obs.metrics import REGISTRY
from .plancache import PlanCache, _freeze

_HITS = REGISTRY.counter("result_cache_hit_total")
_MISSES = REGISTRY.counter("result_cache_miss_total")
_PARTIAL = REGISTRY.counter("result_cache_partial_total")
_INVALIDATED = REGISTRY.counter("result_cache_invalidated_total")
_EVICTED = REGISTRY.counter("result_cache_evicted_total")
_RESIDENT = REGISTRY.gauge("result_cache_resident_bytes")

DEFAULT_MAX_BYTES = 256 << 20
#: merged subplan rows replay through a single ValuesNode batch
MAX_SUBPLAN_ROWS = 1 << 17

_DISTRIBUTIVE = frozenset(["sum", "count", "count_star", "min", "max"])


def _rows_bytes(rows) -> int:
    """Rough host footprint of a row list (python tuples of scalars)."""
    total = sys.getsizeof(rows) if rows is not None else 0
    for r in rows or ():
        total += sys.getsizeof(r)
        for v in r:
            total += sys.getsizeof(v)
    return total


@dataclasses.dataclass
class IncrementalSpec:
    """How to maintain one entry incrementally (captured at insert)."""
    #: the aggregation subtree (the designated subplan) — plan node
    agg: object
    #: dep index (into entry.deps) of the single file-versioned table
    dep_index: int
    #: catalog / table the delta scan restriction applies to
    catalog: str
    table: str
    #: number of leading group-key columns in the subplan rows
    n_keys: int
    #: (column index, fn) for each aggregate column of the subplan rows
    agg_cols: Tuple[Tuple[int, str], ...]


class _Entry:
    __slots__ = ("rows", "names", "types", "deps", "bytes", "ctx",
                 "subplan_rows", "spec", "plan")

    def __init__(self, rows, names, types, deps, ctx,
                 subplan_rows=None, spec=None, plan=None):
        self.rows = rows
        self.names = names
        self.types = types
        #: [(connector weakref, catalog, table, frozen data version)]
        self.deps: List[Tuple] = deps
        self.ctx = ctx                     # pool memory context
        self.bytes = 0
        self.subplan_rows = subplan_rows   # agg-level rows (incremental)
        self.spec: Optional[IncrementalSpec] = spec
        self.plan = plan                   # the optimized plan (suffix replay)


@dataclasses.dataclass
class PartialHit:
    """A lookup that can be served by delta recompute + merge. Base
    state is SNAPSHOTTED at lookup: two concurrent partial hits on one
    entry each merge delta into the same base (never into the other's
    merged result), and ``update`` rejects the second re-stamp via the
    ``base_deps`` compare — the delta can never double-apply."""
    entry: _Entry
    key: bytes
    new_files: frozenset          # relpaths to restrict the delta scan to
    fresh_deps: List[Tuple]       # deps to re-stamp the entry with
    epoch: int                    # veto epoch captured at lookup
    base_deps: List[Tuple]        # dep stamps the snapshot was valid for
    base_subplan: object          # subplan rows at lookup (never mutated)
    plan: object
    spec: "IncrementalSpec"


class ResultCache:
    """Process-wide LRU of final (and designated-subplan) query results
    keyed by bound-statement fingerprint + connector data versions."""

    #: guarded-field contracts (lockcheck): entry map and write epoch
    #: only under the cache lock
    _entries = guarded_by(attr="_lock")
    _epoch = guarded_by(attr="_lock")

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._lock = checked_lock("resultcache.entries")
        self._epoch = 0
        self.pool = QueryMemoryPool(max_bytes)

    # -- config ---------------------------------------------------------------
    def set_limit(self, max_bytes: int) -> None:
        with self._lock:
            self.pool.limit = max_bytes
            self._shrink_locked()

    # -- write epoch ----------------------------------------------------------
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def note_write(self) -> None:
        with self._lock:
            self._epoch += 1

    # -- lookup ---------------------------------------------------------------
    def get(self, key: bytes):
        """("hit", QueryResult-parts) | ("partial", PartialHit) |
        ("miss", None). Dep revalidation runs OUTSIDE the lock (filebase
        versions stat files)."""
        with self._lock:
            e = self._entries.get(key)
            epoch = self._epoch
            if e is not None:
                # consistent snapshot: a concurrent partial update
                # replaces deps/subplan_rows wholesale (never mutates),
                # so these references stay internally coherent
                base_deps = list(e.deps)
                base_subplan = e.subplan_rows
        if e is None:
            _MISSES.inc()
            return "miss", None
        fresh: List[Tuple] = []
        drifted: List[int] = []
        for i, dep in enumerate(base_deps):
            conn_ref, catalog, table, version = dep
            conn = conn_ref()
            ver_fn = getattr(conn, "data_version", None) if conn else None
            now = _freeze(ver_fn(table)) if ver_fn else None
            fresh.append((conn_ref, catalog, table, now))
            if now is None or now != version:
                drifted.append(i)
        if not drifted:
            with self._lock:
                if self._entries.get(key) is e:
                    self._entries.move_to_end(key)
            _HITS.inc()
            return "hit", e
        if (e.spec is not None and drifted == [e.spec.dep_index]):
            old_v = base_deps[e.spec.dep_index][3]
            new_v = fresh[e.spec.dep_index][3]
            added = _appended_files(old_v, new_v)
            if added is not None:
                return "partial", PartialHit(
                    entry=e, key=key, new_files=frozenset(added),
                    fresh_deps=fresh, epoch=epoch,
                    base_deps=base_deps, base_subplan=base_subplan,
                    plan=e.plan, spec=e.spec)
        # rewritten / removed files, or a non-incremental entry: drop
        self._drop(key, e)
        _MISSES.inc()
        return "miss", None

    def probe(self, key: bytes):
        """Metric-silent, LRU-silent peek for EXPLAIN ANALYZE: (rows,
        bytes, incremental?) of a resident entry, else None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            return (len(e.rows), e.bytes, e.spec is not None)

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries),
                    "resident_bytes": self.pool.reserved}

    def _drop(self, key: bytes, e: Optional[_Entry] = None) -> None:
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None and (e is None or cur is e):
                del self._entries[key]
                cur.ctx.close()
                _INVALIDATED.inc()
                _RESIDENT.set(self.pool.reserved)

    # -- insert / update ------------------------------------------------------
    def put(self, key: bytes, result, deps, epoch: int,
            subplan_rows=None, spec: Optional[IncrementalSpec] = None,
            plan=None) -> bool:
        """Insert a cold result. ``deps`` were stamped BEFORE execution;
        ``epoch`` too — a connector write notifying mid-run bumps the
        epoch and vetoes the insert (the result may straddle versions)."""
        if deps is None:
            return False
        size = _rows_bytes(result.rows) + _rows_bytes(subplan_rows) + 1024
        with self._lock:
            if epoch != self._epoch:
                return False
            if key in self._entries:
                return True
            if size > self.pool.limit:
                return False
            ctx = self.pool.context(f"result:{key.hex()[:12]}")
            e = _Entry(list(result.rows), list(result.names),
                       list(result.types), list(deps), ctx,
                       subplan_rows=subplan_rows, spec=spec, plan=plan)
            self._entries[key] = e
            self._account_locked(e, size)
            return True

    def update(self, ph: PartialHit, result, subplan_rows) -> bool:
        """Re-stamp a partially-recomputed entry with the merged rows
        and the fresh dep versions (veto on mid-delta writes, and on a
        concurrent partial that re-stamped first — the merge was
        computed against ``base_deps``' snapshot and must not overwrite
        a newer state it didn't incorporate)."""
        size = (_rows_bytes(result.rows) + _rows_bytes(subplan_rows)
                + 1024)
        with self._lock:
            if ph.epoch != self._epoch:
                return False
            e = self._entries.get(ph.key)
            if e is not ph.entry:
                return False
            if e.deps != ph.base_deps:
                return False       # a concurrent partial won the race
            if size > self.pool.limit:
                # outgrew the cache: serve this query, drop the entry
                del self._entries[ph.key]
                e.ctx.close()
                _EVICTED.inc()
                _RESIDENT.set(self.pool.reserved)
                return False
            e.rows = list(result.rows)
            if subplan_rows is not None \
                    and len(subplan_rows) > MAX_SUBPLAN_ROWS:
                # outgrew the single-batch replay cap the insert path
                # enforces: keep serving full hits, stop maintaining
                e.subplan_rows = None
                e.spec = None
            else:
                e.subplan_rows = subplan_rows
            e.deps = list(ph.fresh_deps)
            self._account_locked(e, size)
            return True

    def _account_locked(self, e: _Entry, size: int) -> None:
        if e.bytes:
            e.ctx.release_all()
        e.bytes = size
        self._shrink_locked(keep=e)
        self.pool.reserve(size, e.ctx)
        _RESIDENT.set(self.pool.reserved)

    def _shrink_locked(self, keep: Optional[_Entry] = None) -> None:
        need = (keep.bytes if keep is not None else 0)
        while self._entries and \
                self.pool.reserved + need > self.pool.limit:
            victim_key = next((k for k, v in self._entries.items()
                               if v is not keep), None)
            if victim_key is None:
                break
            victim = self._entries.pop(victim_key)
            victim.ctx.close()
            _EVICTED.inc()
        _RESIDENT.set(self.pool.reserved)

    # -- invalidation ---------------------------------------------------------
    def invalidate(self, conn=None, table: Optional[str] = None) -> None:
        """Eager write invalidation (spi.notify_data_change): drop every
        entry depending on the written table — EXCEPT incremental
        entries whose changed table supports append-only maintenance;
        those stay resident and resolve hit/partial/miss on next lookup
        against the fresh version."""
        with self._lock:
            victims = []
            for key, e in self._entries.items():
                for i, (conn_ref, _cat, tab, _ver) in enumerate(e.deps):
                    ref = conn_ref()
                    if ref is None:
                        victims.append(key)
                        break
                    if conn is not None and ref is not conn:
                        continue
                    if table is not None and tab != table:
                        continue
                    if e.spec is not None and i == e.spec.dep_index:
                        continue       # maintainable: keep for partial
                    victims.append(key)
                    break
            for key in victims:
                e = self._entries.pop(key)
                e.ctx.close()
            if victims:
                _INVALIDATED.inc(len(victims))
                _RESIDENT.set(self.pool.reserved)

    def clear(self) -> None:
        with self._lock:
            for e in self._entries.values():
                e.ctx.close()
            self._entries.clear()
            _RESIDENT.set(self.pool.reserved)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _appended_files(old_version, new_version):
    """Relpaths added between two filebase-style ``(seq, ((relpath,
    mtime), ...))`` version tokens, or None when the drift is not
    append-only (missing/rewritten files, foreign token shape)."""
    def files_of(v):
        if (isinstance(v, tuple) and len(v) == 2
                and isinstance(v[1], tuple)):
            try:
                return dict(v[1])
            except (TypeError, ValueError):
                return None
        return None

    old_f, new_f = files_of(old_version), files_of(new_version)
    if old_f is None or new_f is None:
        return None
    for name, mtime in old_f.items():
        if new_f.get(name) != mtime:
            return None                # rewritten or removed: full miss
    added = [name for name in new_f if name not in old_f]
    return added if added else None


# -- plan analysis ------------------------------------------------------------

_SUFFIX_NODES = None


def _suffix_types():
    global _SUFFIX_NODES
    if _SUFFIX_NODES is None:
        from ..planner.plan import (
            DistinctNode, FilterNode, LimitNode, OutputNode, ProjectNode,
            SortNode, TopNNode,
        )
        _SUFFIX_NODES = (OutputNode, ProjectNode, FilterNode, SortNode,
                         TopNNode, LimitNode, DistinctNode)
    return _SUFFIX_NODES


def incremental_spec(plan, session, deps) -> Optional[IncrementalSpec]:
    """IncrementalSpec when ``plan`` qualifies for append-only
    maintenance, else None. See module docstring for the contract."""
    from ..planner.plan import (
        AggregationNode, FilterNode, ProjectNode, TableScanNode,
    )
    if plan.init_plans:
        return None
    node = plan.root
    while isinstance(node, _suffix_types()) and node.children:
        if isinstance(node, AggregationNode):
            break
        if len(node.children) != 1:
            return None
        node = node.children[0]
        if isinstance(node, AggregationNode):
            break
    if not isinstance(node, AggregationNode):
        return None
    agg = node
    if agg.step != "single":
        return None
    for a in agg.aggs:
        if a.fn not in _DISTRIBUTIVE or a.distinct:
            return None
    # below the agg: Filter/Project over exactly one scan
    scans = []

    def walk(n) -> bool:
        if isinstance(n, TableScanNode):
            scans.append(n)
            return True
        if isinstance(n, (FilterNode, ProjectNode)):
            return all(walk(c) for c in n.children)
        return False

    if not walk(agg.child) or len(scans) != 1:
        return None
    scan = scans[0]
    dep_index = None
    for i, (_ref, cat, tab, ver) in enumerate(deps):
        if cat == scan.catalog and tab == scan.table.table:
            dep_index = i
            break
    if dep_index is None:
        return None
    if _appended_file_capable(deps[dep_index][3]) is None:
        return None
    conn = session.catalogs.get(scan.catalog)
    if not hasattr(conn, "root"):       # split restriction needs relpaths
        return None
    nk = len(agg.group_indices)
    agg_cols = tuple((nk + i, a.fn) for i, a in enumerate(agg.aggs))
    return IncrementalSpec(agg=agg, dep_index=dep_index,
                           catalog=scan.catalog, table=scan.table.table,
                           n_keys=nk, agg_cols=agg_cols)


def _appended_file_capable(version):
    """The per-file detail of a frozen version token, or None."""
    if (isinstance(version, tuple) and len(version) == 2
            and isinstance(version[1], tuple)):
        return version[1]
    return None


# -- delta recompute ----------------------------------------------------------

def subplan_result(plan, spec: IncrementalSpec, session, device,
                   rows_per_batch: int, cancel_event=None,
                   split_restrict=None):
    """Run the designated subplan (the aggregation subtree), optionally
    restricted to a split subset, on ``device`` and return its rows."""
    from ..planner.planner import LogicalPlan
    from ..planner.plan import OutputNode
    from ..exec.local import execute_plan
    sub = LogicalPlan(root=OutputNode(child=spec.agg,
                                      fields=spec.agg.fields),
                      init_plans=[])
    return execute_plan(sub, session, device, rows_per_batch,
                        cancel_event=cancel_event,
                        split_restrict=split_restrict).rows


def merge_subplan_rows(spec: IncrementalSpec, base_rows, delta_rows):
    """Distributive merge of two subplan row sets keyed by the group
    columns. Append-only deltas make sum/count additive and min/max
    monotone; a NULL aggregate means 'no rows contributed' and yields
    to the other side."""
    def combine(fn, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if fn in ("sum", "count", "count_star"):
            return a + b
        if fn == "min":
            return a if a <= b else b
        return a if a >= b else b

    nk = spec.n_keys
    merged = OrderedDict()
    for row in list(base_rows) + list(delta_rows):
        k = tuple(row[:nk])
        cur = merged.get(k)
        if cur is None:
            merged[k] = list(row)
        else:
            for idx, fn in spec.agg_cols:
                cur[idx] = combine(fn, cur[idx], row[idx])
    return [tuple(r) for r in merged.values()]


def replay_suffix(plan, spec: IncrementalSpec, merged_rows, session,
                  device, rows_per_batch: int, cancel_event=None):
    """Execute the plan's suffix over the merged subplan rows: the
    aggregation subtree is swapped for a ValuesNode replaying them."""
    import dataclasses as _dc
    from ..planner.plan import ValuesNode
    from ..planner.planner import LogicalPlan
    from ..exec.local import execute_plan
    source = ValuesNode(fields=spec.agg.fields,
                        rows=tuple(tuple(r) for r in merged_rows))

    def swap(n):
        if n is spec.agg:
            return source
        changes = {}
        for f in _dc.fields(n):
            v = getattr(n, f.name)
            if v is spec.agg:
                changes[f.name] = source
            elif isinstance(v, tuple) and any(x is spec.agg for x in v):
                changes[f.name] = tuple(
                    source if x is spec.agg else x for x in v)
            elif hasattr(v, "children") and hasattr(v, "fields") \
                    and _dc.is_dataclass(v) and not isinstance(v, type):
                nv = swap(v)
                if nv is not v:
                    changes[f.name] = nv
        return _dc.replace(n, **changes) if changes else n

    suffix = LogicalPlan(root=swap(plan.root), init_plans=[])
    return execute_plan(suffix, session, device, rows_per_batch,
                        cancel_event=cancel_event)


def split_predicate(session, spec: IncrementalSpec, new_files):
    """Split-restriction map keeping only the new files (filebase split
    info carries the absolute path; versions use root-relative paths),
    or None when ANY current split cannot be classified old-vs-new —
    fail CLOSED: an old split kept by mistake would re-aggregate rows
    the base result already contains."""
    import os
    from ..connectors.spi import TableHandle
    conn = session.catalogs.get(spec.catalog)
    root = conn.root

    def rel_of(split):
        try:
            rel = os.path.relpath(split.info[0], root)
        except (TypeError, IndexError, ValueError):
            return None
        return rel

    try:
        handle = TableHandle(spec.catalog, "default", spec.table)
        current = conn.split_manager.splits(handle)
    except Exception:
        return None
    rels = {id(s): rel_of(s) for s in current}
    if any(r is None for r in rels.values()):
        return None

    def pred(split) -> bool:
        rel = rel_of(split)
        return rel is not None and rel in new_files

    return {(spec.catalog, spec.table): pred}


# -- runner orchestration -----------------------------------------------------

def begin(key: bytes, plan, session, device, rows_per_batch: int,
          cancel_event=None, stats=None):
    """One entry point for both runners (``LocalRunner`` and
    ``ClusterRunner`` must agree on keying, epochs and the write veto):
    try to serve from the cache; on a miss return ``(None, token)`` where
    ``token`` carries the pre-execution dep/epoch stamps for
    :func:`commit`. A hit, partial hit and delta run stay on ``device``,
    the coordinator's, even for a cluster query."""
    served = serve(key, session, device, rows_per_batch,
                   cancel_event=cancel_event, stats=stats)
    if served is not None:
        return served, None
    # epoch BEFORE deps (the cached_plan order): plan_deps stats every
    # filebase table, and a write landing inside that window must veto
    # the insert — deps-then-epoch would stamp pre-write versions on a
    # post-write epoch and the next lookup would double-apply the
    # "new" files its rows already contain
    epoch = RESULTS.epoch()
    FAILPOINTS.hit("resultcache.stamp", key=key.hex()[:12])
    deps = plan_deps(plan, session)
    return None, (key, plan, epoch, deps, device, rows_per_batch,
                  cancel_event)


def commit(token, session, result) -> bool:
    """Insert a cold result under the stamps ``begin`` captured."""
    if token is None:
        return False
    key, plan, epoch, deps, device, rows_per_batch, cancel_event = token
    if deps is None:
        return False
    return store(key, plan, session, result, deps, epoch, device,
                 rows_per_batch, cancel_event=cancel_event)


def serve(key: bytes, session, device, rows_per_batch: int,
          cancel_event=None, stats=None):
    """QueryResult for a hit or partial hit, else None (the caller runs
    cold). The partial path runs the delta subplan restricted to the
    new splits, merges, replays the suffix, and re-stamps the entry,
    all on the single-device executor (the delta is a small restricted
    scan)."""
    from ..exec.local import QueryResult
    outcome, obj = RESULTS.get(key)
    if outcome == "hit":
        e = obj
        if stats is not None:
            stats.result_cache = "hit"
        return QueryResult(names=list(e.names), types=list(e.types),
                           rows=list(e.rows))
    if outcome == "partial":
        ph: PartialHit = obj
        restrict = split_predicate(session, ph.spec, ph.new_files)
        if restrict is None:
            # a split couldn't be classified as old-vs-new: fail CLOSED
            # (a kept-by-mistake old split would double-count in the
            # merge) — drop the entry and run cold
            RESULTS._drop(ph.key, ph.entry)
            _MISSES.inc()
            if stats is not None:
                stats.result_cache = "miss"
            return None
        _PARTIAL.inc()
        # the double-apply window: a second partial hit racing this
        # delta recompute must merge against ITS OWN lookup-time
        # snapshot and lose the update() re-stamp race
        FAILPOINTS.hit("resultcache.partial", key=ph.key.hex()[:12])
        # merge against the LOOKUP-TIME snapshot: a concurrent partial
        # may re-stamp the live entry mid-flight, and merging into its
        # result would apply this delta twice
        delta = subplan_result(ph.plan, ph.spec, session, device,
                               rows_per_batch, cancel_event=cancel_event,
                               split_restrict=restrict)
        merged = merge_subplan_rows(ph.spec, ph.base_subplan, delta)
        out = replay_suffix(ph.plan, ph.spec, merged, session, device,
                            rows_per_batch, cancel_event=cancel_event)
        RESULTS.update(ph, out, merged)
        if stats is not None:
            stats.result_cache = "partial"
        return out
    if stats is not None:
        stats.result_cache = "miss"
    return None


def store(key: bytes, plan, session, result, deps, epoch: int, device,
          rows_per_batch: int, cancel_event=None) -> bool:
    """Insert a cold result (deps/epoch stamped BEFORE execution).
    Incremental-eligible plans additionally capture the designated
    subplan's rows (a second pass over the aggregation subtree whose
    scans replay warm out of the device scan cache); a write landing
    anywhere in this window bumps the epoch and vetoes the insert."""
    if deps is None:
        return False
    bindings = getattr(session, "param_bindings", None)
    if bindings:
        # template plans carry ir.Param nodes bound per query; the
        # CACHED plan re-executes later (partial delta + suffix replay)
        # under queries that may have NO binding scope (template guard
        # fallback): store the materialized form
        from ..expr.params import bind_plan, has_params
        if has_params(plan):
            plan = bind_plan(plan, bindings)
    spec = incremental_spec(plan, session, deps)
    subplan_rows = None
    if spec is not None:
        try:
            subplan_rows = subplan_result(plan, spec, session, device,
                                          rows_per_batch,
                                          cancel_event=cancel_event)
        except Exception:
            spec, subplan_rows = None, None
        if subplan_rows is not None \
                and len(subplan_rows) > MAX_SUBPLAN_ROWS:
            spec, subplan_rows = None, None
    return RESULTS.put(key, result, deps, epoch,
                       subplan_rows=subplan_rows, spec=spec, plan=plan)


#: the process-wide cache (fingerprints embed connector identities, so
#: one cache serves every runner in the process, like the plan cache)
RESULTS = ResultCache()

from ..connectors import spi  # noqa: E402


def _on_write(conn, table) -> None:
    RESULTS.note_write()
    RESULTS.invalidate(conn, table)


spi.on_data_change(_on_write)


def plan_deps(plan, session):
    """Exec-time dep stamps for a plan (None = uncacheable)."""
    return PlanCache._plan_deps(plan, session)
