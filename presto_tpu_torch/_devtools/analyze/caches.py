"""Cache-protocol contract checker over the port's caches.

The counterpart of the JAX package's ``tools/analyze/caches.py``. The
costliest class of engine fault is the cache TOCTOU: a stale scan-cache
insert after a mid-decode write, a plan cached across a write epoch, a
result-cache partial hit applied twice. This checker turns the protocol
into a DECLARED registry: every cache of the port (the scan, plan,
template, result and parse caches, the ident memo and the exchange
spool) is listed in :data:`SPECS` with the contract clauses it must
satisfy, and pure-AST passes verify each clause against the tree. A new
cache that does not declare itself here is caught too
(``undeclared-cache``): any class assigning ``self._entries`` in a swept
module must appear in the registry.

Contract clauses:

- ``cache-plain-lock`` — the cache's lock attribute must be built by
  ``checked_lock``/``checked_rlock`` so it enters the runtime lock-order
  graph and the guarded-field validator
  (``presto_tpu_torch/_devtools/lockcheck.py``).
- ``cache-key-missing-version`` — a cache declaring ``versions="key"``
  must use its data-version parameter inside the declared key builder
  (a write changes the key, so stale entries are unreachable).
- ``cache-missing-version-recheck`` — a ``versions="key"`` insert must
  re-read ``data_version`` under the cache lock (a write landing
  mid-decode already invalidated; inserting under the stale key would
  hold reserved bytes forever).
- ``cache-missing-deps`` — a cache declaring ``versions="deps"`` must
  read ``data_version`` in its dep builder AND in its hit-path
  revalidation (entries stamp dep versions and every hit re-checks).
- ``cache-missing-epoch-veto`` — every declared insert/re-stamp method
  must compare the caller's epoch against ``self._epoch`` INSIDE a
  ``with self._lock:`` block (a connector write notifying mid-plan bumps
  the epoch and the insert must refuse).
- ``cache-epoch-after-deps`` — every declared orchestration function
  must capture the write epoch LEXICALLY BEFORE its first call into the
  dep-snapshot/plan builder (deps-then-epoch stamps pre-write versions
  on a post-write epoch, and the next partial hit double-applies).
- ``cache-missing-invalidation-hook`` — the cache's module must register
  an eager-invalidation listener via ``spi.on_data_change`` whose
  handler reaches the cache's ``invalidate``.
- ``cache-unbounded`` — the insert path must bound residency: byte
  accounting against a pool or a byte budget (reserve/evict) or an
  entry-cap eviction loop (``popitem``/LRU shrink).
- ``connector-write-no-notify`` — every write method of a versioned
  connector (one that defines ``data_version``) must reach
  ``spi.notify_data_change`` directly or through a same-class helper
  chain; a write path that skips it leaves every cache serving deleted
  data.

Distributed clauses (the fleet's broadcast fold,
``presto_tpu_torch/serving/fleet.py``: remote write bumps folded into
the local caches):

- ``fleet-fold-unaudited`` — every declared fold function must reach
  ``spi.notify_data_change``, so a remote bump runs every cache's
  registered listener exactly like a local write.
- ``fleet-fold-bypass`` — the fleet module never calls a cache's
  ``invalidate``/``note_write`` directly.
- ``fleet-fold-seq-order`` — inside a fold function the
  ``notify_data_change`` call comes LEXICALLY BEFORE the dedupe
  high-water store (``self._seen[...] = seq``): a fold that dies between
  the two must not be recorded as delivered.

Like every checker in this package: no engine import, stable idents
(``caches:rule:path:symbol``), findings suppressed only through the
committed baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import (Finding, add_parents, ancestors, dotted,
                   parse_file, rel, str_const, walk_py)

CHECKER = "caches"

_CHECKED_CTORS = {"checked_lock", "checked_rlock"}


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """One declared engine cache and the contract clauses that apply.

    ``versions`` is how staleness is kept out: ``"key"`` (the data
    version is a key component — scan cache), ``"deps"`` (entries stamp
    dep versions revalidated per hit — plan/template/result caches) or
    ``"pure"`` (output is a pure function of the key — parse cache).
    ``orchestrations`` maps function name -> tuple of dep/plan-builder
    callee names whose first call must come lexically after the
    ``.epoch()`` capture."""
    name: str
    module: str                              # repo-relative path
    cache_class: Optional[str] = None        # None: module-level dict LRU
    lock_attrs: Tuple[str, ...] = ("_lock",)
    versions: str = "deps"                   # key | deps | pure
    key_fn: Optional[str] = None             # versions=key: builder name
    key_version_param: str = "version"
    version_recheck_in: Tuple[str, ...] = ()
    deps_fns: Tuple[str, ...] = ()           # versions=deps: builders
    revalidate_fns: Tuple[str, ...] = ()     # versions=deps: hit path
    epoch_veto_in: Tuple[str, ...] = ()      # methods comparing _epoch
    orchestrations: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)
    invalidation_hook: bool = True
    bounded_in: Tuple[str, ...] = ()         # insert/shrink methods
    inherits: Optional[str] = None           # contract lives on this spec


#: the port's cache registry: ADD NEW CACHES HERE (the undeclared-cache
#: rule fails otherwise).
SPECS: Tuple[CacheSpec, ...] = (
    CacheSpec(
        name="scancache",
        module="presto_tpu_torch/exec/scancache.py",
        cache_class="ScanCache",
        versions="key",
        key_fn="key",
        key_version_param="version",
        version_recheck_in=("put",),
        epoch_veto_in=(),              # version-in-key makes the epoch
        orchestrations={},             # window a key miss instead
        bounded_in=("put",),
    ),
    CacheSpec(
        name="plancache",
        module="presto_tpu_torch/serving/plancache.py",
        cache_class="PlanCache",
        versions="deps",
        deps_fns=("_plan_deps",),
        revalidate_fns=("_dep_live",),
        epoch_veto_in=("put",),
        orchestrations={"cached_plan": ("optimize", "plan_query")},
        bounded_in=("put",),
    ),
    CacheSpec(
        name="templates",
        module="presto_tpu_torch/serving/template.py",
        cache_class=None,              # an instance of PlanCache
        inherits="plancache",
        versions="deps",
        orchestrations={"template_plan": ("optimize", "plan_query")},
        bounded_in=(),
    ),
    CacheSpec(
        name="resultcache",
        module="presto_tpu_torch/serving/resultcache.py",
        cache_class="ResultCache",
        versions="deps",
        deps_fns=("plan_deps",),
        revalidate_fns=("get",),
        epoch_veto_in=("put", "update"),
        orchestrations={"begin": ("plan_deps",)},
        bounded_in=("put", "_account_locked", "_shrink_locked"),
    ),
    CacheSpec(
        name="parsecache",
        module="presto_tpu_torch/serving/plancache.py",
        cache_class=None,              # module-level dict LRU
        lock_attrs=("_stmt_lock",),
        versions="pure",               # parse(text) is a pure function
        invalidation_hook=False,
        bounded_in=("parse_cached",),
    ),
    CacheSpec(
        name="identmemo",
        module="presto_tpu_torch/serving/plancache.py",
        cache_class="IdentMemo",
        versions="pure",               # value derived from pinned key
        invalidation_hook=False,
        bounded_in=("get",),
    ),
    # the exchange spool: pages are written once under attempt-versioned
    # task ids and collected per query (release_query), so no data
    # version applies; appends reserve against the byte budget
    CacheSpec(
        name="spool",
        module="presto_tpu_torch/exec/spool.py",
        cache_class="LocalDiskSpoolStore",
        versions="pure",
        invalidation_hook=False,
        bounded_in=("append",),        # SpoolWriter.append -> _reserve
    ),
    CacheSpec(
        name="objectspool",
        module="presto_tpu_torch/exec/spool.py",
        cache_class="ObjectSpoolStore",
        versions="pure",
        invalidation_hook=False,
        bounded_in=("_put_page",),     # -> _reserve_locked
    ),
)

#: connector write-surface method names checked for the notify rule
WRITE_METHODS = ("create_table", "drop_table", "append", "delete",
                 "insert", "truncate", "transaction_restore")

CONNECTOR_SCOPE = ("presto_tpu_torch/connectors",)


# -- per-module AST facts -----------------------------------------------------

class _Mod:
    def __init__(self, path: str, rpath: str):
        self.path = path
        self.rpath = rpath
        self.tree = parse_file(path)
        if self.tree is not None:
            add_parents(self.tree)

    def cls(self, name: str) -> Optional[ast.ClassDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and node.name == name:
                return node
        return None

    def fn(self, name: str, under: Optional[ast.AST] = None
           ) -> Optional[ast.FunctionDef]:
        scope = under if under is not None else self.tree
        for node in ast.walk(scope):
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return node
        return None


def _calls_in(scope: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(scope) if isinstance(n, ast.Call)]


def _call_tail(call: ast.Call) -> str:
    return (dotted(call.func) or "").split(".")[-1]


def _under_self_lock(node: ast.AST, lock_attrs: Sequence[str]) -> bool:
    """Is ``node`` lexically inside ``with self.<lock>:`` (or a
    module-level ``with <lock>:``) for one of the declared lock
    attributes?"""
    for anc in ancestors(node):
        if not isinstance(anc, ast.With):
            continue
        for item in anc.items:
            d = dotted(item.context_expr) or ""
            tail = d.split(".")[-1]
            if tail in lock_attrs:
                return True
    return False


def _lock_assignments(scope: ast.AST, lock_attrs: Sequence[str]
                      ) -> List[Tuple[str, Optional[str], int]]:
    """[(attr, ctor_tail or None, lineno)] for every assignment of a
    declared lock attribute anywhere under ``scope`` (self.X = ... or
    module-level X = ...)."""
    out = []
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            d = dotted(tgt) or ""
            tail = d.split(".")[-1]
            if tail not in lock_attrs:
                continue
            ctor = None
            if isinstance(node.value, ast.Call):
                ctor = _call_tail(node.value)
            out.append((tail, ctor, node.lineno))
    return out


# -- clause checks ------------------------------------------------------------

def _check_lock(spec: CacheSpec, mod: _Mod, scope: ast.AST
                ) -> List[Finding]:
    out: List[Finding] = []
    assigns = _lock_assignments(scope, spec.lock_attrs)
    if not assigns:
        out.append(Finding(
            CHECKER, "cache-plain-lock", mod.rpath, 1, spec.name,
            f"cache {spec.name!r}: no assignment of lock attribute(s) "
            f"{spec.lock_attrs} found — the contract needs a "
            f"checked_lock the runtime validator can see"))
        return out
    for attr, ctor, lineno in assigns:
        if ctor not in _CHECKED_CTORS:
            out.append(Finding(
                CHECKER, "cache-plain-lock", mod.rpath, lineno,
                f"{spec.name}.{attr}",
                f"cache {spec.name!r} lock {attr!r} is built by "
                f"{ctor or 'a non-call'} — must be checked_lock/"
                f"checked_rlock so it enters the runtime lock graph "
                f"and guarded-field validation"))
    return out


def _check_key_versions(spec: CacheSpec, mod: _Mod, scope: ast.AST
                        ) -> List[Finding]:
    out: List[Finding] = []
    fn = mod.fn(spec.key_fn, under=scope)
    if fn is None:
        out.append(Finding(
            CHECKER, "cache-key-missing-version", mod.rpath, 1,
            f"{spec.name}.{spec.key_fn}",
            f"declared key builder {spec.key_fn!r} not found"))
        return out
    param = spec.key_version_param
    params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
    used = any(isinstance(n, ast.Name) and n.id == param
               and isinstance(n.ctx, ast.Load) for n in ast.walk(fn))
    if param not in params or not used:
        out.append(Finding(
            CHECKER, "cache-key-missing-version", mod.rpath, fn.lineno,
            f"{spec.name}.{spec.key_fn}",
            f"key builder {spec.key_fn!r} must take and use a "
            f"{param!r} component — without the data version in the "
            f"key, a connector write leaves stale entries reachable"))
    # insert-time recheck under the lock
    for meth in spec.version_recheck_in:
        m = mod.fn(meth, under=scope)
        if m is None:
            out.append(Finding(
                CHECKER, "cache-missing-version-recheck", mod.rpath, 1,
                f"{spec.name}.{meth}",
                f"declared insert method {meth!r} not found"))
            continue
        ok = any(_call_tail(c) == "data_version"
                 or (isinstance(c.func, ast.Name)
                     and c.func.id == "getattr" and len(c.args) >= 2
                     and str_const(c.args[1]) == "data_version")
                 for c in _calls_in(m)
                 if _under_self_lock(c, spec.lock_attrs))
        if not ok:
            out.append(Finding(
                CHECKER, "cache-missing-version-recheck", mod.rpath,
                m.lineno, f"{spec.name}.{meth}",
                f"{meth!r} must re-read data_version under the cache "
                f"lock before inserting (a write that landed "
                f"mid-decode already invalidated; a stale insert holds "
                f"reserved bytes forever)"))
    return out


def _reads_data_version(fn: ast.FunctionDef) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and n.attr == "data_version":
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "getattr" and len(n.args) >= 2 \
                and str_const(n.args[1]) == "data_version":
            return True
        if isinstance(n, ast.Call):
            tail = _call_tail(n)
            if tail in ("_dep_live", "_plan_deps", "plan_deps"):
                return True            # delegation to a dep helper
    return False


def _check_dep_versions(spec: CacheSpec, mod: _Mod, scope: ast.AST
                        ) -> List[Finding]:
    out: List[Finding] = []
    for kind, names in (("dep builder", spec.deps_fns),
                        ("hit revalidation", spec.revalidate_fns)):
        for name in names:
            fn = mod.fn(name, under=scope) or mod.fn(name)
            if fn is None:
                out.append(Finding(
                    CHECKER, "cache-missing-deps", mod.rpath, 1,
                    f"{spec.name}.{name}",
                    f"declared {kind} {name!r} not found"))
                continue
            if not _reads_data_version(fn):
                out.append(Finding(
                    CHECKER, "cache-missing-deps", mod.rpath,
                    fn.lineno, f"{spec.name}.{name}",
                    f"{kind} {name!r} never reads data_version — "
                    f"entries would stamp nothing and hits would "
                    f"never notice a write"))
    return out


def _check_epoch_veto(spec: CacheSpec, mod: _Mod, scope: ast.AST
                      ) -> List[Finding]:
    out: List[Finding] = []
    for meth in spec.epoch_veto_in:
        m = mod.fn(meth, under=scope)
        if m is None:
            out.append(Finding(
                CHECKER, "cache-missing-epoch-veto", mod.rpath, 1,
                f"{spec.name}.{meth}",
                f"declared insert/re-stamp method {meth!r} not found"))
            continue
        ok = False
        for n in ast.walk(m):
            if not isinstance(n, ast.Compare):
                continue
            sides = [n.left] + list(n.comparators)
            if any(isinstance(s, ast.Attribute) and s.attr == "_epoch"
                   for s in sides) \
                    and _under_self_lock(n, spec.lock_attrs):
                ok = True
                break
        if not ok:
            out.append(Finding(
                CHECKER, "cache-missing-epoch-veto", mod.rpath,
                m.lineno, f"{spec.name}.{meth}",
                f"{meth!r} must compare the caller's captured epoch "
                f"against self._epoch under the cache lock — a "
                f"connector write notifying mid-window must veto the "
                f"insert"))
    return out


def _check_epoch_order(spec: CacheSpec, mod: _Mod) -> List[Finding]:
    out: List[Finding] = []
    for fn_name, builders in spec.orchestrations.items():
        fn = mod.fn(fn_name)
        if fn is None:
            out.append(Finding(
                CHECKER, "cache-epoch-after-deps", mod.rpath, 1,
                f"{spec.name}.{fn_name}",
                f"declared orchestration {fn_name!r} not found"))
            continue
        epoch_line = None
        builder_line = None
        for c in _calls_in(fn):
            tail = _call_tail(c)
            if tail == "epoch" and epoch_line is None:
                epoch_line = c.lineno
            if tail in builders:
                # the LAST builder call is the one whose product the
                # insert stamps (earlier calls are cache-off early
                # returns that never insert)
                builder_line = max(builder_line or 0, c.lineno)
        if epoch_line is None:
            out.append(Finding(
                CHECKER, "cache-epoch-after-deps", mod.rpath,
                fn.lineno, f"{spec.name}.{fn_name}",
                f"{fn_name!r} never captures the write epoch "
                f"(.epoch()) before building deps — a mid-window "
                f"write cannot veto its insert"))
        elif builder_line is not None and epoch_line > builder_line:
            out.append(Finding(
                CHECKER, "cache-epoch-after-deps", mod.rpath,
                epoch_line, f"{spec.name}.{fn_name}",
                f"{fn_name!r} captures the write epoch AFTER calling "
                f"{builders} — deps-then-epoch stamps pre-write "
                f"versions on a post-write epoch, and the next "
                f"incremental hit double-applies"))
    return out


def _check_invalidation_hook(spec: CacheSpec, mod: _Mod) -> List[Finding]:
    handlers: Set[str] = set()
    registered_inline = False
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_tail(node) != "on_data_change" or not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Name):
            handlers.add(arg.id)
        elif isinstance(arg, ast.Lambda):
            if any(isinstance(n, ast.Attribute)
                   and n.attr in ("invalidate", "note_write")
                   for n in ast.walk(arg)):
                registered_inline = True
    if registered_inline:
        return []
    for name in handlers:
        fn = mod.fn(name)
        if fn is not None and any(
                isinstance(n, ast.Attribute)
                and n.attr in ("invalidate", "note_write")
                for n in ast.walk(fn)):
            return []
    return [Finding(
        CHECKER, "cache-missing-invalidation-hook", mod.rpath, 1,
        spec.name,
        f"cache {spec.name!r}'s module never registers an "
        f"spi.on_data_change handler reaching invalidate/note_write — "
        f"connector writes would only be noticed by per-hit "
        f"revalidation, leaving the write-epoch veto unarmed")]


def _check_bounded(spec: CacheSpec, mod: _Mod, scope: ast.AST
                   ) -> List[Finding]:
    if not spec.bounded_in:
        return []
    for meth in spec.bounded_in:
        m = mod.fn(meth, under=scope) or mod.fn(meth)
        if m is None:
            continue
        for c in _calls_in(m):
            tail = _call_tail(c)
            if tail in ("popitem", "_evict_lru", "_shrink_locked",
                        "try_reserve", "reserve", "_reserve",
                        "_reserve_locked"):
                return []
    return [Finding(
        CHECKER, "cache-unbounded", mod.rpath, 1, spec.name,
        f"cache {spec.name!r}: none of {spec.bounded_in} bounds "
        f"residency (no pool reserve/evict, no entry-cap popitem) — "
        f"every cache must account bytes or cap entries with "
        f"observable eviction")]


# -- undeclared caches --------------------------------------------------------

#: modules swept for cache-shaped classes that skipped the registry
SWEEP_SCOPE = ("presto_tpu_torch/exec/scancache.py",
               "presto_tpu_torch/serving")


def _undeclared_findings(root: str, specs: Sequence[CacheSpec],
                         scan_paths: Optional[Sequence[str]] = None
                         ) -> List[Finding]:
    declared = {(s.module, s.cache_class) for s in specs
                if s.cache_class}
    out: List[Finding] = []
    paths = (list(scan_paths) if scan_paths is not None
             else walk_py(root, SWEEP_SCOPE))
    for path in paths:
        rpath = rel(path, root)
        mod = _Mod(path, rpath)
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            has_entries = False
            for n in ast.walk(node):
                if isinstance(n, ast.Assign):
                    targets = n.targets
                elif isinstance(n, ast.AnnAssign):
                    targets = [n.target]
                else:
                    continue
                if any((dotted(t) or "").endswith("._entries")
                       for t in targets):
                    has_entries = True
                    break
            if has_entries and (rpath, node.name) not in declared:
                out.append(Finding(
                    CHECKER, "undeclared-cache", rpath, node.lineno,
                    node.name,
                    f"class {node.name!r} looks like an engine cache "
                    f"(assigns self._entries) but is not declared in "
                    f"_devtools/analyze/caches.SPECS — declare it with "
                    f"its contract clauses"))
    return out


# -- connector write rule -----------------------------------------------------

def connector_findings(root: str,
                       scan_paths: Optional[Sequence[str]] = None
                       ) -> List[Finding]:
    paths = (list(scan_paths) if scan_paths is not None
             else sorted(set(walk_py(root, CONNECTOR_SCOPE))))
    out: List[Finding] = []
    for path in paths:
        rpath = rel(path, root)
        mod = _Mod(path, rpath)
        if mod.tree is None:
            out.append(Finding(CHECKER, "parse-error", rpath, 1,
                               "<module>", "file does not parse"))
            continue
        for cls in [n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            methods = {n.name: n for n in cls.body
                       if isinstance(n, ast.FunctionDef)}
            if "data_version" not in methods:
                continue               # unversioned: out of contract
            # helpers that notify (one-hop call-through)
            notifiers = {name for name, m in methods.items()
                         if any(_call_tail(c) == "notify_data_change"
                                for c in _calls_in(m))}
            # transitive same-class call-through (sqlite's write path
            # is create_table -> _invalidate -> _note_write -> notify)
            reaches = set(notifiers)
            changed = True
            while changed:
                changed = False
                for name, m in methods.items():
                    if name not in reaches and any(
                            _call_tail(c) in reaches
                            for c in _calls_in(m)):
                        reaches.add(name)
                        changed = True
            for wname in WRITE_METHODS:
                m = methods.get(wname)
                if m is None or wname in reaches:
                    continue
                out.append(Finding(
                    CHECKER, "connector-write-no-notify", rpath,
                    m.lineno, f"{cls.name}.{wname}",
                    f"versioned connector write path "
                    f"{cls.name}.{wname} never reaches "
                    f"spi.notify_data_change — every engine cache "
                    f"(scan/plan/template/result) would keep serving "
                    f"pre-write data"))
    return out


# -- distributed fold rules (serving/fleet.py) --------------------------------

#: the fleet-membership module whose fold surface is under contract
FLEET_MODULE = "presto_tpu_torch/serving/fleet.py"
#: functions folding REMOTE write bumps into the local caches
FLEET_FOLD_FNS = ("fold_bump",)
#: the dedupe high-water attribute a fold may only advance post-notify
FLEET_SEEN_ATTR = "_seen"


def fleet_findings(root: str, module: str = FLEET_MODULE,
                   fold_fns: Sequence[str] = FLEET_FOLD_FNS
                   ) -> List[Finding]:
    """The broadcast-fold contract: remote bumps re-enter caches only
    through the audited spi path, and only record delivery after it."""
    path = os.path.join(root, module)
    if not os.path.isfile(path):
        return [Finding(
            CHECKER, "cache-missing-module", module, 1, "fleet",
            f"declared fleet module {module!r} missing")]
    mod = _Mod(path, rel(path, root))
    if mod.tree is None:
        return [Finding(CHECKER, "parse-error", mod.rpath, 1,
                        "<module>", "file does not parse")]
    out: List[Finding] = []
    # fleet-fold-bypass: the module as a whole never pokes caches
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in ("invalidate", "note_write"):
            out.append(Finding(
                CHECKER, "fleet-fold-bypass", mod.rpath, node.lineno,
                dotted(node.func) or node.func.attr,
                f"fleet module calls .{node.func.attr}() directly — "
                f"remote bumps must reach caches ONLY through "
                f"spi.notify_data_change so every registered listener "
                f"runs its audited note_write+invalidate sequence"))
    for name in fold_fns:
        fn = mod.fn(name)
        if fn is None:
            out.append(Finding(
                CHECKER, "fleet-fold-unaudited", mod.rpath, 1,
                f"fleet.{name}",
                f"declared fold function {name!r} not found"))
            continue
        notify_line = None
        for c in _calls_in(fn):
            if _call_tail(c) == "notify_data_change":
                notify_line = c.lineno if notify_line is None \
                    else min(notify_line, c.lineno)
        if notify_line is None:
            out.append(Finding(
                CHECKER, "fleet-fold-unaudited", mod.rpath, fn.lineno,
                f"fleet.{name}",
                f"fold function {name!r} never calls "
                f"spi.notify_data_change — a remote write bump that "
                f"skips the audited path leaves local caches (and the "
                f"epoch veto) blind to the write"))
            continue
        seen_store = None
        for n in ast.walk(fn):
            targets = n.targets if isinstance(n, ast.Assign) else (
                [n.target] if isinstance(n, (ast.AnnAssign, ast.AugAssign))
                else ())
            for t in targets:
                if isinstance(t, ast.Subscript) and (
                        dotted(t.value) or "").endswith(
                        f".{FLEET_SEEN_ATTR}"):
                    seen_store = n.lineno if seen_store is None \
                        else min(seen_store, n.lineno)
        if seen_store is None:
            out.append(Finding(
                CHECKER, "fleet-fold-seq-order", mod.rpath, fn.lineno,
                f"fleet.{name}",
                f"fold function {name!r} never advances the dedupe "
                f"high-water mark (self.{FLEET_SEEN_ATTR}[...] = seq) "
                f"— without it every re-delivered bump re-folds and "
                f"the monotonic-delivery contract is gone"))
        elif seen_store < notify_line:
            out.append(Finding(
                CHECKER, "fleet-fold-seq-order", mod.rpath, seen_store,
                f"fleet.{name}",
                f"fold function {name!r} stores the dedupe seq "
                f"(line {seen_store}) BEFORE notify_data_change "
                f"(line {notify_line}) — a fold that dies between the "
                f"two is recorded as delivered and the remote write "
                f"is never applied (seq store must follow the notify)"))
    return out


# -- entry points -------------------------------------------------------------

def check_specs(specs: Sequence[CacheSpec], root: str) -> List[Finding]:
    out: List[Finding] = []
    # inherits= resolves against the FULL registry, not just the specs
    # under check: a --changed run scoped to template.py alone must
    # still see that 'templates' delegates its lock/dep/veto clauses
    # to 'plancache' instead of re-checking them against template.py
    by_name = {s.name: s for s in SPECS}
    by_name.update({s.name: s for s in specs})
    for spec in specs:
        path = os.path.join(root, spec.module)
        if not os.path.isfile(path):
            out.append(Finding(
                CHECKER, "cache-missing-module", spec.module, 1,
                spec.name, f"declared module {spec.module!r} missing"))
            continue
        mod = _Mod(path, rel(path, root))
        if mod.tree is None:
            out.append(Finding(CHECKER, "parse-error", mod.rpath, 1,
                               "<module>", "file does not parse"))
            continue
        scope: ast.AST = mod.tree
        if spec.cache_class:
            cls = mod.cls(spec.cache_class)
            if cls is None:
                out.append(Finding(
                    CHECKER, "cache-missing-module", mod.rpath, 1,
                    spec.name,
                    f"declared class {spec.cache_class!r} not found"))
                continue
            scope = cls
        base = by_name.get(spec.inherits) if spec.inherits else None
        if base is None:
            out.extend(_check_lock(spec, mod, scope))
            if spec.versions == "key":
                out.extend(_check_key_versions(spec, mod, scope))
            elif spec.versions == "deps":
                out.extend(_check_dep_versions(spec, mod, scope))
            out.extend(_check_epoch_veto(spec, mod, scope))
            out.extend(_check_bounded(spec, mod, scope))
        # orchestration + hook clauses always apply to the module that
        # OWNS the instance, inherited machinery or not
        out.extend(_check_epoch_order(spec, mod))
        if spec.invalidation_hook:
            out.extend(_check_invalidation_hook(spec, mod))
    return out


def check(root: str) -> List[Finding]:
    out = check_specs(SPECS, root)
    out.extend(_undeclared_findings(root, SPECS))
    out.extend(connector_findings(root))
    out.extend(fleet_findings(root))
    return out
