"""Lock-discipline checker: the static half of the port's thread-contract
gate.

The counterpart of the JAX package's ``tools/analyze/locks.py`` over
``presto_tpu_torch/``. The port runs cooperating thread pools (scan
prefetcher, local-exchange producers, the fair scheduler, the cluster's
retry and heartbeat loops, the exchange spool, the announcers and fleet
heartbeats, the autoscaler's control loop, the metrics and history
sinks). This checker extracts what the AST can prove; the runtime
validator (``presto_tpu_torch/_devtools/lockcheck.py``) covers the
aliasing the AST cannot see.

Rules:

- ``lock-cycle`` — the static lock-acquisition graph has a cycle. An
  edge A->B is recorded when lock B is acquired lexically inside a
  ``with A:`` block, or when a method known (same scanned file set) to
  acquire B is called under A. Lock identity is the ``checked_lock``
  name literal when present, else ``module.Class.attr``.
- ``unlocked-global-write`` — a store to module-level mutable state
  (``X[...] = ``, ``X.attr = ``, ``X.append(...)`` on a module-level
  name) from inside a function with no lock held lexically. Reads are
  fine; a racing WRITE is how registries lose entries.
- ``unjoined-thread`` — a ``threading.Thread(...)`` creation with no
  join on any path: a local thread whose enclosing function never
  calls ``.join``, or a ``self._thread`` whose class never joins it.
  Threads that outlive their owner keep draining queues and touching
  registries through teardown.

Everything here is lexical and name-based by design: it runs in
milliseconds with no imports, the committed baseline holds the reviewed
exceptions with their reasons, and the runtime validator catches what
slips through.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import (Finding, add_parents, ancestors, dotted,
                   enclosing_symbol, parse_file, rel, str_const, walk_py)

CHECKER = "locks"

#: the threaded subsystems: the scan cache and prefetcher, local
#: exchange, the fair scheduler, the cluster (coordinator, worker, spool,
#: discovery), the runner whose state lock the cluster takes, the
#: metrics and history sinks, the serving caches and groups, the fleet
#: membership and launcher, and the autoscaler.
#: serving/resultcache.py and server/protocol.py stay runtime-validated
#: only, as in the JAX package: the module-level self-locking RESULTS
#: object and the deliberately daemon producer pool trip the lexical
#: rules here, while their checked locks feed the runtime graph.
SCOPE = ("presto_tpu_torch/exec/scancache.py",
         "presto_tpu_torch/exec/local_exchange.py",
         "presto_tpu_torch/exec/taskexec.py",
         "presto_tpu_torch/exec/cluster.py",
         "presto_tpu_torch/exec/runner.py",
         "presto_tpu_torch/exec/spool.py",
         "presto_tpu_torch/exec/discovery.py",
         "presto_tpu_torch/exec/autoscale.py",
         "presto_tpu_torch/server/worker.py",
         "presto_tpu_torch/obs/metrics.py",
         "presto_tpu_torch/obs/history.py",
         "presto_tpu_torch/serving/plancache.py",
         "presto_tpu_torch/serving/template.py",
         "presto_tpu_torch/serving/groups.py",
         "presto_tpu_torch/serving/fleet.py",
         "presto_tpu_torch/_devtools/fleet.py")

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock",
               "checked_lock", "checked_rlock"}
_THREAD_CTORS = {"threading.Thread", "Thread"}

#: method names shared with builtin containers — excluded from the
#: name-based call-through edge (a dict's .update under lock A must not
#: alias SomeRegistry.update's lock acquisitions)
_BUILTIN_METHODS = {"update", "get", "pop", "clear", "append", "add",
                    "extend", "remove", "setdefault", "keys", "values",
                    "items", "copy", "put", "insert", "discard"}


def _lock_name_from_ctor(call: ast.Call) -> Optional[str]:
    """checked_lock("name") -> its literal; plain ctor -> None (caller
    falls back to the attribute path)."""
    name = dotted(call.func) or ""
    if name.split(".")[-1] in ("checked_lock", "checked_rlock") \
            and call.args:
        return str_const(call.args[0])
    return None


class _ModuleScan:
    """Per-file lock/thread/shared-state facts."""

    def __init__(self, path: str, rpath: str):
        self.rpath = rpath
        self.module = os.path.splitext(os.path.basename(path))[0]
        self.tree = parse_file(path)
        #: 'Class.attr' (or bare 'attr' at module level) -> lock id
        self.lock_attrs: Dict[str, str] = {}
        #: method name -> set of lock ids its body acquires directly
        self.method_locks: Dict[str, Set[str]] = {}
        #: module-level assigned names (shared-state candidates)
        self.module_globals: Set[str] = set()
        if self.tree is not None:
            add_parents(self.tree)
            self._collect()

    # -- collection -----------------------------------------------------------
    def _enclosing_class(self, node: ast.AST) -> Optional[str]:
        for anc in ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc.name
        return None

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign):
                continue
            if isinstance(getattr(node, "parent", None), ast.Module):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_globals.add(tgt.id)
            if not isinstance(node.value, ast.Call):
                continue
            ctor = (dotted(node.value.func) or "").split(".")[-1]
            if ctor == "Condition" and node.value.args:
                # `self._cv = threading.Condition(self._lock)` — the
                # condition IS that lock; `with self._cv:` must resolve
                # to the wrapped lock's id (walk order guarantees the
                # lock's own assignment, earlier in __init__, was seen)
                lid = self.lock_id_of(node.value.args[0])
                if lid is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            cls = self._enclosing_class(tgt) or "?"
                            self.lock_attrs[f"{cls}.{tgt.attr}"] = lid
                        elif isinstance(tgt, ast.Name):
                            self.lock_attrs[tgt.id] = lid
                continue
            if ctor not in {"Lock", "RLock", "checked_lock",
                            "checked_rlock"}:
                continue
            lock_id = _lock_name_from_ctor(node.value)
            for tgt in node.targets:
                key = None
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    cls = self._enclosing_class(tgt) or "?"
                    key = f"{cls}.{tgt.attr}"
                elif isinstance(tgt, ast.Name):
                    key = tgt.id
                if key is not None:
                    self.lock_attrs[key] = (
                        lock_id or f"{self.module}.{key}")

    # -- lock-expression resolution ------------------------------------------
    def lock_id_of(self, expr: ast.expr) -> Optional[str]:
        """The lock id a ``with <expr>:`` (or ``<expr>.acquire()``)
        acquires, if <expr> names a known lock attribute."""
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self."):
            attr = d[len("self."):]
            cls = self._enclosing_class(expr)
            return self.lock_attrs.get(f"{cls}.{attr}") \
                or self._any_class_lock(attr)
        return self.lock_attrs.get(d)

    def _any_class_lock(self, attr: str) -> Optional[str]:
        # `self._lock` used in a nested helper class we misattributed:
        # fall back to a unique attr match across classes
        hits = {v for k, v in self.lock_attrs.items()
                if k.split(".")[-1] == attr}
        return next(iter(hits)) if len(hits) == 1 else None


def _with_lock_items(scan: _ModuleScan, node: ast.With) -> List[str]:
    out = []
    for item in node.items:
        ctx = item.context_expr
        # `with self._lock:` / `with LOCK:` / `with self._cv:` (a
        # Condition built over an engine lock counts as that lock)
        lid = scan.lock_id_of(ctx)
        if lid is None and isinstance(ctx, ast.Call):
            lid = scan.lock_id_of(ctx.func) \
                if isinstance(ctx.func, ast.Attribute) else None
        if lid is not None:
            out.append(lid)
    return out


def _held_locks(scan: _ModuleScan, node: ast.AST) -> List[str]:
    """Lock ids of every enclosing ``with`` that acquires a known lock."""
    held: List[str] = []
    for anc in ancestors(node):
        if isinstance(anc, ast.With):
            held.extend(_with_lock_items(scan, anc))
    return held


def _collect_method_locks(scan: _ModuleScan) -> None:
    """method/function name -> lock ids acquired anywhere in its body
    (``with`` or ``.acquire()``)."""
    if scan.tree is None:
        return
    for node in ast.walk(scan.tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        acquired: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.With):
                acquired.update(_with_lock_items(scan, sub))
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "acquire":
                lid = scan.lock_id_of(sub.func.value)
                if lid:
                    acquired.add(lid)
        if acquired:
            prev = scan.method_locks.setdefault(node.name, set())
            prev.update(acquired)


def _edges_for(scan: _ModuleScan,
               all_method_locks: Dict[str, Set[str]]
               ) -> Dict[Tuple[str, str], Tuple[str, int]]:
    """(held, acquired) -> (path, line) — direct nesting plus one level
    of call-through using the cross-file method->locks map."""
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    if scan.tree is None:
        return edges
    for node in ast.walk(scan.tree):
        if isinstance(node, ast.With):
            inner = _with_lock_items(scan, node)
            if not inner:
                continue
            held = _held_locks(scan, node)
            for h in held:
                for i in inner:
                    if h != i:
                        edges.setdefault((h, i),
                                         (scan.rpath, node.lineno))
        elif isinstance(node, ast.Call):
            held = _held_locks(scan, node)
            if not held:
                continue
            # a call made under a lock, to a method that acquires locks
            callee = None
            if isinstance(node.func, ast.Attribute):
                # skip computed receivers (``self._nodes[nid].update``
                # is a dict method, not our TaskRegistry.update) and
                # builtin-container method names — name-based matching
                # can't tell them apart; the runtime validator covers
                # real cross-object calls the AST misattributes
                if isinstance(node.func.value, (ast.Subscript, ast.Call)):
                    continue
                if node.func.attr in _BUILTIN_METHODS:
                    continue
                callee = node.func.attr
            elif isinstance(node.func, ast.Name):
                callee = node.func.id
            for lid in all_method_locks.get(callee or "", ()):
                for h in held:
                    if h != lid:
                        edges.setdefault((h, lid),
                                         (scan.rpath, node.lineno))
    return edges


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]
                 ) -> List[List[str]]:
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    state: Dict[str, int] = {}
    path: List[str] = []
    cycles: List[List[str]] = []
    seen: Set[frozenset] = set()

    def visit(n: str) -> None:
        state[n] = 0
        path.append(n)
        for m in adj.get(n, ()):
            if state.get(m) == 0:
                cyc = path[path.index(m):] + [m]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif m not in state:
                visit(m)
        path.pop()
        state[n] = 1

    for n in sorted(adj):
        if n not in state:
            visit(n)
    return cycles


# -- unjoined threads --------------------------------------------------------

def _thread_findings(scan: _ModuleScan) -> List[Finding]:
    out: List[Finding] = []
    if scan.tree is None:
        return out

    for node in ast.walk(scan.tree):
        if not (isinstance(node, ast.Call)
                and (dotted(node.func) or "").split(".")[-1] == "Thread"
                and (dotted(node.func) in _THREAD_CTORS)):
            continue
        parent = getattr(node, "parent", None)
        sym = enclosing_symbol(node)

        # `threading.Thread(...).start()` — never bound, never joined
        if isinstance(parent, ast.Attribute) and parent.attr == "start":
            out.append(Finding(
                CHECKER, "unjoined-thread", scan.rpath, node.lineno,
                f"{sym}.start",
                "Thread(...).start() is never bound — no close path "
                "can ever join it"))
            continue

        # find the name it's bound to (self.attr / local / list elem)
        attr = local = None
        for anc in ancestors(node):
            if isinstance(anc, ast.Assign):
                tgt = anc.targets[0]
                d = dotted(tgt)
                if d and d.startswith("self."):
                    attr = d[len("self."):]
                elif isinstance(tgt, ast.Name):
                    local = tgt.id
                break
            if isinstance(anc, (ast.FunctionDef, ast.ClassDef)):
                break

        if attr is not None:
            # joined anywhere in the file? (`self._thread.join(`)
            joined = \
                any(isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "join"
                    and (dotted(n.func.value) or "").endswith(attr)
                    for n in ast.walk(scan.tree))
            if not joined:
                out.append(Finding(
                    CHECKER, "unjoined-thread", scan.rpath, node.lineno,
                    f"{sym}.{attr}",
                    f"thread self.{attr} is started but no method ever "
                    f"joins it — stop/close paths must join so the "
                    f"loop can't touch shared state past teardown"))
        else:
            # local (or list-comprehended) thread: a `.join(` call on a
            # plain NAME in the same enclosing function counts — the
            # receiver must be a variable (`t.join()`, `w.join()` in a
            # loop over the thread list), so `", ".join(parts)` or
            # other non-thread joins can't mask a leaked thread
            fn = next((a for a in ancestors(node)
                       if isinstance(a, ast.FunctionDef)), None)
            haystack = fn if fn is not None else scan.tree
            joined = any(isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr == "join"
                         and isinstance(n.func.value, ast.Name)
                         for n in ast.walk(haystack))
            if not joined:
                out.append(Finding(
                    CHECKER, "unjoined-thread", scan.rpath, node.lineno,
                    f"{sym}.{local or '<anon>'}",
                    f"thread {local or '<anonymous>'} created in "
                    f"{sym!r} has no join on any path"))
    return out


# -- unlocked shared writes --------------------------------------------------

def _global_write_findings(scan: _ModuleScan) -> List[Finding]:
    out: List[Finding] = []
    if scan.tree is None:
        return out
    #: module-level locks themselves aren't shared *state*
    skip = set(scan.module_globals) & set(scan.lock_attrs)

    for node in ast.walk(scan.tree):
        in_function = any(isinstance(a, ast.FunctionDef)
                          for a in ancestors(node))
        if not in_function:
            continue
        target: Optional[ast.expr] = None
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                    base = tgt.value
                    d = dotted(base)
                    if d in scan.module_globals and d not in skip:
                        target = tgt
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("append", "add", "update",
                                       "setdefault", "pop", "clear",
                                       "extend", "remove"):
            d = dotted(node.func.value)
            if d in scan.module_globals and d not in skip:
                target = node.func
        if target is None:
            continue
        if _held_locks(scan, node):
            continue
        d = dotted(target.value if isinstance(
            target, (ast.Subscript, ast.Attribute)) else target) or "?"
        sym = enclosing_symbol(node)
        out.append(Finding(
            CHECKER, "unlocked-global-write", scan.rpath, node.lineno,
            f"{sym}.{d}",
            f"write to module-level {d!r} from {sym!r} with no lock "
            f"held — racing writes drop entries silently"))
    return out


# -- entry points ------------------------------------------------------------

def check_paths(paths: Sequence[str], root: str) -> List[Finding]:
    scans = [_ModuleScan(p, rel(p, root)) for p in paths]
    out: List[Finding] = []

    all_method_locks: Dict[str, Set[str]] = {}
    for s in scans:
        _collect_method_locks(s)
        for m, locks in s.method_locks.items():
            all_method_locks.setdefault(m, set()).update(locks)

    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for s in scans:
        if s.tree is None:
            out.append(Finding(CHECKER, "parse-error", s.rpath, 1,
                               "<module>", "file does not parse"))
            continue
        for k, v in _edges_for(s, all_method_locks).items():
            edges.setdefault(k, v)
        out.extend(_thread_findings(s))
        out.extend(_global_write_findings(s))

    for cyc in _find_cycles(edges):
        where, line = edges.get((cyc[0], cyc[1]), ("<multiple>", 0))
        out.append(Finding(
            CHECKER, "lock-cycle", where, line,
            "->".join(sorted(set(cyc))),
            "lock-order cycle in the static acquisition graph: "
            + " -> ".join(cyc)))
    return out


def check(root: str, scope: Sequence[str] = SCOPE) -> List[Finding]:
    return check_paths(sorted(set(walk_py(root, scope))), root)
