"""Shared plumbing of the port's static-analysis plane.

The counterpart of the JAX package's ``tools/analyze/base.py``, scoped to
``presto_tpu_torch/``: the checkers keep the port's thread-pool lock
discipline, its string-keyed registries (where a typo is a silent no-op),
its cache contracts and its device-sync bracketing honest.

Contracts every checker follows:

- ``check(root)`` walks its declared scope under the repo root and
  returns :class:`Finding`\\ s. Checkers are pure AST walkers: they never
  import the engine, so they run in milliseconds and cannot be confused
  by the environment (no torch, no device).
- A finding's :attr:`Finding.ident` is stable across unrelated edits:
  ``checker:rule:path:symbol`` (no line numbers), where ``symbol`` is the
  enclosing function/class qualname or the offending token. The
  committed ``baseline.json`` suppresses by ident, each entry with its
  reason, so an accepted finding does not block while any NEW instance
  of the same rule elsewhere still fails.
- Stale baseline entries (nothing matches anymore) are errors: when a
  finding is fixed, its suppression is deleted in the same change.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: the package every scope lies in
PKG = "presto_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str      # tracing | locks | registries | caches
    rule: str         # e.g. lock-cycle, unknown-session-prop
    path: str         # repo-relative, forward slashes
    line: int
    symbol: str       # enclosing qualname / offending token (ident key)
    message: str

    @property
    def ident(self) -> str:
        return f"{self.checker}:{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.message}")


def rel(path: str, root: Optional[str] = None) -> str:
    return os.path.relpath(path, root or REPO).replace(os.sep, "/")


#: (path, mtime, size) -> parsed module: the registry lints read every
#: file of the package once per registry, so a scan parses each once
_TREES: Dict[Tuple[str, int, int], Optional[ast.Module]] = {}


def parse_file(path: str) -> Optional[ast.Module]:
    """The file's module AST, or None when it does not parse. Trees are
    shared between checkers (``add_parents`` only annotates them)."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if key not in _TREES:
        with open(path, encoding="utf-8", errors="replace") as f:
            src = f.read()
        try:
            _TREES[key] = ast.parse(src, filename=path)
        except SyntaxError:
            _TREES[key] = None
    return _TREES[key]


def walk_py(root: str, subpaths: Iterable[str]) -> Iterator[str]:
    """Yield .py files under ``root`` for each subpath (a directory is
    walked recursively, a file yielded as-is; missing entries skipped so
    checkers degrade gracefully on fixture trees)."""
    for sub in subpaths:
        p = os.path.join(root, sub)
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def add_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.parent`` (ast has no uplinks)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "parent", None)


def enclosing_symbol(node: ast.AST) -> str:
    """Dotted qualname of the enclosing defs/classes, '<module>' at
    top level — the stable half of a finding ident."""
    names: List[str] = []
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(anc.name)
    return ".".join(reversed(names)) or "<module>"


def dotted(node: ast.expr) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, str]:
    """ident -> reason. Missing file = empty baseline."""
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    doc = json.loads(text) if text else {}
    out: Dict[str, str] = {}
    for entry in doc.get("suppressions", ()):
        out[entry["id"]] = entry.get("reason", "")
    return out


def apply_baseline(findings: List[Finding], baseline: Dict[str, str]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (unsuppressed, suppressed, stale baseline idents)."""
    hit: set = set()
    keep: List[Finding] = []
    dropped: List[Finding] = []
    for f in findings:
        if f.ident in baseline:
            hit.add(f.ident)
            dropped.append(f)
        else:
            keep.append(f)
    stale = sorted(set(baseline) - hit)
    return keep, dropped, stale
