"""The port's static-analysis plane, scoped to ``presto_tpu_torch/``.

The counterpart of the JAX package's ``tools/analyze/``: four checker
families over the port, runnable standalone and held green by
``tests/test_torch_analyze.py``::

    python -m presto_tpu_torch._devtools.analyze          # exit 0 iff clean
    python -m presto_tpu_torch._devtools.analyze --list   # suppressed too
    python -m presto_tpu_torch._devtools.analyze.metric_names

- :mod:`.tracing` — device syncs (``.item()``, ``.tolist()``,
  ``.cpu()``, ``torch.cuda.synchronize()``) outside a ``device-sync``
  span or the profiler's bracket;
- :mod:`.locks` — lock discipline (static acquisition-order cycles,
  unlocked shared-state writes, unjoined threads); the runtime half is
  ``presto_tpu_torch/_devtools/lockcheck.py``;
- :mod:`.registries` — string-keyed registry consistency (metric
  families and their unit suffixes, session properties, failpoint
  sites, alert rules, config keys, ``PRESTO_TPU_TORCH_*`` environment
  variables), each held to ``docs/torch_observability.md`` and
  ``docs/torch_static_analysis.md``;
- :mod:`.caches` — the declared contracts of the port's caches (scan,
  plan, template, result and parse caches, the ident memo, the exchange
  spool) and of the fleet's broadcast fold.

Accepted findings are suppressed by the committed ``baseline.json``,
each with its reason (see base.py for the ident contract); stale
baseline entries are errors, so a repaired finding drops its
suppression in the same change.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from . import caches, locks, registries, tracing
from .base import PKG, REPO, Finding, apply_baseline, load_baseline

CHECKERS = {
    "tracing": tracing.check,
    "locks": locks.check,
    "registries": registries.check,
    "caches": caches.check,
}

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def run(root: Optional[str] = None,
        checkers: Optional[List[str]] = None,
        baseline_path: Optional[str] = None
        ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (unsuppressed findings, suppressed findings, stale baseline
    idents)."""
    root = root or REPO
    findings: List[Finding] = []
    for name in (checkers or sorted(CHECKERS)):
        findings.extend(CHECKERS[name](root))
    baseline: Dict[str, str] = load_baseline(
        BASELINE_PATH if baseline_path is None else baseline_path)
    return apply_baseline(findings, baseline)


#: files whose edit invalidates the GLOBAL registry directions (unused
#: declarations, doc round trips): a --changed run that touched one of
#: these falls back to the full scan
_GLOBAL_INPUTS = (registries.CONFIG_PY, registries.FAILPOINTS_PY,
                  registries.SLO_PY,
                  "presto_tpu_torch/_devtools/analyze/caches.py",
                  registries.OBS_DOC)


def run_changed(files: List[str], root: Optional[str] = None,
                baseline_path: Optional[str] = None
                ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """git-diff-scoped fast mode: per-file rules run only on the changed
    set; registry rules run one way (use -> declaration) on the changed
    files unless a declaring input changed, in which case the full
    two-way scan runs. Stale-suppression detection is always skipped: a
    partial scan would report every suppression of an unscanned file as
    stale."""
    root = root or REPO
    changed = {f.replace(os.sep, "/") for f in files}
    if any(f in changed for f in _GLOBAL_INPUTS):
        findings, suppressed, _stale = run(
            root=root, baseline_path=baseline_path)
        return findings, suppressed, []

    def scoped(scope) -> List[str]:
        from .base import walk_py
        in_scope = {os.path.relpath(p, root).replace(os.sep, "/"): p
                    for p in walk_py(root, scope)}
        return [in_scope[f] for f in sorted(changed & set(in_scope))]

    findings: List[Finding] = []
    findings.extend(tracing.check_paths(scoped(tracing.SCOPE), root))
    findings.extend(locks.check_paths(scoped(locks.SCOPE), root))
    # cache contracts: only specs whose module changed (inherits= bases
    # resolve against the full registry inside check_specs), the
    # undeclared-cache sweep over changed sweep-scope files, changed
    # connectors and the fleet module
    specs = [s for s in caches.SPECS if s.module in changed]
    if specs:
        findings.extend(caches.check_specs(specs, root))
    sweep = scoped(caches.SWEEP_SCOPE)
    if sweep:
        findings.extend(caches._undeclared_findings(
            root, caches.SPECS, scan_paths=sweep))
    conn = scoped(caches.CONNECTOR_SCOPE)
    if conn:
        findings.extend(caches.connector_findings(root, scan_paths=conn))
    if caches.FLEET_MODULE in changed:
        findings.extend(caches.fleet_findings(root))
    # registries, use -> declaration direction only
    py = scoped([PKG, "chip_smoke.py"])
    if py:
        findings.extend(registries.metric_findings(
            [os.path.relpath(p, root) for p in py
             if PKG in p.replace(os.sep, "/")],
            root, doc_path=None))
        findings.extend(registries.session_prop_findings(
            root, scan_paths=py, two_way=False))
        findings.extend(registries.failpoint_findings(
            root, scan_paths=py, two_way=False))
        findings.extend(registries.env_var_findings(
            root, scan_paths=py, two_way=False))
        # config-key reads are only meaningful in the files the full
        # scan covers: `props.get(...)` elsewhere is unrelated dicts
        conf = [p for p in py
                if os.path.relpath(p, root).replace(os.sep, "/")
                in registries.CONFIG_KEY_SCAN]
        if conf:
            findings.extend(registries.config_key_findings(
                root, scan_paths=conf))
    baseline: Dict[str, str] = load_baseline(
        BASELINE_PATH if baseline_path is None else baseline_path)
    keep, dropped, _stale = apply_baseline(findings, baseline)
    return keep, dropped, []


def git_changed_files(root: Optional[str] = None) -> List[str]:
    """Working-tree delta (staged, unstaged and untracked) relative to
    HEAD: the scope of a --changed run."""
    import subprocess
    root = root or REPO
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=30, check=True
        ).stdout
    except Exception:
        return []
    files: List[str] = []
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:].strip()
        if " -> " in path:                 # rename: take the new side
            path = path.split(" -> ", 1)[1]
        files.append(path.strip('"'))
    return files
