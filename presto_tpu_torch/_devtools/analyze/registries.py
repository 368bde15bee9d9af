"""Registry-consistency lints over the port: one framework for every
string-keyed registry where a typo is a silent no-op.

The counterpart of the JAX package's ``tools/analyze/registries.py``,
scoped to ``presto_tpu_torch/`` and held to the port's own documents,
``docs/torch_observability.md`` (metric families, alert rules) and
``docs/torch_static_analysis.md`` (the other tables). Every literal USE
site must resolve to exactly one DECLARATION, every declaration must be
used, and the documents' tables must round-trip against the code:

- **metric families** (``obs/metrics.py`` create-on-first-use):
  ``snake_case`` with a unit suffix, one type per family, and every
  family documented (the metric-name lint, also
  ``python -m presto_tpu_torch._devtools.analyze.metric_names``).
- **session properties** (``config.SESSION_PROPERTIES``, declared via
  ``_sp(...)``): every ``session.properties.get("...")`` /
  ``bool_property(session, "...")`` / ``properties["..."]`` literal must
  be declared, every declaration read, and the "Session-property" table
  must match two-way.
- **failpoint sites** (``exec/failpoints.SITES``): every
  ``FAILPOINTS.hit("...")`` literal must be a declared site, every site
  must have a hit, and the "Failpoint catalog" table must match.
- **alert rules** (``obs/slo.ALERT_RULES``): every literal
  ``alert_rule("...")`` must name a declared rule, every rule must be
  used, and the "Alert rules" table must match.
- **config keys** (``config.CONFIG_KEYS``): literals read off parsed
  ``*.properties`` dicts in config.py / plugin.py / the SQLite connector
  must be declared (``session.*``-style globs supported).
- **environment variables** (``config.ENV_VARS``): every
  ``os.environ.get/[...]/setdefault`` / ``os.getenv`` of a
  ``PRESTO_TPU_TORCH_*`` name in the port or its chip script must be
  declared, every declaration read, and the "Environment-variable" table
  must match. An undeclared knob "works" on the machine that exports it
  and silently does nothing anywhere else.

All checks are AST/regex static: no engine import.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import (PKG, Finding, dotted, parse_file, rel, str_const,
                   walk_py)

CHECKER = "registries"

CONFIG_PY = "presto_tpu_torch/config.py"
FAILPOINTS_PY = "presto_tpu_torch/exec/failpoints.py"
SLO_PY = "presto_tpu_torch/obs/slo.py"
EXPOSITION_PY = "presto_tpu_torch/obs/exposition.py"
#: the port's documents: metric families and alert rules; the session
#: property, failpoint and environment-variable tables
OBS_DOC = "docs/torch_observability.md"
ANALYSIS_DOC = "docs/torch_static_analysis.md"
ROBUSTNESS_DOC = ANALYSIS_DOC

#: where config-file keys (java.util.Properties style) are read
CONFIG_KEY_SCAN = (CONFIG_PY, "presto_tpu_torch/plugin.py",
                   "presto_tpu_torch/connectors/sqlite.py")


# -- metric families (the check_metric_names.py rules) -----------------------

_METRIC_KINDS = ("counter", "gauge", "histogram")
_SNAKE = re.compile(r"^[a-z][a-z0-9_]*(\*[a-z0-9_]*)*$")
# _ratio is Prometheus's canonical suffix for unitless 0..1 fractions
# (SLO burn rates / error budgets)
_UNIT_SUFFIXES = ("_total", "_seconds", "_bytes", "_ratio")

#: doc tokens that share the unit-suffix shape but are SQL column
#: names, not metric families
_DOC_IGNORE = {"hbm_bytes", "peak_memory_bytes", "output_bytes",
               "arg_bytes", "temp_bytes", "generated_code_bytes",
               "mem_pool_peak_bytes"}

_DOC_FAMILY = re.compile(
    r"^[a-z][a-z0-9_]*_(?:total|seconds|bytes|ratio)$")


def _name_pattern(arg: ast.expr) -> Optional[str]:
    """Metric-name argument as a pattern: literals verbatim, f-string
    interpolations collapsed to ``*``, fully dynamic -> None."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _check_metric_name(pattern: str) -> Optional[str]:
    family = pattern.split(".", 1)[0]
    if not _SNAKE.match(family.replace("*", "x")):
        return f"{pattern!r}: family {family!r} is not snake_case"
    if not family.endswith(_UNIT_SUFFIXES):
        return (f"{pattern!r}: family {family!r} lacks a unit suffix "
                f"({'/'.join(_UNIT_SUFFIXES)})")
    return None


def metric_sites(path: str) -> Tuple[List[Tuple[str, str, int]], bool]:
    """([(pattern, kind, lineno)], parsed_ok) for counter(/gauge(/
    histogram( calls — a syntax-broken file must FAIL the lint, not be
    silently skipped with its call sites unchecked."""
    tree = parse_file(path)
    if tree is None:
        return [], False
    out: List[Tuple[str, str, int]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_KINDS and node.args):
            continue
        pattern = _name_pattern(node.args[0])
        if pattern is not None:
            out.append((pattern, node.func.attr, node.lineno))
    return out, True


def exposition_families(path: str) -> Set[str]:
    """Literal ``family("...", ...)`` series the Prometheus exposition
    constructs directly — documented scrape series with no registry
    call site."""
    tree = parse_file(path) if os.path.isfile(path) else None
    if tree is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.func, ast.Name) \
                and node.func.id == "family":
            pattern = _name_pattern(node.args[0])
            if pattern:
                out.add(pattern)
    return out


def doc_metric_families(doc_path: str) -> Set[str]:
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    out: Set[str] = set()
    for token in re.findall(r"`([^`\n]+)`", text):
        fam = re.split(r"[.{\s(]", token.strip(), maxsplit=1)[0]
        if fam not in _DOC_IGNORE \
                and _DOC_FAMILY.match(fam.replace("*", "x")):
            out.add(fam)
    return out


def metric_findings(src_roots: Sequence[str], root: str,
                    doc_path: Optional[str] = None,
                    exposition_path: Optional[str] = None
                    ) -> List[Finding]:
    findings: List[Finding] = []
    families: Dict[str, Tuple[str, str]] = {}   # family -> (kind, where)
    for path in walk_py(root, [os.path.relpath(r, root)
                               if os.path.isabs(r) else r
                               for r in src_roots]):
        rpath = rel(path, root)
        sites, parsed = metric_sites(path)
        if not parsed:
            findings.append(Finding(
                CHECKER, "parse-error", rpath, 1, "<module>",
                "file does not parse — its metric call sites are "
                "unchecked"))
            continue
        for pattern, kind, lineno in sites:
            bad = _check_metric_name(pattern)
            if bad:
                findings.append(Finding(
                    CHECKER, "bad-metric-name", rpath, lineno,
                    pattern, bad))
                continue
            family = pattern.split(".", 1)[0]
            prev = families.get(family)
            if prev is not None and prev[0] != kind:
                findings.append(Finding(
                    CHECKER, "metric-type-conflict", rpath, lineno,
                    family,
                    f"{family!r} registered as {kind} but as "
                    f"{prev[0]} at {prev[1]}"))
            elif prev is None:
                families[family] = (kind, f"{rpath}:{lineno}")

    if doc_path and os.path.isfile(doc_path):
        expo = exposition_families(
            exposition_path or os.path.join(root, EXPOSITION_PY))
        known = set(families) | expo
        documented = doc_metric_families(doc_path)
        doc_rel = rel(doc_path, root)
        for fam in sorted(documented):
            if not any(fnmatch.fnmatch(fam, pat) or fam == pat
                       for pat in known):
                findings.append(Finding(
                    CHECKER, "metric-doc-drift", doc_rel, 1, fam,
                    f"documents {fam!r} but no such metric family is "
                    f"registered in code"))
        for pat in sorted(families):
            if pat in documented or any(
                    fnmatch.fnmatch(fam, pat) for fam in documented):
                continue
            findings.append(Finding(
                CHECKER, "metric-doc-drift", doc_rel, 1, pat,
                f"metric family {pat!r} is registered in code but not "
                f"documented in {doc_rel}"))
    return findings


# -- doc-table helper --------------------------------------------------------

def doc_table_tokens(doc_path: str, section_marker: str) -> Set[str]:
    """First-cell backticked tokens of the markdown table inside the
    section whose header line starts with ``section_marker``."""
    if not os.path.isfile(doc_path):
        return set()
    out: Set[str] = set()
    in_section = False
    with open(doc_path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("#") and in_section:
                break
            if line.startswith(section_marker):
                in_section = True
                continue
            if in_section and line.lstrip().startswith("|"):
                cells = [c.strip() for c in line.strip().strip("|")
                         .split("|")]
                if cells:
                    m = re.match(r"^`([^`]+)`$", cells[0])
                    if m:
                        out.add(m.group(1))
    return out


# -- session properties ------------------------------------------------------

def declared_session_props(config_path: str) -> Dict[str, int]:
    """name -> lineno of every ``_sp("name", ...)`` declaration."""
    tree = parse_file(config_path)
    out: Dict[str, int] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Name) \
                and node.func.id == "_sp" and node.args:
            name = str_const(node.args[0])
            if name:
                out[name] = node.lineno
    return out


def session_prop_uses(paths: Sequence[str], root: str
                      ) -> List[Tuple[str, str, int]]:
    """[(prop, rpath, lineno)] literal read/write sites:
    ``<x>.properties.get("p")`` / ``<x>.properties["p"]`` (read or
    write) / ``bool_property(s, "p", ...)`` / ``props.get("p")`` where
    ``props`` was assigned from ``<x>.properties`` in the same file."""
    out: List[Tuple[str, str, int]] = []
    for path in paths:
        tree = parse_file(path)
        if tree is None:
            continue
        rpath = rel(path, root)
        #: local aliases of a session-properties dict
        aliases: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr == "properties":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        aliases.add(tgt.id)
        #: local prop-reader helpers: ``def _int_prop(name, d): ...
        #: session.properties.get(name, d)`` — a call with a literal
        #: first arg is a session-prop use
        readers: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef) or not node.args.args:
                continue
            first = node.args.args[0].arg
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and sub.args \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "get" \
                        and isinstance(sub.args[0], ast.Name) \
                        and sub.args[0].id == first:
                    based = dotted(sub.func.value) or ""
                    if based.endswith(".properties") or based in aliases:
                        readers.add(node.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args:
                fname = dotted(node.func) or ""
                if fname.split(".")[-1] == "bool_property" \
                        and len(node.args) >= 2:
                    name = str_const(node.args[1])
                    if name:
                        out.append((name, rpath, node.lineno))
                elif fname in readers:
                    name = str_const(node.args[0])
                    if name:
                        out.append((name, rpath, node.lineno))
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("get", "pop"):
                    base = node.func.value
                    based = dotted(base) or ""
                    if based.endswith(".properties") \
                            or based in aliases:
                        name = str_const(node.args[0])
                        if name:
                            out.append((name, rpath, node.lineno))
            elif isinstance(node, ast.Subscript):
                based = dotted(node.value) or ""
                if based.endswith(".properties") or based in aliases:
                    name = str_const(node.slice)
                    if name:
                        out.append((name, rpath, node.lineno))
    return out


def session_prop_findings(root: str,
                          scan_paths: Optional[Sequence[str]] = None,
                          config_path: Optional[str] = None,
                          doc_path: Optional[str] = None,
                          two_way: bool = True
                          ) -> List[Finding]:
    """``two_way=False`` (the --changed fast path) checks only the
    use->declaration direction: a partial scan can prove an unknown
    read, but would falsely report every unscanned declaration as
    unused and every doc row as drift."""
    config_path = config_path or os.path.join(root, CONFIG_PY)
    declared = declared_session_props(config_path)
    paths = (list(scan_paths) if scan_paths is not None
             else sorted(set(walk_py(root, [PKG]))))
    uses = session_prop_uses(paths, root)
    out: List[Finding] = []
    used_names: Set[str] = set()
    for name, rpath, line in uses:
        used_names.add(name)
        if name not in declared:
            out.append(Finding(
                CHECKER, "unknown-session-prop", rpath, line, name,
                f"session property {name!r} is read here but never "
                f"declared in config.SESSION_PROPERTIES — the read "
                f"can only ever see its hardcoded default"))
    if not two_way:
        return out
    cfg_rel = rel(config_path, root)
    for name, line in sorted(declared.items()):
        if name not in used_names:
            out.append(Finding(
                CHECKER, "unused-session-prop", cfg_rel, line, name,
                f"session property {name!r} is declared but no code "
                f"reads it — SET SESSION on it silently does nothing"))

    doc = doc_path if doc_path is not None \
        else os.path.join(root, ANALYSIS_DOC)
    if os.path.isfile(doc):
        doc_rel = rel(doc, root)
        documented = doc_table_tokens(doc, "## Session-property")
        for name in sorted(set(declared) - documented):
            out.append(Finding(
                CHECKER, "session-prop-doc-drift", doc_rel, 1, name,
                f"declared session property {name!r} missing from the "
                f"table in {doc_rel}"))
        for name in sorted(documented - set(declared)):
            out.append(Finding(
                CHECKER, "session-prop-doc-drift", doc_rel, 1, name,
                f"{doc_rel} documents unknown session property "
                f"{name!r}"))
    return out


# -- failpoint sites ---------------------------------------------------------

def _module_dict_keys(path: str, var_name: str) -> Dict[str, int]:
    """Literal string keys of a module-level ``VAR = {...}`` (plain or
    annotated assignment) -> lineno."""
    tree = parse_file(path)
    out: Dict[str, int] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == var_name
                   for t in targets) \
                or not isinstance(value, ast.Dict):
            continue
        for k in value.keys:
            name = str_const(k) if k is not None else None
            if name:
                out[name] = k.lineno
    return out


def declared_failpoint_sites(failpoints_path: str) -> Dict[str, int]:
    """SITES = {"name": ...} keys -> lineno."""
    return _module_dict_keys(failpoints_path, "SITES")


def failpoint_hits(paths: Sequence[str], root: str
                   ) -> List[Tuple[str, str, int]]:
    """[(site, rpath, lineno)] for ``<x>.hit("site", ...)`` calls on a
    FAILPOINTS-ish receiver."""
    out: List[Tuple[str, str, int]] = []
    for path in paths:
        tree = parse_file(path)
        if tree is None:
            continue
        rpath = rel(path, root)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "hit":
                based = (dotted(node.func.value) or "")
                if "FAILPOINTS" not in based.upper():
                    continue
                name = str_const(node.args[0])
                if name:
                    out.append((name, rpath, node.lineno))
    return out


def failpoint_findings(root: str,
                       scan_paths: Optional[Sequence[str]] = None,
                       failpoints_path: Optional[str] = None,
                       doc_path: Optional[str] = None,
                       two_way: bool = True
                       ) -> List[Finding]:
    failpoints_path = failpoints_path \
        or os.path.join(root, FAILPOINTS_PY)
    declared = declared_failpoint_sites(failpoints_path)
    paths = (list(scan_paths) if scan_paths is not None
             else sorted(set(walk_py(root, [PKG]))))
    hits = failpoint_hits(paths, root)
    out: List[Finding] = []
    hit_names: Set[str] = set()
    for name, rpath, line in hits:
        hit_names.add(name)
        if name not in declared:
            out.append(Finding(
                CHECKER, "unknown-failpoint-site", rpath, line, name,
                f"FAILPOINTS.hit({name!r}) names a site missing from "
                f"failpoints.SITES — configure() would reject arming "
                f"it, so it can never fire"))
    if not two_way:
        return out
    fp_rel = rel(failpoints_path, root)
    for name, line in sorted(declared.items()):
        if name not in hit_names:
            out.append(Finding(
                CHECKER, "unhit-failpoint-site", fp_rel, line, name,
                f"declared failpoint site {name!r} has no "
                f"FAILPOINTS.hit() call — arming it injects nothing"))

    doc = doc_path if doc_path is not None \
        else os.path.join(root, ROBUSTNESS_DOC)
    if os.path.isfile(doc):
        doc_rel = rel(doc, root)
        documented = doc_table_tokens(doc, "## Failpoint catalog")
        for name in sorted(set(declared) - documented):
            out.append(Finding(
                CHECKER, "failpoint-doc-drift", doc_rel, 1, name,
                f"failpoint site {name!r} missing from the catalog "
                f"table in {doc_rel}"))
        for name in sorted(documented - set(declared)):
            out.append(Finding(
                CHECKER, "failpoint-doc-drift", doc_rel, 1, name,
                f"{doc_rel} catalogs unknown failpoint site {name!r}"))
    return out


# -- alert rules -------------------------------------------------------------

def declared_alert_rules(slo_path: str) -> Dict[str, int]:
    """ALERT_RULES = {"name": ...} keys -> lineno (obs/slo.py)."""
    return _module_dict_keys(slo_path, "ALERT_RULES")


def alert_rule_uses(paths: Sequence[str], root: str
                    ) -> List[Tuple[str, str, int]]:
    """[(rule, rpath, lineno)] for literal ``alert_rule("...")`` calls
    (plain or attribute-qualified)."""
    out: List[Tuple[str, str, int]] = []
    for path in paths:
        tree = parse_file(path)
        if tree is None:
            continue
        rpath = rel(path, root)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None)
            if name != "alert_rule":
                continue
            rule = str_const(node.args[0])
            if rule:
                out.append((rule, rpath, node.lineno))
    return out


def alert_rule_findings(root: str,
                        scan_paths: Optional[Sequence[str]] = None,
                        slo_path: Optional[str] = None,
                        doc_path: Optional[str] = None,
                        two_way: bool = True) -> List[Finding]:
    """Alert-name registry lint, same contract as the failpoint sites:
    every literal ``alert_rule("...")`` must name a declared
    ``ALERT_RULES`` entry (obs/slo.py raises on unknown names at
    runtime, but only when that code path runs — the lint catches the
    typo before a page never fires), every declared rule must have a
    use, and the "## Alert rules" table of the port's document must
    round-trip two-way."""
    slo_path = slo_path or os.path.join(root, SLO_PY)
    declared = declared_alert_rules(slo_path)
    paths = (list(scan_paths) if scan_paths is not None
             else sorted(set(walk_py(root, [PKG]))))
    uses = alert_rule_uses(paths, root)
    out: List[Finding] = []
    used: Set[str] = set()
    for rule, rpath, line in uses:
        used.add(rule)
        if rule not in declared:
            out.append(Finding(
                CHECKER, "unknown-alert-rule", rpath, line, rule,
                f"alert_rule({rule!r}) names a rule missing from "
                f"slo.ALERT_RULES — the tracker would raise instead "
                f"of alerting"))
    if not two_way:
        return out
    slo_rel = rel(slo_path, root)
    for rule, line in sorted(declared.items()):
        if rule not in used:
            out.append(Finding(
                CHECKER, "unused-alert-rule", slo_rel, line, rule,
                f"declared alert rule {rule!r} has no alert_rule() "
                f"use — it can never fire"))
    doc = doc_path if doc_path is not None \
        else os.path.join(root, OBS_DOC)
    if os.path.isfile(doc):
        doc_rel = rel(doc, root)
        documented = doc_table_tokens(doc, "## Alert rules")
        for rule in sorted(set(declared) - documented):
            out.append(Finding(
                CHECKER, "alert-rule-doc-drift", doc_rel, 1, rule,
                f"alert rule {rule!r} missing from the Alert rules "
                f"table in {doc_rel}"))
        for rule in sorted(documented - set(declared)):
            out.append(Finding(
                CHECKER, "alert-rule-doc-drift", doc_rel, 1, rule,
                f"{doc_rel} documents unknown alert rule {rule!r}"))
    return out


# -- config keys -------------------------------------------------------------

def declared_config_keys(config_path: str) -> Dict[str, int]:
    """CONFIG_KEYS = {"key-or-glob": "doc"} -> lineno."""
    return _module_dict_keys(config_path, "CONFIG_KEYS")


def config_key_findings(root: str,
                        scan_paths: Optional[Sequence[str]] = None,
                        config_path: Optional[str] = None
                        ) -> List[Finding]:
    config_path = config_path or os.path.join(root, CONFIG_PY)
    declared = declared_config_keys(config_path)
    if not declared:
        return [Finding(CHECKER, "unknown-config-key",
                        rel(config_path, root), 1, "CONFIG_KEYS",
                        "config.py declares no CONFIG_KEYS table")]
    paths = list(scan_paths) if scan_paths is not None else [
        os.path.join(root, p) for p in CONFIG_KEY_SCAN]
    out: List[Finding] = []
    for path in paths:
        tree = parse_file(path) if os.path.isfile(path) else None
        if tree is None:
            continue
        rpath = rel(path, root)
        sites: List[Tuple[str, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and (dotted(node.func.value) or "") == "props":
                name = str_const(node.args[0])
                if name:
                    sites.append((name, node.lineno))
            elif isinstance(node, ast.Subscript) \
                    and (dotted(node.value) or "") == "props":
                name = str_const(node.slice)
                if name:
                    sites.append((name, node.lineno))
        for name, line in sites:
            if not any(fnmatch.fnmatch(name, pat) or name == pat
                       for pat in declared):
                out.append(Finding(
                    CHECKER, "unknown-config-key", rpath, line, name,
                    f"config key {name!r} is read here but not "
                    f"declared in config.CONFIG_KEYS"))
    return out


# -- environment variables ---------------------------------------------------

#: reads of names with these prefixes must resolve to an ENV_VARS entry
ENV_ENFORCED_PREFIXES = ("PRESTO_TPU_TORCH_",)

#: where env vars are read (the port and its chip script; tests may
#: export whatever their harness needs)
ENV_SCAN = (PKG, "chip_smoke.py")


def declared_env_vars(config_path: str) -> Dict[str, int]:
    """ENV_VARS = {"NAME": "doc"} -> lineno."""
    return _module_dict_keys(config_path, "ENV_VARS")


def env_var_reads(paths: Sequence[str], root: str
                  ) -> List[Tuple[str, str, int]]:
    """[(name, rpath, lineno)] for ``os.environ.get("X")`` /
    ``os.environ["X"]`` / ``os.environ.setdefault("X", ...)`` /
    ``os.getenv("X")`` literal sites."""
    out: List[Tuple[str, str, int]] = []
    for path in paths:
        tree = parse_file(path)
        if tree is None:
            continue
        rpath = rel(path, root)
        for node in ast.walk(tree):
            name = None
            if isinstance(node, ast.Call) and node.args:
                fname = dotted(node.func) or ""
                if fname in ("os.getenv", "getenv"):
                    name = str_const(node.args[0])
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("get", "setdefault", "pop") \
                        and (dotted(node.func.value) or "") \
                        .endswith("environ"):
                    name = str_const(node.args[0])
            elif isinstance(node, ast.Subscript) \
                    and (dotted(node.value) or "").endswith("environ"):
                name = str_const(node.slice)
            if name:
                out.append((name, rpath, node.lineno))
    return out


def env_var_findings(root: str,
                     scan_paths: Optional[Sequence[str]] = None,
                     config_path: Optional[str] = None,
                     doc_path: Optional[str] = None,
                     two_way: bool = True) -> List[Finding]:
    config_path = config_path or os.path.join(root, CONFIG_PY)
    declared = declared_env_vars(config_path)
    paths = (list(scan_paths) if scan_paths is not None
             else sorted(set(walk_py(root, ENV_SCAN))))
    reads = env_var_reads(paths, root)
    out: List[Finding] = []
    read_names: Set[str] = set()
    for name, rpath, line in reads:
        read_names.add(name)
        if name.startswith(ENV_ENFORCED_PREFIXES) \
                and name not in declared:
            out.append(Finding(
                CHECKER, "unknown-env-var", rpath, line, name,
                f"environment variable {name!r} is read here but not "
                f"declared in config.ENV_VARS — an exported knob "
                f"nobody can discover, or a typo that silently reads "
                f"nothing"))
    if not two_way:
        return out
    cfg_rel = rel(config_path, root)
    for name, line in sorted(declared.items()):
        if name not in read_names:
            out.append(Finding(
                CHECKER, "unused-env-var", cfg_rel, line, name,
                f"environment variable {name!r} is declared but no "
                f"code reads it — exporting it does nothing"))

    doc = doc_path if doc_path is not None \
        else os.path.join(root, ANALYSIS_DOC)
    if os.path.isfile(doc):
        doc_rel = rel(doc, root)
        documented = doc_table_tokens(doc, "## Environment-variable")
        for name in sorted(set(declared) - documented):
            out.append(Finding(
                CHECKER, "env-var-doc-drift", doc_rel, 1, name,
                f"declared environment variable {name!r} missing from "
                f"the table in {doc_rel}"))
        for name in sorted(documented - set(declared)):
            out.append(Finding(
                CHECKER, "env-var-doc-drift", doc_rel, 1, name,
                f"{doc_rel} documents unknown environment variable "
                f"{name!r}"))
    return out


# -- entry point -------------------------------------------------------------

def check(root: str) -> List[Finding]:
    out: List[Finding] = []
    out.extend(metric_findings(
        [PKG], root,
        doc_path=os.path.join(root, OBS_DOC)))
    out.extend(session_prop_findings(root))
    out.extend(failpoint_findings(root))
    out.extend(alert_rule_findings(root))
    out.extend(config_key_findings(root))
    out.extend(env_var_findings(root))
    return out
