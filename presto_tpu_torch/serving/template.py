"""Parameter-generic plan templates: one optimized plan for a whole
fleet of bindings.

The counterpart of ``presto_tpu/serving/template.py``. The plan cache
keys on the BOUND statement, so a dashboard fleet issuing ``EXECUTE dash
USING 1001``, ``USING 1002``, ... fingerprints every binding separately:
N plans and N optimizer passes. This module fingerprints the statement's
parameterized SHAPE instead:

- :func:`parameterize` hole-punches eligible literals out of the AST.
  The **template** form replaces each with a value-free
  ``ast.TypedParameter`` (position + type kind) and is only ever
  hashed; the **marked** form replaces each with a ``Slot*Literal``
  that carries the value AND a binding slot: it plans through the
  normal analyzer and optimizer, except slot literals lower to runtime
  ``ir.Param`` nodes instead of baked constants.
- eligibility is conservative: INTEGER / BIGINT / DOUBLE /
  short-DECIMAL / DATE literals appearing as operands of comparison /
  BETWEEN / IN-list / boolean / arithmetic nodes inside WHERE, HAVING,
  or join ON predicates. Everything else (LIMIT counts, GROUP BY ordinals,
  function arguments with static contracts, LIKE patterns, string
  literals whose dictionaries are built with the batch, VALUES rows,
  long decimals) stays baked and is part of the template key.
- **guards**: an optimizer decision that CONSULTS a parameter's value
  (scan-pushdown bound extraction, which seeds key-bounds gates, stats
  estimates and join strategy downstream) records an equality guard via
  expr/params.consult. A template hit first checks its guards against
  the new binding; a flipped guard falls back to the per-binding
  fingerprint path (the plan cache), observable as
  ``plan_template_cache_guard_fallback_total``.

Executors that take values as constants (the mesh executor, the fused
join pipeline) materialize bindings with expr/params.bind_plan or skip
fusion.

Session knob: ``plan_template_cache`` (default false).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..exec.failpoints import FAILPOINTS
from ..obs.metrics import REGISTRY
from ..sql import ast as A
from .plancache import (PlanCache, bound_fingerprint, cached_plan,
                        key_fragment)

_GUARD_FALLBACK = REGISTRY.counter(
    "plan_template_cache_guard_fallback_total")

#: the process-wide template cache (a second PlanCache: same LRU,
#: data-version validation, eager invalidation and write-epoch veto,
#: its own metric family and lock)
TEMPLATES = PlanCache(metrics="plan_template_cache",
                      lock_name="plancache.templates")


@dataclasses.dataclass(frozen=True)
class Template:
    """Cached payload: the parameterized plan plus its reuse guards
    ((slot, value) equality predicates recorded at build time)."""
    plan: object
    guards: Tuple[Tuple[int, Any], ...]
    n_slots: int


# -- parameterization ---------------------------------------------------------

#: predicate-context nodes the hole-punch walk recurses THROUGH;
#: entering any other node type ends eligibility (its literals bake)
_PUNCH_CONTEXTS = (A.LogicalBinary, A.Not, A.Comparison, A.Between,
                   A.InList, A.ArithmeticBinary, A.ArithmeticUnary)

_SLOT_FORMS = {
    A.LongLiteral: A.SlotLongLiteral,
    A.DoubleLiteral: A.SlotDoubleLiteral,
    A.DateLiteral: A.SlotDateLiteral,
}


def _hole(e):
    """(slot_cls, kind) when ``e`` is an eligible literal, else None.
    Exact-type match: a literal's KIND (its SQL type) is part of the
    template key, so ``x > 5``, ``x > 5.0`` and ``x > 5000000000``
    (INTEGER, DECIMAL, BIGINT) never share a template."""
    from ..sql.analyzer import literal_type
    slot_cls = _SLOT_FORMS.get(type(e))
    if slot_cls is not None:
        return slot_cls, literal_type(e).display()
    if type(e) is A.DecimalLiteral:
        t = literal_type(e)
        if t.is_long:        # >18 digits: 2-limb storage, keep baked
            return None
        return A.SlotDecimalLiteral, t.display()
    return None


def parameterize(stmt):
    """(template_stmt, marked_stmt, values) — values is {slot: python
    value}; empty when the statement has no eligible literals (the
    caller then uses the plain bound-fingerprint cache)."""
    values: Dict[int, Any] = {}

    def walk(n, in_pred: bool):
        if in_pred:
            hole = _hole(n)
            if hole is not None:
                slot_cls, kind = hole
                slot = len(values)
                values[slot] = n.value
                return (A.TypedParameter(index=slot, kind=kind),
                        slot_cls(value=n.value, slot=slot))
        if isinstance(n, A.QuerySpecification):
            return _rebuild(n, lambda f, v: walk(
                v, f in ("where", "having")))
        if isinstance(n, A.Join):
            return _rebuild(n, lambda f, v: walk(
                v, f == "condition"))
        if isinstance(n, _PUNCH_CONTEXTS):
            return _rebuild(n, lambda f, v: walk(v, in_pred))
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            return _rebuild(n, lambda f, v: walk(v, False))
        if isinstance(n, tuple):
            pairs = [walk(x, in_pred) for x in n]
            return (tuple(p[0] for p in pairs),
                    tuple(p[1] for p in pairs))
        return n, n

    def _rebuild(n, child_walk):
        t_changes, m_changes = {}, {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, (tuple,)) or (
                    dataclasses.is_dataclass(v)
                    and not isinstance(v, type)):
                tv, mv = child_walk(f.name, v)
                if tv is not v:
                    t_changes[f.name] = tv
                if mv is not v:
                    m_changes[f.name] = mv
        t = dataclasses.replace(n, **t_changes) if t_changes else n
        m = dataclasses.replace(n, **m_changes) if m_changes else n
        return t, m

    template, marked = walk(stmt, False)
    return template, marked, values


# -- lookup / build -----------------------------------------------------------

# parse_cached returns the SAME AST object for a repeated statement
# text, so the hole-punch walk memoizes by AST identity: the serving
# steady state pays one dict probe instead of an O(tree) rebuild per
# query (plancache.IdentMemo pins the statement against id() reuse).
from .plancache import IdentMemo  # noqa: E402

_memo = IdentMemo(lock_name="template.parameterize")


def parameterize_cached(stmt):
    return _memo.get(stmt, parameterize)


def template_plan(stmt, session, user: str = "", secured: bool = False):
    """(plan, bindings, bound_key) for a SELECT statement under the
    template cache. ``bindings`` is the slot->value map to execute the
    (possibly parameterized) plan with — None when the plan came from
    the per-binding path and has no Params. ``bound_key`` is the full
    bound-statement fingerprint (the result cache keys on it)."""
    from ..expr import params as P
    from ..planner.optimizer import optimize
    from ..planner.planner import plan_query

    # one session-slice walk for both keys (bound + template)
    frag = key_fragment(session, user=user, secured=secured)
    bound_key = bound_fingerprint(stmt, session, user=user,
                                  secured=secured, fragment=frag)
    template_stmt, marked_stmt, values = parameterize_cached(stmt)
    if not values:
        plan = cached_plan(stmt, session, user=user, secured=secured)
        return plan, None, bound_key
    tkey = bound_fingerprint(template_stmt, session, user=user,
                             secured=secured, fragment=frag)
    entry = TEMPLATES.get(tkey)
    if isinstance(entry, Template):
        if len(values) == entry.n_slots and all(
                values.get(slot) == v for slot, v in entry.guards):
            return entry.plan, dict(values), bound_key
        # an optimization decision was keyed on a literal this binding
        # changed (or the shape re-punched differently): the template
        # plan would be wrong/stale for it — per-binding fingerprint
        _GUARD_FALLBACK.inc()
        plan = cached_plan(stmt, session, user=user, secured=secured)
        return plan, None, bound_key
    # miss: build the template from the marked statement, recording
    # every value consultation as a reuse guard. The building query
    # executes the parameterized plan itself, bound to its own
    # literals.
    epoch = TEMPLATES.epoch()
    FAILPOINTS.hit("plancache.plan", key=tkey.hex()[:12])
    with P.recording_guards() as guards:
        plan = optimize(plan_query(marked_stmt, session), session)
    payload = Template(plan=plan,
                       guards=tuple(sorted(dict(guards).items())),
                       n_slots=len(values))
    TEMPLATES.put(tkey, plan, session, epoch=epoch, payload=payload)
    return plan, dict(values), bound_key


# eager write invalidation, same path as the bound-plan cache
from ..connectors import spi  # noqa: E402


def _on_write(conn, table) -> None:
    TEMPLATES.note_write()
    TEMPLATES.invalidate(conn, table)


spi.on_data_change(_on_write)
