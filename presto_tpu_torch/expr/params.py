"""Execution-time bindings for plan-template parameters (ir.Param).

The counterpart of ``presto_tpu/expr/params.py``. A parameter-generic
plan (serving/template.py) carries ``ir.Param`` nodes where the
statement had literals; the scopes here keep the value out of the plan
while still delivering it to the expression interpreter:

- the **binding scope** (:func:`bound`) is set per query around plan
  execution with the query's slot->value map. It is a contextvar, so
  the threads that run batches (the split prefetch workers, the probe
  producer, ``parallel_drivers``), which run in a copy of their spawn
  context, and the main drain loop all see it, and two concurrent
  queries sharing one cached plan keep their own bindings.
- PyTorch runs eagerly and the port's interpreter keeps no program
  cache, so there is no trace to hand a value to: ``eval_expr`` calls
  :func:`param_val` when it meets a Param, which reads the binding
  scope. Evaluating a Param outside any binding scope is a hard error:
  a silently stale build-time value must never leak into results.
  Each binding becomes one 0-d tensor in its storage domain per query
  and device, made on first use and shared by every batch after it.
- the **guard scope** (:func:`recording_guards`) is active only while
  the planner builds a template. An optimizer site that bakes a
  parameter's value into the plan (scan-pushdown bounds, which seed
  key-bounds gates and stats downstream) must go through
  :func:`consult`, which records an equality guard; a later binding
  that flips the guard makes the template unusable for it and falls
  back to a per-binding fingerprint (serving/template.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import ir


class _Scope:
    """One query's bindings and the device scalars made from them."""

    __slots__ = ("values", "scalars", "lock")

    def __init__(self, values: Dict[int, Any]):
        self.values = values
        #: (slot, device) -> 0-d tensor in the slot type's storage domain
        self.scalars: Dict[Tuple[int, str], torch.Tensor] = {}
        self.lock = threading.Lock()


#: per-query binding scope
_BINDINGS: contextvars.ContextVar[Optional[_Scope]] = \
    contextvars.ContextVar("param_bindings", default=None)
#: planner-side guard recorder: list of (slot, python value)
_GUARDS: contextvars.ContextVar[Optional[List[Tuple[int, Any]]]] = \
    contextvars.ContextVar("param_guards", default=None)


@contextlib.contextmanager
def bound(bindings: Optional[Dict[int, Any]]):
    """Query-scope binding map; no-op when ``bindings`` is None."""
    if bindings is None:
        yield
        return
    token = _BINDINGS.set(_Scope(dict(bindings)))
    try:
        yield
    finally:
        _BINDINGS.reset(token)


@contextlib.contextmanager
def recording_guards():
    guards: List[Tuple[int, Any]] = []
    token = _GUARDS.set(guards)
    try:
        yield guards
    finally:
        _GUARDS.reset(token)


def consult(p: ir.Param) -> Any:
    """Planner-only read of a Param's build-time value. Records an
    equality guard when a template build is recording: the produced
    plan is only reusable for bindings that repeat this value."""
    guards = _GUARDS.get()
    if guards is not None:
        guards.append((p.slot, p.bound))
    return p.bound


def collect_params(exprs: Sequence[object]) -> List[ir.Param]:
    """Every distinct Param slot in the given IR trees, slot-ordered."""
    by_slot: Dict[int, ir.Param] = {}

    def walk(e):
        if isinstance(e, ir.Param):
            by_slot.setdefault(e.slot, e)
        for c in getattr(e, "children", lambda: ())():
            walk(c)

    for e in exprs:
        if e is not None:
            walk(e)
    return [by_slot[s] for s in sorted(by_slot)]


def _scalar(scope: _Scope, p: ir.Param, device) -> torch.Tensor:
    """The slot's binding as a 0-d tensor on ``device``, made once per
    query and device (one host-to-device copy, not one per batch)."""
    key = (p.slot, str(device))
    with scope.lock:
        t = scope.scalars.get(key)
        if t is None:
            if p.slot not in scope.values:
                raise RuntimeError(
                    f"no binding for parameter slot {p.slot}")
            storage = p.type.to_storage(scope.values[p.slot])
            t = scope.scalars[key] = torch.tensor(
                storage, dtype=p.type.storage_dtype, device=device)
        return t


def param_val(p: ir.Param, n: int, device):
    """Val for a Param over a batch of capacity ``n`` on ``device``: the
    query's binding broadcast from its device scalar. Never NULL: the
    parameterizer only hole-punches non-null literals."""
    from .functions import Val
    scope = _BINDINGS.get()
    if scope is None:
        raise RuntimeError(
            f"parameter slot {p.slot} evaluated outside a binding scope "
            "(serving/template.py must supply Session.param_bindings)")
    scalar = _scalar(scope, p, device)
    return Val(scalar.expand(n).contiguous(),
               torch.ones(n, dtype=torch.bool, device=device), p.type)


def has_params(obj) -> bool:
    """True when a plan (or any dataclass tree) contains an ir.Param:
    the gate for paths that must materialize bindings first (the mesh
    executor, fused join chains)."""
    seen = set()

    def walk(n) -> bool:
        if isinstance(n, ir.Param):
            return True
        if id(n) in seen:
            return False
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            seen.add(id(n))
            return any(walk(getattr(n, f.name))
                       for f in dataclasses.fields(n))
        if isinstance(n, (tuple, list)):
            return any(walk(x) for x in n)
        return False

    return walk(obj)


def bind_plan(plan, bindings: Dict[int, Any]):
    """Materialize a parameterized plan for executors that take values
    as constants (the mesh executor, a stored result-cache plan): every
    ir.Param becomes an ir.Literal of the query's binding. Returns a
    structurally shared rebuild; the cached template is never mutated."""

    def walk(n):
        if isinstance(n, ir.Param):
            return ir.Literal(type=n.type, value=bindings[n.slot])
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            changes = {}
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                nv = walk(v)
                if nv is not v:
                    changes[f.name] = nv
            return dataclasses.replace(n, **changes) if changes else n
        if isinstance(n, tuple):
            out = tuple(walk(x) for x in n)
            return out if any(a is not b for a, b in zip(out, n)) else n
        if isinstance(n, list):
            out = [walk(x) for x in n]
            return out if any(a is not b for a, b in zip(out, n)) else n
        return n

    return walk(plan)
