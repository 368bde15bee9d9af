"""Plan (de)serialization for shipping fragments to workers.

The counterpart of ``presto_tpu/planner/codec.py`` (the role of the
reference's JSON-serialized PlanFragment: presto-main/.../sql/planner/
PlanFragment.java is Jackson-annotated and travels in the
TaskUpdateRequest body, server/TaskUpdateRequest.java). Every plan node,
expression and helper is a frozen dataclass, so one generic walker
covers the whole tree: a class-name tag plus the encoded fields. Types
round-trip through ``display()`` / ``parse_type``; sequences decode to
tuples (plan fields are tuples by construction). The document is the
JAX package's, tag for tag, so a fragment encoded by one package reads
in the other.

The init plans' values ride the task document through
``encode_values``: a value read off a decoded row is a numpy scalar,
which becomes the Python value it holds, so it round-trips by value (the
JAX package's ``encode`` raises on an integer one, and its cluster fails
any query with an integer scalar subquery); a long decimal is a
``decimal.Decimal`` and encodes as ``$dec``. Anything else, as an ARRAY
value (a list of numpy scalars) or a MAP value (a ``dict``), raises the
JAX package's ``TypeError("cannot encode ...")`` on the coordinator, so
no value reaches a worker as its ``str()``.
"""
from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Any, Dict

import numpy as np

from .. import types as T
from ..connectors.spi import Split, TableHandle
from ..expr import ir
from ..sql.analyzer import Field
from . import plan as plan_mod

_CLASSES: Dict[str, type] = {}
for _mod in (plan_mod, ir):
    for _name in dir(_mod):
        _obj = getattr(_mod, _name)
        if isinstance(_obj, type) and dataclasses.is_dataclass(_obj):
            _CLASSES[_obj.__name__] = _obj
_CLASSES["TableHandle"] = TableHandle
_CLASSES["Field"] = Field
_CLASSES["Split"] = Split


def _register_late() -> None:
    # the planner imports this module's siblings; resolve InitPlanRef on
    # first use to avoid the cycle
    if "InitPlanRef" not in _CLASSES:
        from .planner import InitPlanRef
        _CLASSES["InitPlanRef"] = InitPlanRef


def encode(obj: Any) -> Any:
    """Plan tree -> JSON-able document."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, T.Type):
        return {"$t": obj.display()}
    if isinstance(obj, ir.Form):
        return {"$form": obj.value}
    if isinstance(obj, decimal.Decimal):
        return {"$dec": str(obj)}
    if isinstance(obj, datetime.datetime):
        return {"$ts": obj.isoformat()}
    if isinstance(obj, datetime.date):
        return {"$date": obj.isoformat()}
    if isinstance(obj, (tuple, list)):
        return [encode(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        _register_late()
        cls = type(obj)
        if cls.__name__ not in _CLASSES:
            raise TypeError(f"unregistered plan class {cls.__name__}")
        doc = {"$": cls.__name__}
        for f in dataclasses.fields(obj):
            doc[f.name] = encode(getattr(obj, f.name))
        return doc
    raise TypeError(f"cannot encode {type(obj).__name__}: {obj!r}")


def encode_values(values) -> Any:
    """Init-plan values -> JSON-able document: each numpy scalar becomes
    the Python value it holds; the rest goes through :func:`encode`."""
    return encode([v.item() if isinstance(v, np.generic) else v
                   for v in values])


def decode(doc: Any) -> Any:
    """JSON-able document -> plan tree."""
    if doc is None or isinstance(doc, (bool, int, float, str)):
        return doc
    if isinstance(doc, list):
        return tuple(decode(v) for v in doc)
    if isinstance(doc, dict):
        if "$t" in doc:
            return T.parse_type(doc["$t"])
        if "$form" in doc:
            return ir.Form(doc["$form"])
        if "$dec" in doc:
            return decimal.Decimal(doc["$dec"])
        if "$ts" in doc:
            return datetime.datetime.fromisoformat(doc["$ts"])
        if "$date" in doc:
            return datetime.date.fromisoformat(doc["$date"])
        _register_late()
        cls = _CLASSES[doc["$"]]
        kwargs = {k: decode(v) for k, v in doc.items() if k != "$"}
        return cls(**kwargs)
    raise TypeError(f"cannot decode {doc!r}")
