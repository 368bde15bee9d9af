"""Parameters of query templates, drawn from a seed by the rule file
beside each template (``queries/<suite>/<template>.json``).

A rule maps each placeholder of the template to one of these kinds:

- ``int``: a whole number in [lo, hi];
- ``decimal``: a decimal in [lo, hi] on a grid of ``step`` (kept as text);
- ``choice``: one member of ``values`` (strings or numbers), uniformly or
  by ``weights``. It renders as the value's text, so the template quotes
  a string itself (``cd_gender = '{gen}'``);
- ``sample``: ``k`` distinct positions of ``values``, as a tuple in drawn
  order. ``values`` may repeat a member (a list of states by county
  does), and the template names the members ``{states[0]}``,
  ``{states[1]}``, ... .

``"cover": true`` on an ``int``, a ``decimal`` or a ``choice`` marks a
parameter whose value picks a scan-cache entry. A pool (set-up's warm
statements) holds every combination of the covered parameters' values
as evenly as its size allows, in a drawn order, so that every seed warms
the same entries; at ``cover_size`` each combination comes once.
``draw`` (a statement of the window) draws it as any other.

``check`` refuses a malformed rule, naming the template and the
parameter.
"""
from __future__ import annotations

import itertools
import math
import random
from decimal import Decimal
from typing import Dict, List

KINDS = ("int", "decimal", "choice", "sample")


def _fault(spec) -> str:
    """What is wrong with one parameter's rule ('' when nothing is)."""
    kind = spec.get("kind")
    if kind not in KINDS:
        return f"unknown kind {kind!r} (one of {', '.join(KINDS)})"
    if kind not in ("choice", "sample"):
        return ""
    values, weights = spec.get("values"), spec.get("weights")
    if not isinstance(values, list) or not values:
        return "'values' must be a list of at least one member"
    if weights is not None:
        if kind == "sample":
            return "a sample draws its positions uniformly: no weights"
        if len(weights) != len(values):
            return f"{len(weights)} weights for {len(values)} values"
        if min(weights) < 0 or not sum(weights) > 0:
            return "weights must be at least 0 with a sum above 0"
    if kind == "sample":
        k = spec.get("k")
        if not isinstance(k, int) or not 1 <= k <= len(values):
            return f"k = {k!r} distinct positions of {len(values)} values"
        if spec.get("cover"):
            return "a sample cannot be covered"
    return ""


def check(template: str, rule: Dict) -> None:
    """Raise ``ValueError`` naming the template and the parameter unless
    every parameter of ``rule`` is well formed."""
    for name, spec in rule["params"].items():
        fault = _fault(spec)
        if fault:
            raise ValueError(f"template {template!r}, parameter {name!r}: "
                             f"{fault}")


def _grid(spec) -> List[str]:
    lo, hi, step = (Decimal(spec[k]) for k in ("lo", "hi", "step"))
    out, v = [], lo
    while v <= hi:
        out.append(str(v))
        v += step
    return out


def _draw(spec, rng: random.Random):
    kind = spec["kind"]
    if kind == "int":
        return rng.randint(int(spec["lo"]), int(spec["hi"]))
    if kind == "decimal":
        return rng.choice(_grid(spec))
    if kind == "choice":
        if "weights" in spec:
            return rng.choices(spec["values"], spec["weights"])[0]
        return rng.choice(spec["values"])
    if kind == "sample":
        values = spec["values"]
        return tuple(values[i] for i in rng.sample(range(len(values)),
                                                   spec["k"]))
    raise ValueError(f"unknown parameter kind {kind!r}")


def draw(rule: Dict, rng: random.Random) -> Dict:
    """One statement's parameter set."""
    return {name: _draw(spec, rng) for name, spec in rule["params"].items()}


def _domain(spec) -> List:
    """Every value of a covered parameter, each once."""
    if spec["kind"] == "int":
        return list(range(int(spec["lo"]), int(spec["hi"]) + 1))
    if spec["kind"] == "decimal":
        return _grid(spec)
    return list(dict.fromkeys(spec["values"]))


def _covered_specs(rule: Dict) -> Dict:
    return {name: spec for name, spec in rule["params"].items()
            if spec.get("cover")}


def cover_size(rule: Dict) -> int:
    """Statements that warm every combination of the covered parameters'
    values."""
    return math.prod(len(_domain(s)) for s in _covered_specs(rule).values())


def _covered(specs: Dict, rng: random.Random, size: int) -> List[Dict]:
    combos = list(itertools.product(*(_domain(s) for s in specs.values())))
    out: List = []
    while len(out) < size:
        block = combos[:]
        rng.shuffle(block)
        out.extend(block)
    out = out[:size]
    rng.shuffle(out)
    return [dict(zip(specs, combo)) for combo in out]


def draw_pool(rule: Dict, rng: random.Random, size: int) -> List[Dict]:
    """``size`` distinct parameter sets of one template."""
    params = rule["params"]
    specs = _covered_specs(rule)
    covered = _covered(specs, rng, size) if specs else [{}] * size
    pool: List[Dict] = []
    seen = set()
    for i in range(size):
        for _ in range(10_000):
            p = {name: covered[i][name] if name in specs
                 else _draw(spec, rng) for name, spec in params.items()}
            key = repr(sorted(p.items()))
            if key not in seen:
                break
        else:
            raise ValueError(f"the rule cannot give {size} distinct sets")
        seen.add(key)
        pool.append(p)
    return pool


def render(sql: str, params: Dict) -> str:
    """The template's text with each ``{name}`` replaced."""
    return sql.format(**params)
