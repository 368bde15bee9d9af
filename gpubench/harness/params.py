"""Parameters of query templates, drawn from a seed by the rule file
beside each template (``queries/<suite>/<template>.json``).

A rule maps each placeholder of the template to one of these kinds:

- ``int``: a whole number in [lo, hi];
- ``decimal``: a decimal in [lo, hi] on a grid of ``step`` (kept as text).

``"cover": true`` on an ``int`` marks a parameter whose value picks a
scan-cache entry: a pool (set-up's warm statements) holds every value of
its range as evenly as its size allows, in a drawn order, so that every
seed warms the same entries. ``draw`` (a statement of the window) draws
it as any other.
"""
from __future__ import annotations

import random
from decimal import Decimal
from typing import Dict, List


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
    raise ValueError(f"unknown parameter kind {kind!r}")


def draw(rule: Dict, rng: random.Random) -> Dict:
    """One statement's parameter set."""
    return {name: _draw(spec, rng) for name, spec in rule["params"].items()}


def cover_size(rule: Dict) -> int:
    """Statements that warm every value of the covered parameters."""
    return max([int(s["hi"]) - int(s["lo"]) + 1
                for s in rule["params"].values() if s.get("cover")] or [1])


def _covered(spec, rng: random.Random, size: int) -> List[int]:
    values = list(range(int(spec["lo"]), int(spec["hi"]) + 1))
    out: List[int] = []
    while len(out) < size:
        block = values[:]
        rng.shuffle(block)
        out.extend(block)
    out = out[:size]
    rng.shuffle(out)
    return out


def draw_pool(rule: Dict, rng: random.Random, size: int) -> List[Dict]:
    """``size`` distinct parameter sets of one template."""
    params = rule["params"]
    covered = {name: _covered(spec, rng, size)
               for name, spec in params.items() if spec.get("cover")}
    pool: List[Dict] = []
    seen = set()
    for i in range(size):
        for _ in range(10_000):
            p = {name: covered[name][i] if name in covered
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
