"""A cell's statements, all drawn from the seed.

A client is a query stream of TPC-H's throughput test (clause 5.3.4):
the clients send at once, and each draws every statement's parameters
anew by its template's rule (``params.draw``). A client sends blocks
that hold each template as many times as its weight, shuffled, so every
seed sends the same mix and only the order and the parameters change.

Set-up runs the warm instances (``warm``): per template, one statement
for each combination of its covered parameters' values (those whose
value picks a scan-cache entry, as Q6's year does), so that every entry
the window can ask for is resident before it opens.

Each template's rule is checked as it is loaded (``params.check``).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterator, List, Tuple

from . import params, spec


@dataclasses.dataclass(frozen=True)
class Instance:
    template: str
    params: Dict
    sql: str

    @property
    def key(self) -> Tuple[str, str]:
        """Equal for statements that must give equal answers."""
        return self.template, repr(sorted(self.params.items()))


def rng(seed: int, *purpose) -> random.Random:
    """A generator of its own for each purpose, from the seed (a string
    seed is hashed with SHA-512, so any whole number works)."""
    return random.Random(":".join(str(p) for p in (seed, *purpose)))


def _template(suite: str, name: str):
    """(SQL text, parameter rule) of one template, its rule checked."""
    sql, rule = spec.template(suite, name)
    params.check(name, rule)
    return sql, rule


def warm(suite: str, traffic: Dict, seed: int) -> List[Instance]:
    """Set-up's statements: each template once per combination of its
    covered values."""
    out: List[Instance] = []
    for name in sorted(traffic["templates"]):
        sql, rule = _template(suite, name)
        for p in params.draw_pool(rule, rng(seed, "warm", name),
                                  params.cover_size(rule)):
            out.append(Instance(name, p, params.render(sql, p)))
    return out


def sequence(suite: str, traffic: Dict, seed: int,
             client: int) -> Iterator[Instance]:
    """The endless sequence of one client."""
    r = rng(seed, "client", client)
    templates = {t: _template(suite, t) for t in traffic["templates"]}
    block = [t for t in sorted(templates)
             for _ in range(int(traffic["templates"][t]))]
    while True:
        order = block[:]
        r.shuffle(order)
        for t in order:
            sql, rule = templates[t]
            p = params.draw(rule, r)
            yield Instance(t, p, params.render(sql, p))
