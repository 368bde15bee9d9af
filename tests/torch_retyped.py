"""The plan texts in which presto_tpu_torch and presto_tpu differ by
design: the port types an integer literal as Presto does
(``ExpressionAnalyzer.visitLongLiteral``: INTEGER where it fits in
[-2^31, 2^31-1], BIGINT past it), where the reference types every one
BIGINT. Three kinds of token differ, and nothing else may:

- the literal itself: the reference's ``lit(15:bigint)``, the port's
  ``lit(15:integer)``;
- an INTEGER column compared with such a literal, which the reference
  widens and the port leaves alone: ``cast(#3:integer as bigint)`` and
  ``#3:integer``;
- a projected field computed from such literals (Q12's ``case ... then 1
  else 0 end``): ``_aggarg0:bigint`` and ``_aggarg0:integer``.

A test holds the port's plan text against the reference's with
:func:`assert_retyped`: the listed pairs are put into the reference's
text, each (reference token, port token) in place of the reference's
token where the port's text has the port's, as often as listed; every
pair must be used, and the result must equal the port's text exactly,
whitespace and line breaks included. With no pairs that is ``got ==
want``. :func:`retype_doc` does the same for the plan codec's documents.
The tables below list the pairs for the TPC-H queries of
``tests/tpch_queries.py`` and the TPC-DS queries (q27 of
``test_torch_tpcds.py`` and ``tests/tpcds_queries.py``); a query that is
not listed has the reference's text exactly."""
import collections
import re

#: one token of a plan's text: a literal, a cast of a typed input, a
#: word or a typed input or field, a run of whitespace, or any other
#: single character
TOKEN = re.compile(r"lit\([^()]*\)|cast\(#\d+:[a-z0-9(),]+ as [a-z0-9(),]+\)"
                   r"|[A-Za-z_$#0-9]+(?::[a-z]+(?:\(\d+(?:,\d+)?\))?)?|\s+|\S")


def _put(want: str, got: str, left: collections.Counter) -> str:
    """``want`` with a pair of ``left`` put in at each token where
    ``got`` has the pair's port token in place of its reference token;
    each pair put in is taken from ``left``."""
    tw, tg = TOKEN.findall(want), TOKEN.findall(got)
    out = []
    for i, w in enumerate(tw):
        g = tg[i] if i < len(tg) else None
        if g != w and left[(w, g)] > 0:
            left[(w, g)] -= 1
            w = g
        out.append(w)
    return "".join(out)


def assert_retyped(got, want, pairs=()) -> None:
    """The port's text ``got`` equals the reference's ``want`` with
    exactly ``pairs`` put in: (reference token, port token), one per
    place. ``got`` and ``want`` are each a string, or a list of lines
    that must match one for one."""
    left = collections.Counter(pairs)
    if isinstance(want, str):
        assert got == _put(want, got, left)
    else:
        assert len(got) == len(want)
        assert list(got) == [_put(w, g, left) for w, g in zip(want, got)]
    assert not +left, f"pairs not in the text: {dict(+left)}"


def _token(doc: dict, t: str) -> str:
    """How the plan text prints the node ``doc`` typed ``t``."""
    if doc["$"] == "Literal":
        return f"lit({doc['value']!r}:{t})"
    if doc["$"] == "Field":
        return f"{doc['name']}:{t}"
    return f"{doc['form']['$form']}(...):{t}"


def retype_doc(want, got, made: collections.Counter):
    """The reference's codec document ``want`` with the type tags that
    differ by design rewritten to the port's document ``got``: a
    Literal's, Field's or SpecialForm's ``bigint`` where the port has
    ``integer``, and a ``Cast`` of an INTEGER input to bigint where the
    port has the input alone. Each rewrite is counted in ``made`` as its
    (reference token, port token) pair; nothing else is rewritten."""
    if isinstance(want, dict) and isinstance(got, dict):
        if (want.get("$") == "Cast" and want["type"] == {"$t": "bigint"}
                and got.get("$") == "InputRef" and want["arg"] == got
                and got["type"] == {"$t": "integer"}):
            made[(f"cast(#{got['index']}:integer as bigint)",
                  f"#{got['index']}:integer")] += 1
            return got
        if (want.get("$") in ("Literal", "Field", "SpecialForm")
                and want.keys() == got.keys()
                and want["type"] == {"$t": "bigint"}
                and got["type"] == {"$t": "integer"}):
            made[(_token(want, "bigint"), _token(want, "integer"))] += 1
            want = dict(want, type=got["type"])
        return {k: retype_doc(v, got.get(k), made) for k, v in want.items()}
    if isinstance(want, list) and isinstance(got, list) \
            and len(want) == len(got):
        return [retype_doc(w, g, made) for w, g in zip(want, got)]
    return want


def lit_pairs(*values):
    """Integer literals of these values, one pair per place."""
    return [(f"lit({v}:bigint)", f"lit({v}:integer)") for v in values]


def col_pairs(*inputs):
    """INTEGER inputs compared with an integer literal, one per place."""
    return [(f"cast(#{i}:integer as bigint)", f"#{i}:integer")
            for i in inputs]


#: TPC-H queries whose plans differ, by name
TPCH_RETYPED = {
    "q2": col_pairs(3) + lit_pairs(15),
    "q12": [("_aggarg0:bigint", "_aggarg0:integer"),
            ("_aggarg1:bigint", "_aggarg1:integer")],
    "q16": col_pairs(3) + lit_pairs(3, 9, 14, 19, 23, 36, 45, 49),
    "q19": col_pairs(4, 4, 4) + lit_pairs(1, 1, 1, 5, 10, 15),
    "q22": lit_pairs(1, 1, 2, 2),
}

#: EXPLAIN (FORMAT JSON) lists each node's output types as words too
TPCH_RETYPED_JSON = dict(TPCH_RETYPED, q12=TPCH_RETYPED["q12"] + [
    ("bigint", "integer"), ("bigint", "integer")])

#: TPC-DS queries whose plans differ, by name
TPCDS_RETYPED = {
    "q27": col_pairs(1) + lit_pairs(2002),
    "q3": col_pairs(2, 3) + lit_pairs(11, 128),
    "q7": col_pairs(1) + lit_pairs(2000),
    "q13": col_pairs(1, 8, 8) + lit_pairs(1, 3, 2001),
    "q19": col_pairs(1, 2, 4) + lit_pairs(1, 1, 5, 5, 8, 11, 1998),
    "q34": col_pairs(1, 2, 2, 2) + lit_pairs(0, 1, 3, 25, 28, 1999, 2000, 2001),
    "q42": col_pairs(1, 1, 2) + lit_pairs(1, 11, 2000),
    "q43": col_pairs(1) + lit_pairs(2000),
    "q48": col_pairs(1) + lit_pairs(2000),
    "q52": col_pairs(1, 2, 3) + lit_pairs(1, 11, 2000),
    "q53": col_pairs(2, 5) + lit_pairs(1, 20, 2000),
    "q55": col_pairs(1, 2, 3) + lit_pairs(11, 28, 1999),
    "q65": col_pairs(1, 1) + lit_pairs(2001, 2001),
    "q68": col_pairs(1, 1, 2, 2) + lit_pairs(1, 2, 3, 4, 1999, 2000, 2001),
    "q73": col_pairs(1, 2, 2) + lit_pairs(0, 1, 2, 1999, 2000, 2001),
    "q79": col_pairs(1, 1, 2, 2) + lit_pairs(2, 6, 200, 295, 1999, 2000, 2001),
    "q88": col_pairs(*[1] * 9, *[2] * 9) + lit_pairs(
        2, 2, 2, 4, 4, 4, 4, 4, 4, 6, 6, 6, 8, 9, 12, 30, 30, 30),
    "q89": col_pairs(2, 2) + lit_pairs(1, 60, 1999),
    "q96": col_pairs(1, 1, 2) + lit_pairs(7, 20, 30),
    "q98": col_pairs(2, 3) + lit_pairs(2, 1999),
    "q26_store": col_pairs(1) + lit_pairs(1998),
    "q6_store": col_pairs(1, 2) + lit_pairs(1, 2001),
}

RETYPED = {"tpch": TPCH_RETYPED, "tpcds": TPCDS_RETYPED}
