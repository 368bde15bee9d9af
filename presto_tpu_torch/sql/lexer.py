"""SQL lexer.

Hand-written replacement for the reference's ANTLR-generated lexer
(reference presto-parser/src/main/antlr4/io/prestosql/sql/parser/
SqlBase.g4 lexer rules) — the TPU build avoids parser-generator codegen
(SURVEY.md §2c item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional


class SqlSyntaxError(ValueError):
    def __init__(self, message: str, line: int = 0, col: int = 0):
        super().__init__(f"line {line}:{col}: {message}" if line else message)
        self.line = line
        self.col = col


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str          # IDENT QIDENT STRING NUMBER INTEGER OP KEYWORD EOF
    text: str          # raw text (keywords/idents lowercased; QIDENT unquoted)
    line: int
    col: int

    def __repr__(self) -> str:
        return f"{self.kind}({self.text!r})"


# Multi-char operators first (longest match wins)
_OPERATORS = ("<>", "!=", ">=", "<=", "||", "->", "=", "<", ">", "+", "-",
              "*", "/", "%", "(", ")", ",", ".", ";", "?", "[", "]")

KEYWORDS = frozenset("""
    select from where group by having order limit offset distinct all as on
    join inner left right full outer cross natural using and or not in like
    escape between is null true false case when then else end cast try_cast
    exists union intersect except with recursive asc desc nulls first last
    interval year month day hour minute second date time timestamp extract
    count sum avg min max coalesce nullif
    create table drop insert into values if show session set reset explain
    analyze describe catalogs schemas tables columns functions
    over partition rows range preceding following unbounded current row
    start transaction commit rollback work isolation level only
    grant revoke role roles grants to option
""".split())

# Keywords that can still be used as identifiers in non-ambiguous positions
# (mirrors SqlBase.g4 nonReserved rule)
NON_RESERVED = frozenset("""
    date time timestamp year month day hour minute second catalogs schemas
    tables columns functions session analyze show if first last nulls
    count sum avg min max coalesce nullif interval
    over partition rows range preceding following unbounded current row
    start transaction commit rollback work isolation level only
    role roles grants option
""".split())


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    line, line_start = 1, 0

    def pos(idx: int):
        return line, idx - line_start + 1

    while i < n:
        c = sql[i]
        if c == "\n":
            line += 1
            line_start = i + 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise SqlSyntaxError("unterminated comment", *pos(i))
            line += sql.count("\n", i, j)
            i = j + 2
            continue
        ln, col = pos(i)
        if c == "'":
            # string literal, '' escapes a quote
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError("unterminated string", ln, col)
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token("STRING", "".join(buf), ln, col))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlSyntaxError("unterminated quoted identifier", ln, col)
            out.append(Token("QIDENT", sql[i + 1:j], ln, col))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and sql[j].isdigit():
                j += 1
            if j < n and sql[j] == ".":
                is_float = True
                j += 1
                while j < n and sql[j].isdigit():
                    j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and sql[j].isdigit():
                        j += 1
            text = sql[i:j]
            out.append(Token("NUMBER" if is_float else "INTEGER", text, ln, col))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            kind = "KEYWORD" if word in KEYWORDS else "IDENT"
            out.append(Token(kind, word, ln, col))
            i = j
            continue
        for op in _OPERATORS:
            if sql.startswith(op, i):
                out.append(Token("OP", op, ln, col))
                i += len(op)
                break
        else:
            raise SqlSyntaxError(f"unexpected character {c!r}", ln, col)
    out.append(Token("EOF", "", line, n - line_start + 1))
    return out
