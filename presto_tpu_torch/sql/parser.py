"""Recursive-descent SQL parser (Pratt expressions).

Hand-written replacement for the reference's ANTLR parser (reference
presto-parser/.../parser/SqlParser.java:95 createStatement and
AstBuilder.java) covering the query language TPC-H/TPC-DS needs plus
session/EXPLAIN/SHOW/CTAS statements. Precedence mirrors SqlBase.g4:
OR < AND < NOT < predicate (IS/BETWEEN/IN/LIKE/comparison) < + - < * / %
< unary < postfix.
"""
from __future__ import annotations

from decimal import Decimal
from typing import List, Optional, Tuple

from . import ast as A
from .lexer import NON_RESERVED, SqlSyntaxError, Token, tokenize


def parse_statement(sql: str) -> A.Node:
    p = _Parser(tokenize(sql))
    stmt = p.statement()
    p.expect_kind("EOF")
    return stmt


def parse_expression(sql: str) -> A.Expression:
    p = _Parser(tokenize(sql))
    e = p.expression()
    p.expect_kind("EOF")
    return e


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.text in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text in ops

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> Token:
        t = self.peek()
        if not self.at_kw(word):
            raise SqlSyntaxError(f"expected {word.upper()}, found {t.text!r}",
                                 t.line, t.col)
        return self.next()

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not self.at_op(op):
            raise SqlSyntaxError(f"expected {op!r}, found {t.text!r}",
                                 t.line, t.col)
        return self.next()

    def expect_kind(self, kind: str) -> Token:
        t = self.peek()
        if t.kind != kind:
            raise SqlSyntaxError(f"expected {kind}, found {t.text!r}",
                                 t.line, t.col)
        return self.next()

    def identifier(self) -> str:
        t = self.peek()
        if t.kind == "IDENT" or t.kind == "QIDENT":
            return self.next().text
        if t.kind == "KEYWORD" and t.text in NON_RESERVED:
            return self.next().text
        raise SqlSyntaxError(f"expected identifier, found {t.text!r}",
                             t.line, t.col)

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.identifier()]
        while self.at_op(".") and self.peek(1).kind in ("IDENT", "QIDENT") or (
                self.at_op(".") and self.peek(1).kind == "KEYWORD"
                and self.peek(1).text in NON_RESERVED):
            self.next()
            parts.append(self.identifier())
        return tuple(parts)

    # -- statements ---------------------------------------------------------
    def statement(self) -> A.Node:
        if self.at_kw("explain"):
            self.next()
            etype, fmt = "logical", "text"
            if self.at_op("(") and self.peek(1).text.lower() in (
                    "type", "format"):
                self.next()
                while True:
                    t = self.next()
                    word = t.text.lower()
                    if word == "type":
                        etype = self.next().text.lower()
                        if etype not in ("logical", "distributed",
                                         "validate", "io"):
                            raise SqlSyntaxError(
                                f"unknown EXPLAIN type {etype!r}",
                                t.line, t.col)
                    elif word == "format":
                        fmt = self.next().text.lower()
                        if fmt not in ("text", "json", "graphviz"):
                            raise SqlSyntaxError(
                                f"unknown EXPLAIN format {fmt!r}",
                                t.line, t.col)
                    else:
                        raise SqlSyntaxError(
                            "expected TYPE or FORMAT", t.line, t.col)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            analyze = self.accept_kw("analyze")
            return A.Explain(self.statement(), analyze=analyze,
                             type=etype, format=fmt)
        if self.at_kw("show"):
            return self._show()
        if self.at_kw("describe"):
            self.next()
            t = self.peek()
            if t.kind == "IDENT" and t.text.lower() in ("input", "output") \
                    and self.peek(1).kind in ("IDENT", "QIDENT"):
                kind = self.next().text.lower()
                name = self.identifier()
                return (A.DescribeInput(name) if kind == "input"
                        else A.DescribeOutput(name))
            return A.ShowColumns(self.qualified_name())
        if self.at_kw("set"):
            self.next()
            if self.accept_kw("role"):
                t = self.next()
                return A.SetRole(t.text.lower() if t.kind == "KEYWORD"
                                 else t.text)
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            return A.SetSession(name, self.expression())
        if self.at_kw("grant"):
            return self._grant_revoke(grant=True)
        if self.at_kw("revoke"):
            return self._grant_revoke(grant=False)
        if self.at_kw("reset"):
            self.next()
            self.expect_kw("session")
            return A.ResetSession(".".join(self.qualified_name()))
        if self.at_kw("start"):
            self.next()
            self.expect_kw("transaction")
            isolation, read_only = "READ COMMITTED", False
            while True:
                if self.accept_kw("isolation"):
                    self.expect_kw("level")
                    w1 = self.next().text.lower()
                    isolation = (w1 if w1 == "serializable"
                                 else f"{w1} {self.next().text}").upper()
                elif (self.peek().text == "read"
                      and self.peek().kind in ("IDENT", "KEYWORD")):
                    self.next()
                    read_only = self.accept_kw("only")
                    if not read_only:
                        t = self.next()
                        if t.text != "write":
                            raise SqlSyntaxError(
                                f"expected ONLY or WRITE, found "
                                f"{t.text!r}", t.line, t.col)
                elif not self.accept_op(","):
                    break
            return A.StartTransaction(isolation, read_only)
        if self.at_kw("commit"):
            self.next()
            self.accept_kw("work")
            return A.Commit()
        if self.at_kw("rollback"):
            self.next()
            self.accept_kw("work")
            return A.Rollback()
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("drop"):
            self.next()
            if self.accept_kw("role"):
                return A.DropRole(self.identifier())
            is_view = False
            if self.peek().kind == "IDENT" \
                    and self.peek().text.lower() == "view":
                self.next()
                is_view = True
            else:
                self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.qualified_name()
            return (A.DropView(name, if_exists) if is_view
                    else A.DropTable(name, if_exists))
        if self.peek().kind == "IDENT" \
                and self.peek().text.lower() == "prepare":
            self.next()
            name = self.identifier()
            self.expect_kw("from")
            return A.Prepare(name, self.statement())
        if self.peek().kind == "IDENT" \
                and self.peek().text.lower() == "execute":
            self.next()
            name = self.identifier()
            args: List[A.Expression] = []
            if self.accept_kw("using"):
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
            return A.ExecuteStmt(name, tuple(args))
        if self.peek().kind == "IDENT" \
                and self.peek().text.lower() == "deallocate":
            self.next()
            t = self.next()
            if t.text.lower() != "prepare":
                raise SqlSyntaxError("expected PREPARE", t.line, t.col)
            return A.Deallocate(self.identifier())
        if self.at_kw("insert"):
            self.next()
            self.expect_kw("into")
            name = self.qualified_name()
            cols: Tuple[str, ...] = ()
            if self.at_op("(") and self._looks_like_column_list():
                self.next()
                names = [self.identifier()]
                while self.accept_op(","):
                    names.append(self.identifier())
                self.expect_op(")")
                cols = tuple(names)
            return A.InsertInto(name, self.query(), cols)
        return self.query()

    def _looks_like_column_list(self) -> bool:
        # distinguish INSERT INTO t (a, b) SELECT ... from INSERT INTO t (SELECT...)
        return not (self.peek(1).kind == "KEYWORD"
                    and self.peek(1).text in ("select", "with", "values"))

    def _show(self) -> A.Node:
        self.expect_kw("show")
        if self.accept_kw("tables"):
            schema = None
            if self.accept_kw("from") or self.accept_kw("in"):
                schema = self.qualified_name()
            return A.ShowTables(schema)
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return A.ShowColumns(self.qualified_name())
        if self.accept_kw("catalogs"):
            return A.ShowCatalogs()
        if self.accept_kw("session"):
            return A.ShowSession()
        if self.accept_kw("roles"):
            return A.ShowRoles()
        if self.accept_kw("grants"):
            table: tuple = ()
            if self.accept_kw("on"):
                self.accept_kw("table")
                table = self.qualified_name()
            return A.ShowGrants(table)
        t = self.peek()
        raise SqlSyntaxError(f"unsupported SHOW {t.text!r}", t.line, t.col)

    def _grant_revoke(self, grant: bool) -> A.Node:
        """GRANT/REVOKE of roles and of table privileges (reference
        sql/tree/Grant.java + GrantRoles.java; SqlBase.g4 grant rules)."""
        self.next()                       # grant | revoke
        # role form: GRANT r1, r2 TO u1, u2 — detected by the absence of
        # a privilege keyword / ALL / ON
        privs: List[str] = []
        is_priv = False
        t = self.peek()
        if t.kind == "KEYWORD" and t.text in ("select", "insert", "all"):
            is_priv = True
        elif t.kind == "IDENT" and t.text.lower() in ("delete", "update"):
            is_priv = True
        if is_priv:
            if self.accept_kw("all"):
                if self.peek().kind == "IDENT" \
                        and self.peek().text.lower() == "privileges":
                    self.next()
                privs = ["SELECT", "INSERT", "DELETE"]
            else:
                while True:
                    privs.append(self.next().text.upper())
                    if not self.accept_op(","):
                        break
            self.expect_kw("on")
            self.accept_kw("table")
            table = self.qualified_name()
            if grant:
                self.expect_kw("to")
            else:
                self.expect_kw("from")
            grantee = self._grantee()
            opt = False
            if grant and self.accept_kw("with"):
                self.expect_kw("grant")
                self.expect_kw("option")
                opt = True
            return (A.GrantPrivileges(tuple(privs), table, grantee, opt)
                    if grant else
                    A.RevokePrivileges(tuple(privs), table, grantee))
        roles = [self.identifier()]
        while self.accept_op(","):
            roles.append(self.identifier())
        if grant:
            self.expect_kw("to")
        else:
            self.expect_kw("from")
        grantees = [self._grantee()]
        while self.accept_op(","):
            grantees.append(self._grantee())
        admin = False
        if grant and self.accept_kw("with"):
            t = self.next()
            if t.text.lower() != "admin":
                raise SqlSyntaxError("expected ADMIN OPTION", t.line, t.col)
            self.expect_kw("option")
            admin = True
        return (A.GrantRoles(tuple(roles), tuple(grantees), admin)
                if grant else A.RevokeRoles(tuple(roles), tuple(grantees)))

    def _grantee(self) -> str:
        # optional USER/ROLE prefix like the reference's principal rule
        t = self.peek()
        if t.kind == "IDENT" and t.text.lower() in ("user",) \
                and self.peek(1).kind in ("IDENT", "QIDENT"):
            self.next()
        elif self.at_kw("role") and self.peek(1).kind in ("IDENT", "QIDENT"):
            self.next()
        return self.identifier()

    def _create(self) -> A.Node:
        self.expect_kw("create")
        if self.accept_kw("role"):
            return A.CreateRole(self.identifier())
        or_replace = False
        if self.accept_kw("or"):
            t = self.next()
            if t.text.lower() != "replace":
                raise SqlSyntaxError("expected REPLACE", t.line, t.col)
            or_replace = True
        if self.peek().kind == "IDENT" \
                and self.peek().text.lower() == "view":
            self.next()
            name = self.qualified_name()
            self.expect_kw("as")
            q = self.query()
            return A.CreateView(name, q, or_replace=or_replace)
        if or_replace:
            t = self.peek()
            raise SqlSyntaxError("OR REPLACE only applies to CREATE VIEW",
                                 t.line, t.col)
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.qualified_name()
        props: List[Tuple[str, object]] = []
        if self.accept_kw("with"):
            self.expect_op("(")
            while True:
                key = self.identifier()
                self.expect_op("=")
                props.append((key, self._property_value()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_kw("as")
        return A.CreateTableAsSelect(name, self.query(), if_not_exists,
                                     properties=tuple(props))

    def _property_value(self):
        """Table property literal: string/number/bool or ARRAY[...] of
        strings (reference sql/tree/Property.java values)."""
        t = self.peek()
        if t.kind == "IDENT" and t.text.lower() == "array":
            self.next()
            self.expect_op("[")
            items: List[object] = []
            if not self.accept_op("]"):
                while True:
                    items.append(self._property_value())
                    if not self.accept_op(","):
                        break
                self.expect_op("]")
            return tuple(items)
        t = self.next()
        if t.kind == "STRING":
            return t.text          # lexer already unquotes
        if t.kind == "INTEGER":
            return int(t.text)
        if t.kind == "NUMBER":
            return float(t.text)
        if t.kind in ("IDENT", "KEYWORD") \
                and t.text.lower() in ("true", "false"):
            return t.text.lower() == "true"
        raise SqlSyntaxError("expected property value", t.line, t.col)

    # -- queries ------------------------------------------------------------
    def query(self) -> A.Query:
        with_: List[Tuple[str, A.Query]] = []
        if self.accept_kw("with"):
            self.accept_kw("recursive")
            while True:
                cte = self.identifier()
                self.expect_kw("as")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                with_.append((cte, q))
                if not self.accept_op(","):
                    break
        body = self._set_expr()
        # ORDER BY / LIMIT bind at query level (SqlBase.g4 queryNoWith),
        # covering the whole set operation
        order_by = self._order_by()
        limit = self._limit()
        if order_by or limit is not None:
            import dataclasses as _dc
            if isinstance(body, A.ValuesQuery):
                body = A.Query(body=body)
            if isinstance(body, A.Query):
                # '(query) ORDER BY ...': order the parenthesized result —
                # wrap as a subquery so an inner LIMIT/WITH is preserved
                body = A.QuerySpecification(
                    select=(A.SelectItem(A.Star()),),
                    from_=A.SubqueryRelation(body),
                    order_by=order_by, limit=limit)
            else:
                body = _dc.replace(body, order_by=order_by, limit=limit)
        return A.Query(body=body, with_=tuple(with_))

    def _set_expr(self) -> A.Node:
        # UNION/EXCEPT are left-associative peers; INTERSECT binds
        # tighter (SqlBase.g4 queryTerm: setOperation precedence)
        left = self._intersect_term()
        while self.at_kw("union", "except"):
            op = self.next().text
            distinct = True
            if self.accept_kw("all"):
                distinct = False
            else:
                self.accept_kw("distinct")
            right = self._intersect_term()
            left = A.SetOperation(op, distinct, left, right)
        return left

    def _intersect_term(self) -> A.Node:
        left = self._query_term()
        while self.at_kw("intersect"):
            self.next()
            distinct = True
            if self.accept_kw("all"):
                distinct = False
            else:
                self.accept_kw("distinct")
            right = self._query_term()
            left = A.SetOperation("intersect", distinct, left, right)
        return left

    def _query_term(self) -> A.Node:
        if self.accept_op("("):
            q = self.query()          # queryPrimary: '(' queryNoWith ')'
            self.expect_op(")")
            return q
        if self.accept_kw("values"):
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return A.ValuesQuery(tuple(rows))
        return self.query_spec()

    def _values_row(self) -> Tuple[A.Expression, ...]:
        if self.accept_op("("):
            items = [self.expression()]
            while self.accept_op(","):
                items.append(self.expression())
            self.expect_op(")")
            return tuple(items)
        return (self.expression(),)

    def query_spec(self) -> A.QuerySpecification:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = A.Join("implicit", from_, right)
        where = self.expression() if self.accept_kw("where") else None
        group_by: Tuple[A.Expression, ...] = ()
        grouping_sets = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by, grouping_sets = self._group_by()
        having = self.expression() if self.accept_kw("having") else None
        return A.QuerySpecification(
            select=tuple(items), distinct=distinct, from_=from_, where=where,
            group_by=group_by, having=having, grouping_sets=grouping_sets)

    def _group_by(self):
        """GROUP BY: plain expr list, or ROLLUP/CUBE/GROUPING SETS, which
        desugar to (distinct exprs, index sets) — reference
        sql/tree/GroupingSets.java / Rollup.java / Cube.java."""
        def expr_list():
            self.expect_op("(")
            if self.accept_op(")"):
                return []
            out = [self.expression()]
            while self.accept_op(","):
                out.append(self.expression())
            self.expect_op(")")
            return out

        def at_ident(word, then_op=None, then_ident=None):
            t, t1 = self.peek(), self.peek(1)
            if not (t.kind == "IDENT" and t.text == word):
                return False
            if then_op is not None:
                return t1.kind == "OP" and t1.text == then_op
            if then_ident is not None:
                return t1.kind == "IDENT" and t1.text == then_ident
            return True

        def no_mixing():
            if self.at_op(","):
                t = self.peek()
                raise SqlSyntaxError(
                    "mixing ROLLUP/CUBE/GROUPING SETS with plain GROUP BY "
                    "expressions is not supported", t.line, t.col)

        if at_ident("rollup", then_op="("):
            self.next()
            exprs = expr_list()
            no_mixing()
            n = len(exprs)
            sets = [tuple(range(k)) for k in range(n, -1, -1)]
        elif at_ident("cube", then_op="("):
            self.next()
            exprs = expr_list()
            no_mixing()
            n = len(exprs)
            sets = [tuple(i for i in range(n) if m >> i & 1)
                    for m in range((1 << n) - 1, -1, -1)]
        elif at_ident("grouping", then_ident="sets"):
            self.next()
            self.next()
            self.expect_op("(")
            raw_sets = []
            exprs = []
            while True:
                if self.at_op("("):
                    one = expr_list()
                else:
                    one = [self.expression()]
                idxs = []
                for e in one:
                    if e not in exprs:
                        exprs.append(e)
                    idxs.append(exprs.index(e))
                raw_sets.append(tuple(idxs))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            no_mixing()
            sets = raw_sets
        else:
            exprs = [self.expression()]
            while self.accept_op(","):
                if (at_ident("rollup", then_op="(")
                        or at_ident("cube", then_op="(")
                        or at_ident("grouping", then_ident="sets")):
                    t = self.peek()
                    raise SqlSyntaxError(
                        "mixing ROLLUP/CUBE/GROUPING SETS with plain GROUP "
                        "BY expressions is not supported", t.line, t.col)
                exprs.append(self.expression())
            return tuple(exprs), None
        return tuple(exprs), tuple(sets)

    def _order_by(self) -> Tuple[A.SortItem, ...]:
        if not self.accept_kw("order"):
            return ()
        self.expect_kw("by")
        items = [self._sort_item()]
        while self.accept_op(","):
            items.append(self._sort_item())
        return tuple(items)

    def _sort_item(self) -> A.SortItem:
        key = self.expression()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nulls_first: Optional[bool] = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return A.SortItem(key, asc, nulls_first)

    def _limit(self) -> Optional[int]:
        if self.accept_kw("limit"):
            t = self.expect_kind("INTEGER")
            return int(t.text)
        return None

    def _select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        # t.* form
        if (self.peek().kind in ("IDENT", "QIDENT") and self.peek(1).kind == "OP"
                and self.peek(1).text == "." and self.peek(2).kind == "OP"
                and self.peek(2).text == "*"):
            q = self.identifier()
            self.next()
            self.next()
            return A.SelectItem(A.Star(qualifier=q))
        e = self.expression()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT"):
            alias = self.identifier()
        return A.SelectItem(e, alias)

    # -- relations ----------------------------------------------------------
    def _relation(self) -> A.Relation:
        left = self._aliased_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self._aliased_relation()
                left = A.Join("cross", left, right)
                continue
            join_type = None
            if self.at_kw("join"):
                join_type = "inner"
            elif self.at_kw("inner"):
                join_type = "inner"
                self.next()
            elif self.at_kw("left"):
                join_type = "left"
                self.next()
                self.accept_kw("outer")
            elif self.at_kw("right"):
                join_type = "right"
                self.next()
                self.accept_kw("outer")
            elif self.at_kw("full"):
                join_type = "full"
                self.next()
                self.accept_kw("outer")
            if join_type is None:
                return left
            self.expect_kw("join")
            right = self._aliased_relation()
            self.expect_kw("on")
            cond = self.expression()
            left = A.Join(join_type, left, right, cond)

    def _aliased_relation(self) -> A.Relation:
        rel = self._primary_relation()
        alias = None
        cols: Tuple[str, ...] = ()
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT"):
            alias = self.identifier()
        if alias is not None and self.at_op("("):
            # aliased column list: t(a, b, c)
            self.next()
            names = [self.identifier()]
            while self.accept_op(","):
                names.append(self.identifier())
            self.expect_op(")")
            cols = tuple(names)
        if alias is not None:
            return A.AliasedRelation(rel, alias, cols)
        return rel

    def _primary_relation(self) -> A.Relation:
        if self.accept_op("("):
            # disambiguate subquery vs parenthesized join tree (the
            # reference grammar's aliasedRelation '(' relation ')' branch
            # vs subquery, SqlBase.g4). A leading SELECT usually means a
            # subquery, but '((select ...) t JOIN ...)' is a relation —
            # try the query parse and backtrack if the close paren
            # doesn't follow.
            j = 0
            while self.peek(j).kind == "OP" and self.peek(j).text == "(":
                j += 1
            t = self.peek(j)
            starts_query = (t.kind == "KEYWORD"
                            and t.text in ("select", "with", "values"))
            if self.at_kw("select", "with", "values") or starts_query:
                mark = self.i
                try:
                    q = self.query()
                    if self.at_op(")"):
                        self.next()
                        return A.SubqueryRelation(q)
                except SqlSyntaxError:
                    pass
                self.i = mark            # a join tree follows: relation
            rel = self._relation()
            self.expect_op(")")
            return rel
        t = self.peek()
        if t.kind == "IDENT" and t.text.lower() == "unnest" \
                and self.peek(1).kind == "OP" and self.peek(1).text == "(":
            self.next()
            self.next()
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            ordinality = False
            if self.accept_kw("with"):
                w = self.next()
                if w.text.lower() != "ordinality":
                    raise SqlSyntaxError("expected ORDINALITY",
                                         w.line, w.col)
                ordinality = True
            return A.Unnest(tuple(exprs), ordinality)
        return A.Table(self.qualified_name())

    # -- expressions (Pratt) ------------------------------------------------
    def expression(self) -> A.Expression:
        return self._or_expr()

    def _or_expr(self) -> A.Expression:
        left = self._and_expr()
        while self.accept_kw("or"):
            left = A.LogicalBinary("or", left, self._and_expr())
        return left

    def _and_expr(self) -> A.Expression:
        left = self._not_expr()
        while self.accept_kw("and"):
            left = A.LogicalBinary("and", left, self._not_expr())
        return left

    def _not_expr(self) -> A.Expression:
        if self.accept_kw("not"):
            return A.Not(self._not_expr())
        return self._predicate()

    def _predicate(self) -> A.Expression:
        left = self._additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().text
                if op == "!=":
                    op = "<>"
                right = self._additive()
                left = A.Comparison(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                if not self.at_kw("between", "in", "like"):
                    # NOT here belongs to an IS NOT NULL-style form or is an
                    # error; rewind and stop
                    self.i = save
                    return left
                negated = True
            if self.accept_kw("between"):
                lo = self._additive()
                self.expect_kw("and")
                hi = self._additive()
                left = A.Between(left, lo, hi, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = A.InSubquery(left, q, negated)
                else:
                    items = [self.expression()]
                    while self.accept_op(","):
                        items.append(self.expression())
                    self.expect_op(")")
                    left = A.InList(left, tuple(items), negated)
                continue
            if self.accept_kw("like"):
                pattern = self._additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self._additive()
                left = A.Like(left, pattern, escape, negated)
                continue
            if self.at_kw("is"):
                self.next()
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = A.IsNull(left, neg)
                continue
            return left

    def _additive(self) -> A.Expression:
        left = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().text
                left = A.ArithmeticBinary(op, left, self._multiplicative())
            elif self.at_op("||"):
                self.next()
                left = A.FunctionCall("concat", (left, self._multiplicative()))
            else:
                return left

    def _multiplicative(self) -> A.Expression:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = A.ArithmeticBinary(op, left, self._unary())
        return left

    def _unary(self) -> A.Expression:
        if self.at_op("-", "+"):
            op = self.next().text
            v = self._unary()
            # the fold keeps the unsigned literal's magnitude, which
            # types it (analyzer.literal_type): -2147483648 stays BIGINT
            if op == "-" and isinstance(v, A.LongLiteral):
                return A.LongLiteral(-v.value)
            if op == "-" and isinstance(v, A.DecimalLiteral):
                return A.DecimalLiteral(-v.value)
            if op == "-" and isinstance(v, A.DoubleLiteral):
                return A.DoubleLiteral(-v.value)
            return A.ArithmeticUnary(op, v) if op == "-" else v
        return self._primary()

    def _primary(self) -> A.Expression:
        t = self.peek()
        if t.kind == "OP" and t.text == "?":
            self.next()
            self._param_count = getattr(self, "_param_count", 0)
            idx = self._param_count
            self._param_count += 1
            return A.Parameter(idx)
        # lambda: x -> expr  |  (x, y) -> expr
        if t.kind in ("IDENT", "QIDENT") and self.peek(1).kind == "OP" \
                and self.peek(1).text == "->":
            name = self.identifier()
            self.expect_op("->")
            return A.Lambda((name,), self.expression())
        if t.kind == "OP" and t.text == "(":
            params = self._try_lambda_params()
            if params is not None:
                return A.Lambda(params, self.expression())
        if t.kind == "IDENT" and t.text.lower() == "array" \
                and self.peek(1).kind == "OP" and self.peek(1).text == "[":
            self.next()
            self.next()
            items: List[A.Expression] = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return self._postfix(A.ArrayLiteral(tuple(items)))
        if t.kind == "INTEGER":
            self.next()
            return A.LongLiteral(int(t.text))
        if t.kind == "NUMBER":
            self.next()
            if "e" in t.text.lower():
                return A.DoubleLiteral(float(t.text))
            return A.DecimalLiteral(Decimal(t.text))
        if t.kind == "STRING":
            self.next()
            return A.StringLiteral(t.text)
        if t.kind == "KEYWORD":
            return self._keyword_primary(t)
        if t.kind == "OP" and t.text == "(":
            self.next()
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.expression()
            self.expect_op(")")
            return self._postfix(e)
        if t.kind in ("IDENT", "QIDENT"):
            return self._ident_primary()
        raise SqlSyntaxError(f"unexpected token {t.text!r}", t.line, t.col)

    def _keyword_primary(self, t: Token) -> A.Expression:
        w = t.text
        if w == "null":
            self.next()
            return A.NullLiteral()
        if w in ("true", "false"):
            self.next()
            return A.BooleanLiteral(w == "true")
        if w == "date":
            if self.peek(1).kind == "STRING":
                self.next()
                s = self.next()
                return A.DateLiteral(s.text)
            return self._ident_primary()
        if w == "timestamp" and self.peek(1).kind == "STRING":
            self.next()
            s = self.next()
            return A.FunctionCall("parse_timestamp_literal",
                                  (A.StringLiteral(s.text),))
        if w == "interval":
            self.next()
            sign = 1
            if self.accept_op("-"):
                sign = -1
            else:
                self.accept_op("+")
            v = self.expect_kind("STRING")
            unit_t = self.peek()
            if not (unit_t.kind == "KEYWORD" and unit_t.text in (
                    "year", "month", "day", "hour", "minute", "second")):
                raise SqlSyntaxError("expected interval unit",
                                     unit_t.line, unit_t.col)
            self.next()
            return A.IntervalLiteral(v.text, unit_t.text, sign)
        if w in ("cast", "try_cast"):
            self.next()
            self.expect_op("(")
            e = self.expression()
            self.expect_kw("as")
            type_name = self._type_name()
            self.expect_op(")")
            return self._postfix(A.Cast(e, type_name, try_cast=(w == "try_cast")))
        if w == "extract":
            self.next()
            self.expect_op("(")
            field = self.identifier() if not self.peek().kind == "KEYWORD" \
                else self.next().text
            self.expect_kw("from")
            e = self.expression()
            self.expect_op(")")
            return A.Extract(field, e)
        if w == "case":
            return self._case()
        if w == "exists":
            self.next()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return A.Exists(q)
        if w == "coalesce":
            self.next()
            self.expect_op("(")
            args = [self.expression()]
            while self.accept_op(","):
                args.append(self.expression())
            self.expect_op(")")
            return A.Coalesce(tuple(args))
        if w == "nullif":
            self.next()
            self.expect_op("(")
            first = self.expression()
            self.expect_op(",")
            second = self.expression()
            self.expect_op(")")
            return A.NullIf(first, second)
        if w in NON_RESERVED:
            return self._ident_primary()
        raise SqlSyntaxError(f"unexpected keyword {w!r}", t.line, t.col)

    def _case(self) -> A.Expression:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expression()
        whens = []
        while self.accept_kw("when"):
            cond = self.expression()
            self.expect_kw("then")
            res = self.expression()
            whens.append(A.WhenClause(cond, res))
        default = None
        if self.accept_kw("else"):
            default = self.expression()
        self.expect_kw("end")
        if operand is not None:
            return A.SimpleCase(operand, tuple(whens), default)
        return A.SearchedCase(tuple(whens), default)

    def _type_name(self) -> str:
        base = self.identifier() if self.peek().kind != "KEYWORD" \
            else self.next().text
        if base.lower() in ("array", "map") and self.accept_op("("):
            args = [self._type_name()]
            while self.accept_op(","):
                args.append(self._type_name())
            self.expect_op(")")
            return f"{base}({','.join(args)})"
        if self.accept_op("("):
            args = [self.expect_kind("INTEGER").text]
            while self.accept_op(","):
                args.append(self.expect_kind("INTEGER").text)
            self.expect_op(")")
            return f"{base}({','.join(args)})"
        return base

    def _ident_primary(self) -> A.Expression:
        # DECIMAL 'ddd.dd' typed literal (reference SqlBase.g4
        # DECIMAL_VALUE / AstBuilder.visitTypeConstructor)
        t = self.peek()
        if t.kind == "IDENT" and t.text.lower() == "decimal" \
                and self.peek(1).kind == "STRING":
            self.next()
            s = self.next()
            try:
                d = Decimal(s.text.strip())
                if not d.is_finite():
                    raise ValueError("non-finite")
                # normalize exponent forms (1E5) to plain digits so the
                # (precision, scale) derivation sees the true magnitude
                if int(d.as_tuple().exponent) > 0:
                    d = d.quantize(Decimal(1))
                return A.DecimalLiteral(d)
            except SqlSyntaxError:
                raise
            except Exception as e:
                raise SqlSyntaxError(f"bad DECIMAL literal {s.text!r}",
                                     t.line, t.col) from e
        name = self.identifier()
        # function call?
        if self.at_op("("):
            self.next()
            if self.accept_op("*"):
                self.expect_op(")")
                return self._maybe_window(
                    A.FunctionCall(name.lower(), (), is_star=True))
            distinct = False
            args: List[A.Expression] = []
            if not self.at_op(")"):
                if self.accept_kw("distinct"):
                    distinct = True
                else:
                    self.accept_kw("all")
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
            self.expect_op(")")
            return self._postfix(self._maybe_window(
                A.FunctionCall(name.lower(), tuple(args), distinct=distinct)))
        e: A.Expression = A.Identifier(name)
        return self._postfix(e)

    def _maybe_window(self, call: A.FunctionCall) -> A.Expression:
        """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame])."""
        if not self.at_kw("over"):
            return call
        self.next()
        self.expect_op("(")
        partition: List[A.Expression] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expression())
            while self.accept_op(","):
                partition.append(self.expression())
        order_by = self._order_by()
        # full frame grammar (reference operator/window/FrameInfo.java):
        # ROWS|RANGE [BETWEEN] <bound> [AND <bound>], bounds = UNBOUNDED
        # PRECEDING | <n> PRECEDING | CURRENT ROW | <n> FOLLOWING |
        # UNBOUNDED FOLLOWING. Default: RANGE UNBOUNDED..CURRENT ROW.
        frame = "range"
        fstart = ("unbounded_preceding", 0)
        fend = ("current_row", 0)
        if self.at_kw("rows", "range"):
            frame = "rows" if self.at_kw("rows") else "range"
            self.next()
            if self.accept_kw("between"):
                fstart = self._frame_bound()
                self.expect_kw("and")
                fend = self._frame_bound()
            else:
                # frame-start-only spelling: end defaults to CURRENT ROW
                fstart = self._frame_bound()
            t = self.peek()
            if fstart[0] == "unbounded_following":
                raise SqlSyntaxError(
                    "frame start cannot be UNBOUNDED FOLLOWING",
                    t.line, t.col)
            if fend[0] == "unbounded_preceding":
                raise SqlSyntaxError(
                    "frame end cannot be UNBOUNDED PRECEDING",
                    t.line, t.col)
            order_rank = {"unbounded_preceding": 0, "preceding": 1,
                          "current_row": 2, "following": 3,
                          "unbounded_following": 4}
            if order_rank[fstart[0]] > order_rank[fend[0]]:
                raise SqlSyntaxError("frame start cannot follow frame end",
                                     t.line, t.col)
        self.expect_op(")")
        return A.WindowFunction(call, tuple(partition), order_by, frame,
                                fstart, fend)

    def _frame_bound(self) -> tuple:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return ("unbounded_preceding", 0)
            self.expect_kw("following")
            return ("unbounded_following", 0)
        if self.accept_kw("current"):
            self.expect_kw("row")
            return ("current_row", 0)
        tok = self.peek()
        if tok.kind != "INTEGER":
            raise SqlSyntaxError("frame offset must be an integer literal",
                                 tok.line, tok.col)
        n = int(tok.text)
        self.next()
        if self.accept_kw("preceding"):
            return ("preceding", n)
        self.expect_kw("following")
        return ("following", n)

    def _try_lambda_params(self) -> Optional[Tuple[str, ...]]:
        """Consume '(a, b, ...) ->' if present; None (no consumption)
        otherwise."""
        save = self.i
        if not self.accept_op("("):
            return None
        names: List[str] = []
        while self.peek().kind in ("IDENT", "QIDENT"):
            names.append(self.identifier())
            if self.accept_op(","):
                continue
            break
        if names and self.accept_op(")") and self.accept_op("->"):
            return tuple(names)
        self.i = save
        return None

    def _postfix(self, e: A.Expression) -> A.Expression:
        while True:
            if self.at_op(".") and (
                    self.peek(1).kind in ("IDENT", "QIDENT")
                    or (self.peek(1).kind == "KEYWORD"
                        and self.peek(1).text in NON_RESERVED)):
                self.next()
                e = A.DereferenceExpression(e, A.Identifier(self.identifier()))
                continue
            if self.at_op("["):
                self.next()
                idx = self.expression()
                self.expect_op("]")
                e = A.Subscript(e, idx)
                continue
            return e
