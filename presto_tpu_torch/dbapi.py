"""PEP 249 (DB-API 2.0) interface over the statement protocol.

The counterpart of ``presto_tpu/dbapi.py`` (the role of the reference's
JDBC driver, presto-jdbc/PrestoConnection.java, PrestoStatement,
PrestoResultSet wrapping the REST protocol): standard cursor semantics
over :class:`client.StatementClient`. ``paramstyle`` is qmark;
parameters bind client-side with SQL-literal escaping, as the reference's
python client interpolates them.
"""
from __future__ import annotations

import datetime
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from .client import QueryFailed, StatementClient

apilevel = "2.0"
threadsafety = 1           # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


def _quote(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, datetime.datetime):
        return f"timestamp '{value.strftime('%Y-%m-%d %H:%M:%S.%f')}'"
    if isinstance(value, datetime.date):
        return f"date '{value.isoformat()}'"
    if isinstance(value, (list, tuple)):
        return "array[" + ", ".join(_quote(v) for v in value) + "]"
    s = str(value).replace("'", "''")
    return f"'{s}'"


def _bind(operation: str, parameters: Optional[Sequence[Any]]) -> str:
    """qmark substitution outside string literals, quoted identifiers,
    and comments (the lexer accepts --, /* */ and \"...\")."""
    if parameters is None:
        return operation
    out: List[str] = []
    it = iter(parameters)
    used = 0
    i = 0
    n = len(operation)
    while i < n:
        ch = operation[i]
        if ch == "'" or ch == '"':
            q = ch
            j = i + 1
            while j < n:
                if operation[j] == q:
                    if q == "'" and j + 1 < n and operation[j + 1] == "'":
                        j += 2          # escaped '' inside a string
                        continue
                    break
                j += 1
            out.append(operation[i:j + 1])
            i = j + 1
        elif ch == "-" and operation[i:i + 2] == "--":
            j = operation.find("\n", i)
            j = n if j < 0 else j
            out.append(operation[i:j])
            i = j
        elif ch == "/" and operation[i:i + 2] == "/*":
            j = operation.find("*/", i)
            j = n if j < 0 else j + 2
            out.append(operation[i:j])
            i = j
        elif ch == "?":
            try:
                out.append(_quote(next(it)))
                used += 1
            except StopIteration:
                raise ProgrammingError(
                    "not enough parameters for placeholders")
            i += 1
        else:
            out.append(ch)
            i += 1
    if used != len(parameters):
        raise ProgrammingError(
            f"{len(parameters)} parameters for {used} placeholders")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: List[tuple] = []
        self._pos = 0
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self._closed = False

    # -- execution -----------------------------------------------------------
    def execute(self, operation: str,
                parameters: Optional[Sequence[Any]] = None) -> "Cursor":
        self._check_open()
        sql = _bind(operation, parameters)
        try:
            res = self._conn._client.execute(sql)
        except QueryFailed as e:
            raise DatabaseError(str(e)) from e
        self._rows = [tuple(r) for r in res.rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        # PEP 249 7-tuples: (name, type_code, None, None, None, None, None)
        self.description = [(name, type_code, None, None, None, None, None)
                            for name, type_code in res.columns] or None
        return self

    def executemany(self, operation: str,
                    seq_of_parameters: Sequence[Sequence[Any]]) -> "Cursor":
        for params in seq_of_parameters:
            self.execute(operation, params)
        return self

    # -- fetch ---------------------------------------------------------------
    def fetchone(self) -> Optional[tuple]:
        self._check_open()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check_open()
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        self._check_open()
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self) -> Iterator[tuple]:
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    # -- misc ----------------------------------------------------------------
    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def close(self) -> None:
        self._closed = True
        self._rows = []

    def _check_open(self) -> None:
        if self._closed or self._conn._closed:
            raise InterfaceError("cursor is closed")

    def __enter__(self) -> "Cursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Connection:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 user: str = "presto", catalog: Optional[str] = None,
                 schema: Optional[str] = None, scheme: str = "http",
                 password: Optional[str] = None):
        url = f"{scheme}://{host}:{port}"
        self._client = StatementClient(url, user=user, catalog=catalog,
                                       schema=schema, password=password)
        self._closed = False

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self) -> None:
        self._exec_tx("commit")

    def rollback(self) -> None:
        self._exec_tx("rollback")

    def _exec_tx(self, stmt: str) -> None:
        if self._closed:
            raise InterfaceError("connection is closed")
        try:
            self._client.execute(stmt)
        except QueryFailed as e:
            # auto-commit mode: "no transaction in progress" is fine;
            # a real COMMIT/ROLLBACK failure must surface
            if "no transaction" in str(e).lower():
                return
            raise DatabaseError(str(e)) from e

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(host: str = "127.0.0.1", port: int = 8080, **kwargs
            ) -> Connection:
    """DB-API 2.0 module entry (reference PrestoDriver.connect)."""
    return Connection(host=host, port=port, **kwargs)
