"""Statement protocol client: POST /v1/statement, follow nextUri.

The counterpart of ``presto_tpu/client.py`` (the reference client,
presto-client/.../StatementClientV1.java:86: execute():147 POSTs the
statement, advance():339 follows ``nextUri`` until it is absent; session
mutations arrive in X-Presto-Set-Session / X-Presto-Clear-Session
response headers, client/PrestoHeaders.java:30-31). Standard library
only: the client never touches a tensor, so it speaks to a server on any
device.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple


class QueryFailed(Exception):
    def __init__(self, error: Dict):
        super().__init__(error.get("message", "query failed"))
        self.error = error


@dataclasses.dataclass
class ClientResult:
    columns: List[Tuple[str, str]]          # (name, type display)
    rows: List[List[object]]
    query_id: str


class _RawHTTPConnection:
    """Minimal HTTP/1.1 keep-alive transport for the statement
    protocol. ``http.client`` parses every response's headers through
    the email package (~40% of a warm statement's CLIENT-side CPU at
    serving rates); the statement server's responses are plain
    HTTP/1.1 with an explicit Content-Length and no chunking, so a
    status line + header-lines + counted-body reader covers them in a
    fraction of the cost. Anything off-pattern (no Content-Length, a
    1.0 server) raises ``ConnectionError`` — an OSError, which the
    caller's stale-connection retry already handles, falling back to a
    fresh connection."""

    def __init__(self, netloc: str, timeout: float):
        import socket
        host, _, port = netloc.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or 80)), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self.sock.makefile("rb", buffering=65536)
        self._host = netloc
        self.closed = False

    def close(self) -> None:
        self.closed = True
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def send_request(self, method: str, path: str,
                     headers: Dict[str, str],
                     body: Optional[bytes]) -> None:
        body = body or b""
        lines = [f"{method} {path} HTTP/1.1",
                 f"Host: {self._host}",
                 f"Content-Length: {len(body)}"]
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        self.sock.sendall(
            ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)

    def read_response(self):
        """Returns ``(status, reason, headers_dict, data)``. Raises
        OSError subclasses on transport trouble so callers can retry on
        a fresh connection."""
        status_line = self._rfile.readline(65537)
        if not status_line:
            raise ConnectionResetError("server closed the connection")
        parts = status_line.decode("latin-1").rstrip("\r\n").split(" ", 2)
        try:
            status = int(parts[1])
        except (IndexError, ValueError):
            raise ConnectionError(
                f"malformed status line {status_line!r}") from None
        if not parts[0].startswith("HTTP/1."):
            raise ConnectionError(f"not an HTTP/1.x response: {parts[0]!r}")
        reason = parts[2] if len(parts) > 2 else ""
        resp_headers: Dict[str, str] = {}
        while True:
            line = self._rfile.readline(65537)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            resp_headers[k.strip()] = v.strip()
        try:
            length = int(resp_headers["Content-Length"])
        except (KeyError, ValueError):
            raise ConnectionError(
                "response without a usable Content-Length") from None
        data = self._rfile.read(length)
        if len(data) != length:
            raise ConnectionResetError("short response body")
        if resp_headers.get("Connection", "").lower() == "close":
            self.close()
        return status, reason, resp_headers, data


class StatementClient:
    def __init__(self, base_url: str, user: str = "presto",
                 catalog: Optional[str] = None,
                 schema: Optional[str] = None,
                 timeout: float = 3600.0,
                 password: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.catalog = catalog
        self.schema = schema
        self.timeout = timeout
        self.password = password
        self.session_properties: Dict[str, str] = {}
        # persistent keep-alive connection (the server speaks
        # HTTP/1.1): a serving fleet issuing thousands of short
        # statements must not pay a TCP handshake per request — at 100
        # concurrent clients the fresh-connection storm overflows
        # listen backlogs and the SYN retransmits quantize cache-hit
        # latencies to whole seconds. One connection per client
        # instance; clients are thread-confined like the reference's.
        self._conn = None
        self._conn_netloc: Optional[str] = None

    # -- protocol ------------------------------------------------------------
    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None
                self._conn_netloc = None

    def _connection(self, netloc: str) -> _RawHTTPConnection:
        if (self._conn is None or self._conn.closed
                or self._conn_netloc != netloc):
            self.close()
            self._conn = _RawHTTPConnection(netloc, timeout=self.timeout)
            self._conn_netloc = netloc
        return self._conn

    def _headers(self) -> Dict[str, str]:
        """Request headers; the static part builds once per client and
        the session overlay re-renders only when it changed (a serving
        client issues thousands of identical-header requests)."""
        cached = getattr(self, "_hdr_cache", None)
        if cached is not None and cached[0] == self.session_properties:
            return cached[1]
        headers = {"X-Presto-User": self.user}
        if self.password is not None:
            import base64
            raw = f"{self.user}:{self.password}".encode()
            headers["Authorization"] = \
                "Basic " + base64.b64encode(raw).decode()
        if self.catalog:
            headers["X-Presto-Catalog"] = self.catalog
        if self.schema:
            headers["X-Presto-Schema"] = self.schema
        if self.session_properties:
            headers["X-Presto-Session"] = ",".join(
                f"{k}={urllib.parse.quote(str(v))}"
                for k, v in self.session_properties.items())
        self._hdr_cache = (dict(self.session_properties), headers)
        return headers

    def _request(self, url: str, method: str = "GET",
                 body: Optional[bytes] = None):
        headers = self._headers()
        parts = urllib.parse.urlsplit(url)
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        status = reason = resp_headers = data = None
        for attempt in (0, 1):
            conn = self._connection(parts.netloc)
            sent = False
            try:
                conn.send_request(method, path, headers, body)
                sent = True
                status, reason, resp_headers, data = conn.read_response()
                break
            except OSError as e:
                # server closed the idle keep-alive (or first use of a
                # stale connection): reconnect once, then surface. A
                # non-idempotent request that FAILED AFTER SENDING is
                # never replayed — the server may have executed it
                # (POST /v1/statement runs INSERTs); the caller sees
                # the transport error instead of silent double writes.
                # The annotation lets a failover policy (FleetClient)
                # make the same distinction.
                e.sent_request = sent
                self.close()
                if attempt or (sent and method != "GET"):
                    raise
        if status >= 400:
            # urllib-compatible error surface for callers that catch
            # HTTPError (drain 503s, auth 401s)
            import io
            raise urllib.error.HTTPError(url, status, reason,
                                         resp_headers, io.BytesIO(data))
        doc = json.loads(data or b"{}")
        for header, value in resp_headers.items():
            if header == "X-Presto-Set-Session" and "=" in value:
                k, v = value.split("=", 1)
                self.session_properties[k.strip()] = v.strip()
            elif header == "X-Presto-Clear-Session":
                self.session_properties.pop(value.strip(), None)
        return doc

    def pages(self, sql: str) -> Iterator[Dict]:
        """Yield raw QueryResults documents until the query drains."""
        doc = self._request(f"{self.base_url}/v1/statement", "POST",
                            sql.encode())
        yield doc
        while doc.get("nextUri"):
            doc = self._request(doc["nextUri"])
            yield doc
        if doc.get("error"):
            raise QueryFailed(doc["error"])

    def execute(self, sql: str) -> ClientResult:
        columns: List[Tuple[str, str]] = []
        rows: List[List[object]] = []
        qid = ""
        for doc in self.pages(sql):
            qid = doc.get("id", qid)
            if doc.get("columns") and not columns:
                columns = [(c["name"], c["type"]) for c in doc["columns"]]
            rows.extend(doc.get("data") or [])
        nested = [(i, t) for i, (_, t) in enumerate(columns)
                  if t.startswith(("array(", "map("))]
        for row in rows if nested else ():
            for i, t in nested:
                row[i] = _typed_value(row[i], t)
        return ClientResult(columns=columns, rows=rows, query_id=qid)


def _type_args(text: str) -> List[str]:
    """The top-level arguments of ``name(a, b(c, d))``: ``['a',
    'b(c, d)']``."""
    inner = text[text.index("(") + 1:text.rindex(")")]
    out, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(inner[start:i].strip())
            start = i + 1
    out.append(inner[start:].strip())
    return out


def _typed_value(v, type_text: str):
    """An ARRAY's JSON array as a list and a MAP's JSON object as a dict
    whose keys take the key type back from their text (the protocol
    carries every map key as a JSON string), element by element."""
    if v is None:
        return None
    if type_text.startswith("array("):
        (elem,) = _type_args(type_text)
        return [_typed_value(x, elem) for x in v]
    if type_text.startswith("map("):
        key_t, val_t = _type_args(type_text)
        return {_typed_key(k, key_t): _typed_value(x, val_t)
                for k, x in v.items()}
    return v


def _typed_key(k: str, type_text: str):
    if type_text in ("tinyint", "smallint", "integer", "bigint"):
        return int(k)
    if type_text in ("double", "real"):
        return float(k)
    if type_text == "boolean":
        return k == "true"
    return k


class FleetClient:
    """Round-robin, retry-on-failure statement client over a
    coordinator fleet.

    Statements rotate across the fleet's coordinators; a dispatch that
    fails on TRANSPORT (connection refused/reset — a crashed
    coordinator) or DRAIN (503 — a coordinator mid-rolling-restart)
    re-dispatches the whole statement to the next coordinator, up to
    two passes over the fleet. A statement that fails mid-pagination
    (the coordinator died while the client was following ``nextUri``)
    re-dispatches from scratch the same way — re-execution is cheap on
    a warm fleet (template/result caches), and pages already collected
    from the dead coordinator are discarded, never mixed with the
    retry's.

    Engine verdicts (:class:`QueryFailed`) and non-503 HTTP errors are
    the QUERY's outcome, not the coordinator's — they surface without
    retry.

    ``replay_sent=True`` (default) retries even non-GET requests that
    failed AFTER the request body was sent, making dispatch
    at-least-once: a coordinator that dies between executing an INSERT
    and answering may leave the INSERT applied, and the retry applies
    it again. Read-dominant serving fleets want this (availability over
    exactly-once side effects); set ``replay_sent=False`` to surface
    those ambiguous failures instead, like :class:`StatementClient`
    does.

    Thread-confined, like :class:`StatementClient` (one underlying
    keep-alive connection per coordinator)."""

    #: process-wide instance counter staggering each client's ring
    #: start. Without it every instance begins at coordinator 0 and a
    #: fleet of C coordinators serving clients issuing Q statements
    #: each splits ceil/floor(Q/C) per coordinator — at Q=8, C=3 the
    #: last coordinator systematically gets 2/8 of ALL traffic.
    _instances = itertools.count()

    def __init__(self, base_urls, user: str = "presto",
                 replay_sent: bool = True, fleet_passes: int = 2,
                 **client_kwargs):
        urls = list(base_urls)
        if not urls:
            raise ValueError("FleetClient needs at least one "
                             "coordinator URL")
        self.clients = [StatementClient(u, user=user, **client_kwargs)
                        for u in urls]
        self.replay_sent = replay_sent
        self.fleet_passes = max(1, int(fleet_passes))
        self._rr = next(FleetClient._instances) % len(urls)
        #: statements that needed >1 dispatch attempt
        self.retries_total = 0
        #: dispatch attempts moved to a DIFFERENT coordinator
        self.failovers_total = 0

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def _ring(self) -> List[StatementClient]:
        """This statement's coordinator order: round-robin start, then
        the rest of the fleet in ring order (the failover chain)."""
        start = self._rr
        self._rr = (self._rr + 1) % len(self.clients)
        n = len(self.clients)
        return [self.clients[(start + k) % n] for k in range(n)]

    def _retryable(self, e: Exception) -> bool:
        import http.client
        if isinstance(e, urllib.error.HTTPError):
            return e.code == 503          # drain; 4xx/5xx else = verdict
        if isinstance(e, (OSError, http.client.HTTPException)):
            if getattr(e, "sent_request", False) and not self.replay_sent:
                return False              # ambiguous non-GET: surface
            return True
        return False

    def execute(self, sql: str) -> ClientResult:
        ring = self._ring()
        last: Optional[Exception] = None
        attempts = 0
        for _ in range(self.fleet_passes):
            for cl in ring:
                attempts += 1
                try:
                    res = cl.execute(sql)
                    if attempts > 1:
                        self.retries_total += 1
                    return res
                except QueryFailed:
                    raise
                except Exception as e:
                    if not self._retryable(e):
                        raise
                    last = e
                    self.failovers_total += 1
        raise last if last is not None else RuntimeError(
            "fleet dispatch failed")
