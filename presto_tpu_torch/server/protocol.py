"""HTTP statement protocol: the client-facing front door.

The counterpart of ``presto_tpu/server/protocol.py``, wire-compatible
(for the paths a basic client uses) with the reference's statement
protocol (presto-client/.../StatementClientV1.java:147 POSTs
/v1/statement then polls ``nextUri`` :339 until it disappears;
dispatcher/QueuedStatementResource.java:146-167 and
server/protocol/ExecutingStatementResource.java:147 serve it):

- ``POST /v1/statement`` with the SQL body and X-Presto-* session headers
  returns a QueryResults JSON document whose ``nextUri`` pages through
  results;
- ``GET  /v1/statement/executing/{id}/{slug}/{token}`` returns columns +
  a data page + the next ``nextUri`` (absent on the final page);
- ``DELETE /v1/statement/executing/{id}/{slug}/{token}`` cancels;
- session mutations round-trip through response headers
  (X-Presto-Set-Session / X-Presto-Clear-Session, reference
  client/PrestoHeaders.java:30-31), keeping the server stateless about
  client session state.

Statements execute on a LocalRunner (on its device: the GPU unless the
runner was made for another) in a pooled worker thread, or in the HTTP
handler's own thread on the inline lane; pages stream from a bounded
queue, the role of the coordinator's per-query output buffer (reference
server/protocol/Query.java:99 pulling via ExchangeClient). Threads are
reused, so each statement runs in a fresh ``contextvars.Context``: the
binding scope of ``expr/params.py``, the profile session and operator of
``obs/profiler.py`` and the tracer's current span start unset for every
statement, whatever the thread ran before. The protocol itself is host
code: rows arrive from the runner as host values and leave as JSON.
"""
from __future__ import annotations

import collections
import contextvars
import datetime
import json
import math
import os
import queue
import secrets
import threading
import time
import urllib.parse
from decimal import Decimal

from .._devtools.lockcheck import checked_lock
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

ROWS_PER_PAGE = 4096


def _json_value(v):
    if v is None or isinstance(v, (int, float, str, bool)):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        return v
    if hasattr(v, "item"):            # numpy scalar
        return _json_value(v.item())
    if isinstance(v, datetime.date):
        return v.isoformat()
    if isinstance(v, Decimal):
        return str(v)
    # Presto's client protocol: an ARRAY is a JSON array and a MAP a
    # JSON object (keys as their text), element by element
    if isinstance(v, (list, tuple)):
        return [_json_value(x) for x in v]
    if isinstance(v, dict):
        return {_json_key(k): _json_value(x) for k, x in v.items()}
    return str(v)


def _json_key(k) -> str:
    k = _json_value(k)
    if isinstance(k, bool):
        return "true" if k else "false"
    return str(k)


def _runner_accepts_serving(runner) -> bool:
    import inspect
    try:
        return "serving" in inspect.signature(
            runner.execute).parameters
    except (TypeError, ValueError):
        return False


class _ProducerPool:
    """Shared daemon worker pool for statement producers. A serving
    fleet at hundreds of statements/sec paid a fresh thread spawn per
    query (~100µs of pure GIL churn on a ~1ms cache hit); workers here
    are reused and spawn lazily up to the cap. Tasks beyond the cap
    queue — safe, because a producer blocked in admission is woken by a
    grant from a RUNNING producer finishing, never by a task that has
    yet to start. Daemon threads, like the per-query threads they
    replace: interpreter exit never hangs on an abandoned statement."""

    def __init__(self, cap: int = 256):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._cap = cap
        self._threads = 0
        self._idle = 0
        self._lock = checked_lock("protocol.producers")

    def submit(self, fn) -> None:
        self._q.put(fn)
        with self._lock:
            if self._idle == 0 and self._threads < self._cap:
                self._threads += 1
                threading.Thread(target=self._worker,
                                 daemon=True).start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get()
            finally:
                with self._lock:
                    self._idle -= 1
            try:
                fn()
            except Exception:
                pass                 # _run reports its own errors
            # an idle worker must not pin its last statement (the query,
            # its buffered pages and its admission) until the next task
            fn = None


_PRODUCERS = _ProducerPool()


class _InlinePages:
    """Page channel for the inline lane. The producer runs to
    completion in the consumer's own thread before any reader can
    exist (``_Query.__init__`` calls ``_run()`` synchronously), so a
    plain deque replaces ``queue.Queue`` — six threading-primitive
    constructions plus a lock round-trip per put/get, per statement,
    on the hottest path. Classic paging from another handler thread
    after the POST returned is still safe: the deque is fully
    populated before the response is written, and deque append/popleft
    are atomic."""

    __slots__ = ("_d",)

    def __init__(self):
        self._d: collections.deque = collections.deque()

    def put(self, item, timeout=None) -> None:
        self._d.append(item)

    def get(self, timeout=None):
        return self.get_nowait()

    def get_nowait(self):
        try:
            return self._d.popleft()
        except IndexError:
            raise queue.Empty from None

    def empty(self) -> bool:
        """``queue.Queue.empty``: the drain of :meth:`PrestoTpuServer
        .begin_shutdown` asks every query's channel, inline ones too."""
        return not self._d


class _Query:
    """One running statement: executes on the producer pool, pages
    buffered."""

    def __init__(self, qid: str, slug: str, sql: str, runner,
                 session_overrides: Dict[str, str],
                 admission=None, user: str = "",
                 accepts_serving: Optional[bool] = None,
                 inline: bool = False):
        self.user = user
        self.id = qid
        self.slug = slug
        self.sql = sql
        self._admission = admission
        # serving-plane handoff (group memory account + scheduler
        # share) rides runner.execute(serving=...) when the runner
        # supports it; protocol doubles in tests may not. The server
        # probes its runner ONCE (an invariant — not per statement).
        self._accepts_serving = (_runner_accepts_serving(runner)
                                 if accepts_serving is None
                                 else accepts_serving)
        self.state = "QUEUED"
        self.error: Optional[Dict] = None
        self.columns: Optional[List[Dict]] = None
        self.set_session: Dict[str, str] = {}
        self.clear_session: List[str] = []
        self._inline = bool(inline and (admission is None
                                        or admission.granted))
        # inline lane: the producer IS the consumer's thread, so a
        # bounded put could deadlock — unbounded there (rows are
        # already materialized; the buffered copy is the same order of
        # memory the async path would build). Bounded (backpressure on
        # slow pagers) on the pool path.
        self._pages = (_InlinePages() if self._inline
                       else queue.Queue(maxsize=8))
        self._next_token = 0
        self._last_page: Optional[Tuple[int, Optional[List]]] = None
        self._page_lock = checked_lock("protocol.query.pages")
        # guards state transitions: cancel() and the producer thread race,
        # and FAILED must never become FINISHED (the reference's
        # QueryStateMachine rejects transitions out of terminal states)
        self._state_lock = checked_lock("protocol.query.state")
        self._cancelled = threading.Event()
        #: set when the producer finished (every exit path) — the
        #: pool-era replacement for joining the per-query thread
        self.done = threading.Event()
        self._runner = runner
        self._overrides = session_overrides
        if self._inline:
            # inline lane: a statement the server has seen complete
            # within the fast-path grace runs in the CALLING (http
            # handler) thread when its group admits without queueing.
            # Under keep-alive the handler thread is connection-bound
            # either way, so this spends no extra thread — it erases
            # the submit->producer and page->poller wakeups, which on
            # a saturated host are two forced context switches per
            # statement.
            from ..obs.metrics import REGISTRY
            REGISTRY.counter("serving_inline_lane_total").inc()
            self._run_fresh()
        else:
            _PRODUCERS.submit(self._run_fresh)

    def _run_fresh(self) -> None:
        """:meth:`_run` in a new, empty context: a pooled worker or a
        keep-alive handler thread serves many statements, and no context
        variable one of them set (a parameter binding scope, a profile
        session, a trace span) may reach the next."""
        contextvars.Context().run(self._run)

    def _queued_timeout_override(self):
        """Per-query ``query_queued_timeout``: the client's session
        override wins, else the server session's default (both validated
        through config.SESSION_PROPERTIES)."""
        override = self._overrides.get("query_queued_timeout")
        if override is None:
            session = getattr(self._runner, "session", None)
            if session is not None:
                override = session.properties.get("query_queued_timeout")
        return override

    # -- producer ------------------------------------------------------------
    def _run(self) -> None:
        from .resource_groups import QueryQueuedTimeoutError
        serving = None
        t_submit = time.monotonic()
        try:
            # admission: block in QUEUED until the resource group grants
            # a run slot (reference dispatcher/DispatchManager.java:134 +
            # resourcegroups/InternalResourceGroup run/queue decision);
            # a deadline (queryQueuedTimeout group config /
            # query_queued_timeout session prop) fails the query with a
            # distinct verdict instead of waiting forever
            if self._admission is not None:
                timeout = self._admission.queued_timeout_s(
                    self._queued_timeout_override())
                deadline = (self._admission.submit_time + timeout
                            if timeout is not None else None)
                while not self._admission.wait(0.1):
                    if self._cancelled.is_set():
                        return
                    if deadline is not None \
                            and time.monotonic() > deadline:
                        self._admission.time_out()
                        raise QueryQueuedTimeoutError(
                            f"query exceeded its queued timeout of "
                            f"{timeout:g}s in resource group "
                            f"{self._admission.group.path!r}")
                from ..serving.groups import serving_context
                serving = serving_context(self._admission)
                # SLO latency-spike injection point (tests/chaos): a
                # sleep rule here adds user-visible serving latency, a
                # fail rule adds availability errors — both flow into
                # the per-group serving_* metrics recorded below
                from ..exec.failpoints import FAILPOINTS
                FAILPOINTS.hit("protocol.serve",
                               key=self._admission.group.path)
            self.state = "RUNNING"
            kwargs = ({"serving": serving}
                      if serving is not None and self._accepts_serving
                      else {})
            res = self._runner.execute(
                self.sql, properties=dict(self._overrides),
                user=self.user, cancel_event=self._cancelled, **kwargs)
            # the slot frees as soon as execution completes: paging
            # buffered rows out to a (possibly slow) client must not
            # hold the group's concurrency slot (the finally below is
            # the idempotent safety net for every other exit path)
            if serving is not None:
                serving.close()
            if self._admission is not None:
                self._admission.release()
            self.columns = [
                {"name": n, "type": t.display()}
                for n, t in zip(res.names, res.types)
            ]
            sql_head = self.sql.lstrip().lower()
            if sql_head.startswith("set session"):
                stmt = self.sql.lstrip()[len("set session"):].strip()
                if "=" in stmt:
                    k, v = stmt.split("=", 1)
                    self.set_session[k.strip()] = v.strip().strip("'")
            elif sql_head.startswith("reset session"):
                self.clear_session.append(
                    self.sql.lstrip()[len("reset session"):].strip())
            rows = res.rows
            for i in range(0, max(len(rows), 1), ROWS_PER_PAGE):
                if self._cancelled.is_set():
                    break
                page = [[_json_value(v) for v in r]
                        for r in rows[i:i + ROWS_PER_PAGE]]
                self._put_page(page)
            # a cancel that raced completion must keep the FAILED/
            # USER_CANCELED verdict set by cancel() (the reference's
            # QueryStateMachine refuses FAILED->FINISHED transitions)
            with self._state_lock:
                if not self._cancelled.is_set():
                    self.state = "FINISHED"
        except QueryQueuedTimeoutError as e:
            with self._state_lock:
                if not self._cancelled.is_set():
                    self.state = "FAILED"
                    self.error = {
                        "message": str(e),
                        "errorCode": 1,
                        "errorName": "QUERY_QUEUED_TIMEOUT",
                        "errorType": "INSUFFICIENT_RESOURCES",
                    }
        except Exception as e:  # surfaced as QueryError, not a 500
            with self._state_lock:
                if not self._cancelled.is_set():
                    self.state = "FAILED"
                    self.error = {
                        "message": str(e),
                        "errorCode": 1,
                        "errorName": getattr(e, "name",
                                             type(e).__name__),
                        "errorType": "USER_ERROR",
                    }
        finally:
            # admission leak fix: EVERY exit path — planning/execution
            # failure, queued timeout, cancel while queued, even an
            # unexpected paging error — releases the resource-group
            # slot exactly once (release() is idempotent) and refunds
            # residual group memory, so the group's running count
            # always returns to zero
            if serving is not None:
                serving.close()
            if self._admission is not None:
                self._admission.release()
                self._record_serving_slo(t_submit)
            self._put_page(None)      # end-of-stream sentinel
            self.done.set()

    def _record_serving_slo(self, t_submit: float) -> None:
        """Per-group SLO feed (obs/slo.py): end-to-end serving latency
        (queue wait included — that's what the tenant experiences) and
        request/error counts, keyed by the admitting group's path.
        User cancels are excluded: they are neither a latency sample
        nor an availability error the server caused."""
        with self._state_lock:
            state, error = self.state, self.error
        if state not in ("FINISHED", "FAILED"):
            return              # cancelled while queued, never served
        if error is not None and error.get("errorName") == "USER_CANCELED":
            return
        from ..obs.metrics import REGISTRY
        path = self._admission.group.path
        REGISTRY.counter(f"serving_requests_total.{path}").inc()
        if state == "FAILED":
            REGISTRY.counter(f"serving_errors_total.{path}").inc()
        REGISTRY.histogram(f"serving_latency_seconds.{path}").observe(
            time.monotonic() - t_submit)

    def _put_page(self, page) -> None:
        """Bounded put that gives up if the query is cancelled (a cancel
        with no consumer left must not pin the producer thread)."""
        while not self._cancelled.is_set():
            try:
                self._pages.put(page, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer ------------------------------------------------------------
    def poll_page(self, token: int, timeout: float):
        """``next_page`` bounded by ``timeout``: (True, page) when the
        page arrived in time, (False, None) otherwise — the statement
        POST uses it to inline a fast query's results into the first
        response instead of sending the client back for two more round
        trips (a result-cache hit answers in ~a millisecond; the extra
        GETs would triple its served latency)."""
        deadline = time.monotonic() + timeout
        with self._page_lock:
            if self._last_page is not None \
                    and self._last_page[0] == token:
                return True, self._last_page[1]
            if token != self._next_token:
                raise KeyError(f"token {token} is gone")
            while True:
                if self._cancelled.is_set():
                    page = None
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False, None
                try:
                    page = self._pages.get(timeout=min(remaining, 0.1))
                    break
                except queue.Empty:
                    if self._inline:
                        # the inline producer already ran to completion;
                        # an empty channel means no page is ever coming
                        return False, None
                    continue
            self._last_page = (token, page)
            self._next_token = token + 1
            return True, page

    def next_page(self, token: int):
        """Page for ``token``; the last token may be re-requested (the
        reference protocol's restartable token semantics). Serialized:
        a client retry racing its own original request must not consume
        two pages. Exactly :meth:`poll_page` with no deadline — ONE
        implementation owns the token/replay/cancel invariants."""
        return self.poll_page(token, float("inf"))[1]

    def cancel(self) -> None:
        with self._state_lock:
            if self.state in ("FINISHED", "FAILED"):
                # terminal states stay put: clients routinely DELETE the
                # statement URI on close after draining all pages, and a
                # completed query must not re-report as canceled
                return
            self._cancelled.set()
            self.state = "FAILED"
            self.error = {"message": "Query was canceled", "errorCode": 1,
                          "errorName": "USER_CANCELED",
                          "errorType": "USER_ERROR"}
        while True:                   # unblock/starve the producer
            try:
                self._pages.get_nowait()
            except queue.Empty:
                break


#: single-page query console (the role of the reference's React webapp,
#: presto-main/src/main/resources/webapp/index.html query list — one
#: dependency-free page polling /v1/query)
_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>presto-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#16181d;
      color:#e8e8e8}
 h1{font-size:1.2rem} table{border-collapse:collapse;width:100%}
 th,td{text-align:left;padding:.35rem .6rem;border-bottom:1px solid #333;
       font-size:.85rem} th{color:#9aa}
 td.sql{font-family:ui-monospace,monospace;white-space:pre-wrap;
        word-break:break-word;max-width:48rem}
 .FINISHED{color:#6c6}.FAILED{color:#e66}.RUNNING{color:#fd5}
 .muted{color:#789;font-size:.8rem}
</style></head><body>
<h1>presto-tpu &mdash; queries</h1>
<div class="muted" id="meta"></div>
<table><thead><tr><th>id</th><th>state</th><th>elapsed</th><th>query</th>
</tr></thead><tbody id="rows"></tbody></table>
<h1 id="dtitle" style="display:none">detail</h1>
<div id="detail"></div>
<script>
function esc(s){return s.replace(/&/g,'&amp;').replace(/</g,'&lt;');}
async function refresh(){
  const r = await fetch('/v1/query');
  const qs = await r.json();
  document.getElementById('meta').textContent =
    qs.length + ' queries \\u00b7 refreshed ' +
    new Date().toLocaleTimeString();
  document.getElementById('rows').innerHTML = qs.map(q =>
    '<tr><td><a href="#" style="color:#8cf" onclick="show(\\''+q.queryId+
    '\\');return false">'+q.queryId+'</a></td><td class="'+q.state+'">'+
    q.state+'</td><td>'+q.elapsedMs+'ms</td><td class="sql">'+
    esc(q.query)+'</td></tr>').join('');
}
async function show(id){
  // per-node timeline: proportional wall-time bars + split completions
  // (the reference webapp's stage/timeline pages)
  const q = await (await fetch('/v1/query/'+id)).json();
  const mx = Math.max(1, ...q.nodes.map(n=>n.wallMs));
  document.getElementById('dtitle').style.display='block';
  document.getElementById('dtitle').textContent =
    id+' \\u2014 '+q.state+' ('+q.elapsedMs+'ms)';
  document.getElementById('detail').innerHTML =
    '<table><thead><tr><th>operator</th><th>wall</th><th>batches</th>'+
    '<th></th></tr></thead><tbody>'+
    q.nodes.map(n=>'<tr><td>'+esc(n.node)+'</td><td>'+n.wallMs+
      'ms</td><td>'+n.batches+'</td><td><div style="background:#48f;'+
      'height:.6rem;width:'+Math.round(240*n.wallMs/mx)+
      'px"></div></td></tr>').join('')+'</tbody></table>'+
    (q.splits.length ? '<p class="muted">'+q.splits.length+
      ' splits: '+q.splits.map(s=>esc(s.table)+'#'+s.split+' '+
      s.wallMs+'ms').join(' \\u00b7 ')+'</p>' : '');
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


class _FastHeaders:
    """Case-insensitive read-only header mapping — the slice of
    ``email.message.Message`` this server consumes (``.get`` with a
    default). Keys are stored lower-cased by :meth:`_Handler.parse_request`."""

    __slots__ = ("_d",)

    def __init__(self, d: Dict[str, str]):
        self._d = d

    def get(self, name: str, default=None):
        return self._d.get(name.lower(), default)

    def __getitem__(self, name: str) -> str:
        v = self._d.get(name.lower())
        if v is None:
            raise KeyError(name)
        return v

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._d

    def items(self):
        return list(self._d.items())


class _Handler(BaseHTTPRequestHandler):
    server_version = "presto-tpu"
    protocol_version = "HTTP/1.1"
    # result-cache hits answer in ~a millisecond; without TCP_NODELAY
    # the kernel's delayed-ACK/Nagle interaction quantizes every small
    # response at ~40ms — two orders of magnitude over the engine time
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):   # silence request logging
        pass

    def parse_request(self) -> bool:
        """Drop-in for ``BaseHTTPRequestHandler.parse_request`` with
        the header block parsed by a plain line loop instead of the
        email package (``http.client.parse_headers`` routes every
        request through the MIME feedparser — a measurable slice of a
        warm cache-hit statement's handler CPU). Same request-line,
        close/keep-alive, Expect, and limit semantics; headers land in
        a :class:`_FastHeaders` (case-insensitive ``.get``, the only
        surface this server uses)."""
        self.command = None
        self.request_version = version = self.default_request_version
        self.close_connection = True
        requestline = str(self.raw_requestline,
                          "iso-8859-1").rstrip("\r\n")
        self.requestline = requestline
        words = requestline.split()
        if not words:
            return False
        if len(words) >= 3:
            version = words[-1]
            if version == "HTTP/1.1":
                # the only version real clients send here
                self.close_connection = False
            else:
                try:
                    if not version.startswith("HTTP/"):
                        raise ValueError
                    base = version.split("/", 1)[1]
                    nums = base.split(".")
                    if len(nums) != 2:
                        raise ValueError
                    vnum = int(nums[0]), int(nums[1])
                except (ValueError, IndexError):
                    self.send_error(
                        400, "Bad request version (%r)" % version)
                    return False
                if vnum >= (2, 0):
                    self.send_error(
                        505, "Invalid HTTP version (%s)" % base)
                    return False
                if vnum >= (1, 1) \
                        and self.protocol_version >= "HTTP/1.1":
                    self.close_connection = False
            self.request_version = version
        if not 2 <= len(words) <= 3:
            self.send_error(
                400, "Bad request syntax (%r)" % requestline)
            return False
        command, path = words[:2]
        if len(words) == 2:
            self.close_connection = True
            if command != "GET":
                self.send_error(
                    400, "Bad HTTP/0.9 request type (%r)" % command)
                return False
        self.command, self.path = command, path
        if self.path.startswith("//"):
            # gh-87389: collapse leading // (open-redirect hardening,
            # mirrored from the stock parser)
            self.path = "/" + self.path.lstrip("/")
        hdrs: Dict[str, str] = {}
        last: Optional[str] = None
        while True:
            line = self.rfile.readline(65537)
            if len(line) > 65536:
                self.send_error(431, "Line too long")
                return False
            if line in (b"\r\n", b"\n", b""):
                break
            if len(hdrs) >= 100:
                self.send_error(431, "Too many headers")
                return False
            text = line.decode("iso-8859-1").rstrip("\r\n")
            if text[:1] in (" ", "\t") and last is not None:
                # obs-fold continuation line
                hdrs[last] += " " + text.strip()
                continue
            key, sep, value = text.partition(":")
            if not sep:
                continue        # tolerated, like the email parser
            last = key.strip().lower()
            hdrs[last] = value.strip()
        self.headers = _FastHeaders(hdrs)
        conntype = hdrs.get("connection", "").lower()
        if conntype == "close":
            self.close_connection = True
        elif (conntype == "keep-alive"
                and self.protocol_version >= "HTTP/1.1"):
            self.close_connection = False
        expect = hdrs.get("expect", "").lower()
        if (expect == "100-continue"
                and self.protocol_version >= "HTTP/1.1"
                and self.request_version >= "HTTP/1.1"):
            if not self.handle_expect_100():
                return False
        return True

    @property
    def _srv(self) -> "PrestoTpuServer":
        return self.server.presto       # type: ignore[attr-defined]

    #: (whole second, rendered Date header value) — every response
    #: within one second shares the strftime work
    _date_cache: Tuple[int, str] = (0, "")
    _version_cache: str = ""

    def _reply(self, code: int, doc: Dict,
               headers: Optional[Dict[str, str]] = None) -> None:
        # hand-composed response in ONE wfile.write: the wfile of a
        # BaseHTTPRequestHandler is unbuffered, so the stock
        # send_response/.../end_headers + body sequence costs two
        # sendall syscalls (and two TCP segments) per response — on
        # the serving hot path that is measurable against a ~1ms
        # statement
        body = json.dumps(doc).encode()
        now = int(time.time())
        date = _Handler._date_cache
        if date[0] != now:
            date = (now, self.date_time_string(now))
            _Handler._date_cache = date
        if not _Handler._version_cache:
            _Handler._version_cache = self.version_string()
        status = self.responses.get(code, ("", ""))[0]
        head = (f"HTTP/1.1 {code} {status}\r\n"
                f"Server: {_Handler._version_cache}\r\n"
                f"Date: {date[1]}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n")
        for k, v in (headers or {}).items():
            head += f"{k}: {v}\r\n"
        if self.close_connection:
            head += "Connection: close\r\n"
        self.wfile.write(head.encode("latin-1") + b"\r\n" + body)

    def do_POST(self) -> None:
        if self.path == "/v1/announce":
            # node-internal announcement (reference discovery service);
            # not behind client auth, like reference internal comms
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n) or b"{}")
            self._srv.discovery.announce(doc.get("nodeId", ""),
                                         doc.get("uri", ""),
                                         doc.get("state", "ACTIVE"),
                                         doc.get("role", "worker"))
            self._reply(202, {"announced": True})
            return
        if self.path in ("/v1/fleet/bump", "/v1/fleet/heartbeat"):
            # coordinator-to-coordinator plane (serving/fleet.py):
            # write bumps keep peer caches coherent, heartbeats carry
            # federated resource-group counts. Node-internal like
            # /v1/announce — not behind client auth. 404 when this
            # server is not a fleet member.
            fleet = self._srv.fleet
            if fleet is None:
                self._reply(404, {"error": "not a fleet member"})
                return
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n) or b"{}")
            if self.path.endswith("/bump"):
                folded = fleet.fold_bump(doc)
                self._reply(200, {"folded": bool(folded)})
            else:
                fleet.fold_heartbeat(doc)
                self._reply(200, {"ok": True})
            return
        if self.path != "/v1/statement":
            self._reply(404, {"error": "not found"})
            return
        if self._srv.shutting_down:
            # drain window (reference server/GracefulShutdownHandler on
            # the coordinator): running statements page out normally,
            # new ones are refused so a rolling restart never strands a
            # client mid-queue
            self._reply(503, {"error": "coordinator is shutting down"})
            return
        if not self._authenticate():
            return
        n = int(self.headers.get("Content-Length", 0))
        sql = self.rfile.read(n).decode()
        overrides = {}
        for part in (self.headers.get("X-Presto-Session") or "").split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                overrides[k.strip()] = urllib.parse.unquote(v.strip())
        from .resource_groups import QueryQueueFullError
        try:
            q = self._srv.create_query(
                sql, overrides,
                user=getattr(self, "_auth_user", None)
                or self.headers.get("X-Presto-User", ""),
                source=self.headers.get("X-Presto-Source", ""),
                inline=(self._srv._inline_lane
                        and sql in self._srv._fast_sql))
        except QueryQueueFullError as e:
            self._reply(429, {"error": {"message": str(e),
                                        "errorName": "QUERY_QUEUE_FULL",
                                        "errorType": "INSUFFICIENT_RESOURCES"}})
            return
        # single-round-trip fast path: wait briefly for the first page
        # and inline it (plus the end-of-stream sentinel when the query
        # already drained) — a cache-hit statement completes in ~1ms,
        # and serving it in ONE http exchange instead of three is the
        # difference between protocol-bound and engine-bound QPS.
        # Slow/queued queries fall back to the classic paging doc after
        # the grace.
        try:
            ok, page = q.poll_page(0, 0.05)
        except KeyError:
            ok, page = False, None
        if not ok:
            # exceeded the grace: classic paging, and the statement
            # loses its inline-lane seat until it proves fast again
            self._srv.note_fast_statement(sql, False)
            self._reply(200, self._results_doc(q, 0, first=True))
            return
        token = 0
        if page is not None:
            # try to fold in the terminal sentinel (single-page result)
            try:
                ok2, page2 = q.poll_page(1, 0.005)
            except KeyError:
                ok2, page2 = False, None
            if ok2 and page2 is not None:
                page = page + page2
                token = 1
                # don't chase further pages: hand off to normal paging
                self._srv.note_fast_statement(sql, False)
            elif ok2:
                doc = self._results_doc(q, token, page=page)
                doc.pop("nextUri", None)       # stream fully drained
                if q.error is not None:
                    # failed AFTER emitting rows (e.g. mid-paging):
                    # folding the sentinel must not swallow the verdict
                    # the classic GET path would have delivered
                    doc["error"] = q.error
                else:
                    self._srv.note_fast_statement(sql, True)
                self._reply(200, doc, self._session_headers(q))
                return
        if page is None and q.error is None:
            # sentinel on the first poll: a zero-page statement that
            # drained within the grace — inline-lane eligible too
            self._srv.note_fast_statement(sql, True)
        self._reply(200, self._results_doc(q, token, page=page),
                    self._session_headers(q))

    def do_GET(self) -> None:
        if self.path == "/v1/service":
            self._reply(200, {"services": self._srv.discovery.nodes()})
            return
        if self.path.split("?")[0].rstrip("/") == "/v1/info":
            # lifecycle surface, symmetric with the worker's: load
            # balancers / rolling-restart tooling watch the state flip
            # to SHUTTING_DOWN and drain traffic away
            self._reply(200, {
                "nodeId": (self._srv.fleet.node_id
                           if self._srv.fleet is not None
                           else "coordinator"),
                "state": ("SHUTTING_DOWN" if self._srv.shutting_down
                          else "ACTIVE"),
                "queries": {
                    "RUNNING": sum(
                        1 for q in list(self._srv.queries.values())
                        if q.state in ("QUEUED", "RUNNING"))},
            })
            return
        if self.path.rstrip("/") == "/v1/fleet":
            # fleet membership status (node-internal plane, like
            # /v1/service): peers, bump seq, remote group counts + ages
            fleet = self._srv.fleet
            if fleet is None:
                self._reply(404, {"error": "not a fleet member"})
                return
            self._reply(200, fleet.status())
            return
        if self.path.rstrip("/") == "/v1/autoscale":
            # elasticity controller status (node-internal plane, like
            # /v1/slo): policy, worker set, confirmation streaks, and
            # the last control tick's decisions/applied/blocked
            ctl = self._srv.autoscaler
            if ctl is None:
                self._reply(404, {"error": "autoscaler not enabled"})
                return
            self._reply(200, ctl.status())
            return
        if self.path.rstrip("/") == "/v1/slo":
            # the live ``slo`` block; flush a sample first so the
            # timeline includes traffic served since the last tick
            from ..obs.slo import SLO, slo_block
            from ..obs.timeseries import TIMESERIES
            TIMESERIES.sample()
            self._reply(200, slo_block(TIMESERIES, SLO))
            return
        if self.path.split("?")[0].rstrip("/") == "/v1/metrics/history":
            # windowed range reads over the time-series store
            # (obs/timeseries.py) — same unauthenticated node-internal
            # plane as the scrape endpoint below; federated worker
            # series are readable here too
            from ..obs.timeseries import TIMESERIES
            qs = self.path.split("?", 1)[1] if "?" in self.path else ""
            code, doc = TIMESERIES.history_doc(qs)
            self._reply(code, doc)
            return
        if self.path.split("?")[0].rstrip("/") == "/v1/metrics":
            # Prometheus scrape surface (unauthenticated, like
            # /v1/service — node-internal plane): the coordinator's
            # registry plus node-labeled series federated from worker
            # heartbeats (obs/exposition.py)
            from ..obs.exposition import render_exposition
            from ..obs.metrics import NODES, REGISTRY
            body = render_exposition(REGISTRY, nodes=NODES).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if not self._authenticate():
            return
        if self.path.rstrip("/") == "/v1/resourceGroup":
            self._reply(200, {"groups": self._srv.resource_groups.info()})
            return
        if self.path.rstrip("/") == "/v1/query":
            # query list for the UI (reference server/QueryResource.java)
            out = []
            for e in list(self._srv.runner.query_log)[-200:][::-1]:
                out.append({"queryId": e.query_id, "state": e.state,
                            "query": e.query,
                            "elapsedMs": round(e.elapsed_ms, 1)})
            self._reply(200, out)
            return
        if self.path.startswith("/v1/query/"):
            # live per-query detail: per-node wall/batches + split
            # timeline, updated WHILE the query runs (reference
            # server/QueryResource.java + webapp timeline page)
            qid = self.path[len("/v1/query/"):].strip("/")
            entry = next((e for e in self._srv.runner.query_log
                          if e.query_id == qid), None)
            if entry is None:
                self._reply(404, {"error": f"unknown query {qid!r}"})
                return
            stats = self._srv.runner.live_stats.get(qid)
            doc = {"queryId": entry.query_id, "state": entry.state,
                   "query": entry.query,
                   "elapsedMs": round(entry.elapsed_ms, 1),
                   "nodes": stats.snapshot() if stats is not None else [],
                   "splits": list(stats.splits) if stats is not None
                   else []}
            self._reply(200, doc)
            return
        if self.path.rstrip("/") in ("/ui", ""):
            body = _UI_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        m = self._match_executing()
        if m is None:
            self._reply(404, {"error": "not found"})
            return
        q, token = m
        try:
            page = q.next_page(token)
        except KeyError as e:
            self._reply(410, {"error": str(e)})
            return
        self._reply(200, self._results_doc(q, token, page=page),
                    self._session_headers(q))

    def do_PUT(self) -> None:
        # lifecycle changes need the same credentials as statements: an
        # unauthenticated peer must not be able to drain the server
        if not self._authenticate():
            return
        parts = self.path.strip("/").split("/")
        if parts == ["v1", "info", "state"]:
            n = int(self.headers.get("Content-Length", 0))
            state = json.loads(self.rfile.read(n) or b'""')
            if state == "SHUTTING_DOWN":
                self._srv.begin_shutdown()
                self._reply(200, {"state": "SHUTTING_DOWN"})
            else:
                self._reply(400, {"error": f"bad state {state!r}"})
            return
        self._reply(404, {"error": "not found"})

    def do_DELETE(self) -> None:
        if not self._authenticate():
            return
        m = self._match_executing()
        if m is None:
            self._reply(404, {"error": "not found"})
            return
        q, _ = m
        q.cancel()
        self._reply(200, {})

    def _authenticate(self) -> bool:
        """HTTP Basic against the installed password authenticator and
        Bearer (JWT) against the installed token authenticator
        (reference server/security/AuthenticationFilter.java chaining
        multiple authenticators); none installed = open server,
        header-asserted identity."""
        auth = self._srv.authenticator
        jwt = getattr(self._srv, "jwt_authenticator", None)
        if auth is None and jwt is None:
            return True
        import base64
        header = self.headers.get("Authorization", "")
        if jwt is not None and header.startswith("Bearer "):
            principal = jwt.authenticate(header[7:].strip())
            if principal:
                self._auth_user = principal
                return True
        if auth is not None and header.startswith("Basic "):
            try:
                raw = base64.b64decode(header[6:]).decode()
                user, _, password = raw.partition(":")
            except Exception:
                user, password = "", ""
            if auth.authenticate(user, password):
                self._auth_user = user
                return True
        body = json.dumps({"error": "Unauthorized"}).encode()
        self.send_response(401)
        self.send_header("WWW-Authenticate",
                         'Basic realm="presto-tpu"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return False

    def _match_executing(self):
        parts = self.path.strip("/").split("/")
        # v1/statement/executing/{id}/{slug}/{token}
        if len(parts) != 6 or parts[:3] != ["v1", "statement", "executing"]:
            return None
        q = self._srv.queries.get(parts[3])
        if q is None or q.slug != parts[4]:
            return None
        return q, int(parts[5])

    def _session_headers(self, q: _Query) -> Dict[str, str]:
        headers: Dict[str, str] = {}
        for k, v in q.set_session.items():
            headers["X-Presto-Set-Session"] = f"{k}={v}"
        for k in q.clear_session:
            headers["X-Presto-Clear-Session"] = k
        return headers

    def _results_doc(self, q: _Query, token: int, first: bool = False,
                     page=None) -> Dict:
        base = f"http://{self.headers.get('Host', 'localhost')}"
        doc: Dict = {
            "id": q.id,
            "infoUri": f"{base}/ui/query/{q.id}",
            "stats": {"state": q.state},
        }
        if first:
            doc["nextUri"] = (f"{base}/v1/statement/executing/"
                              f"{q.id}/{q.slug}/0")
            return doc
        if q.columns is not None:
            doc["columns"] = q.columns
        if page is not None:
            doc["data"] = page
            doc["nextUri"] = (f"{base}/v1/statement/executing/"
                              f"{q.id}/{q.slug}/{token + 1}")
        elif q.error is not None:
            doc["error"] = q.error
        return doc


class PrestoTpuServer:
    """Embeddable statement server over a LocalRunner. With no runner
    it builds ``LocalRunner()``, which takes the GPU and raises without
    one; pass a runner made with ``device="cpu"`` to serve from the
    CPU."""

    def __init__(self, runner=None, host: str = "127.0.0.1", port: int = 0,
                 resource_groups: Optional[Dict] = None,
                 authenticator=None, jwt_authenticator=None,
                 discovery=None):
        from .resource_groups import ResourceGroupManager
        self.authenticator = authenticator
        self.jwt_authenticator = jwt_authenticator
        if runner is None:
            from ..exec.runner import LocalRunner
            runner = LocalRunner()
        self.runner = runner
        self._accepts_serving = _runner_accepts_serving(runner)
        self.queries: Dict[str, _Query] = {}
        self.shutting_down = False
        self._seq = 0
        self._lock = checked_lock("protocol.server")
        # admission: the default config keeps one query running at a
        # time (the single shared device); pass a rootGroups/selectors
        # dict for real concurrency tiers
        self.resource_groups = ResourceGroupManager(resource_groups)
        from ..exec.discovery import DiscoveryNodeManager
        # a fleet coordinator passes its ClusterRunner's discovery so
        # /v1/announce feeds the SAME membership the scheduler reads
        # (one shared worker pool across the fleet)
        self.discovery = (discovery if discovery is not None
                          else DiscoveryNodeManager())
        #: fleet membership (serving/fleet.FleetMember) — None until
        #: :meth:`enable_fleet`; a standalone coordinator never pays a
        #: fleet branch
        self.fleet = None
        #: elasticity control loop (exec/autoscale.AutoscaleController)
        #: — None unless wired by :func:`config.server_from_etc`
        #: (autoscale.enabled=true) or attached by the embedding
        #: harness; surfaced read-only at GET /v1/autoscale
        self.autoscaler = None
        #: statements whose LAST run drained within the single-round-
        #: trip grace: the inline-lane gate (do_POST). Keyed by raw
        #: statement text; a slow re-run (e.g. after a cache
        #: invalidation) evicts itself, so a statement can only hold a
        #: handler thread for one slow execution before reverting to
        #: the producer pool. Bounded so adversarial unique statements
        #: can't grow it. SERVING_INLINE_LANE=0 disables the lane.
        self._fast_sql: Dict[str, bool] = {}
        self._inline_lane = os.environ.get(
            "SERVING_INLINE_LANE", "1") != "0"
        self._qid_date: Optional[datetime.date] = None
        self._qid_prefix = ""

        class _StatementHTTPServer(ThreadingHTTPServer):
            # a 100-client fleet opening a connection per statement
            # overflows socketserver's default listen backlog of FIVE:
            # dropped SYNs retransmit on the kernel's 1s/3s timers and
            # every affected query's latency quantizes to whole
            # seconds; sized well past any client fleet.
            request_queue_size = 1024

            # live client sockets, tracked so kill() can reset them:
            # shutting the listener only stops NEW connections — a
            # "dead" in-process coordinator would otherwise keep
            # serving its established keep-alives forever, and a chaos
            # kill would never exercise client failover
            def get_request(self):
                sock, addr = super().get_request()
                with self._socks_lock:
                    self._client_socks.add(sock)
                return sock, addr

            def shutdown_request(self, request):
                with self._socks_lock:
                    self._client_socks.discard(request)
                super().shutdown_request(request)

            def close_client_connections(self):
                import socket as _socket
                with self._socks_lock:
                    socks = list(self._client_socks)
                    self._client_socks.clear()
                for s in socks:
                    try:
                        s.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass

        self.httpd = _StatementHTTPServer((host, port), _Handler)
        self.httpd._client_socks = set()  # type: ignore[attr-defined]
        self.httpd._socks_lock = threading.Lock()  # type: ignore[attr-defined]
        self.httpd.presto = self      # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def create_query(self, sql: str, overrides: Dict[str, str],
                     user: str = "", source: str = "",
                     inline: bool = False) -> _Query:
        today = datetime.date.today()
        with self._lock:
            self._seq += 1
            if self._qid_date != today:
                # strftime costs ~8µs; at serving rates that's real
                # money for a string that changes once a day
                self._qid_date = today
                self._qid_prefix = today.strftime("%Y%m%d")
            qid = f"{self._qid_prefix}_{self._seq:06d}"
        admission = self.resource_groups.submit(user=user, source=source)
        try:
            q = _Query(qid, secrets.token_hex(8), sql, self.runner,
                       overrides, admission, user=user,
                       accepts_serving=self._accepts_serving,
                       inline=inline)
        except BaseException:
            # a construction failure must not strand the queue slot
            admission.release()
            raise
        with self._lock:
            self.queries[qid] = q
            if len(self.queries) > 200:   # evict oldest drained queries
                for old_id in list(self.queries):
                    old = self.queries[old_id]
                    if old is not q and old.state in ("FINISHED", "FAILED"):
                        del self.queries[old_id]
                    if len(self.queries) <= 100:
                        break
        return q

    def note_fast_statement(self, sql: str, fast: bool) -> None:
        """Inline-lane memo maintenance, called from the statement POST
        at reply time: a single-round-trip drain earns the statement an
        inline seat; a slow or multi-page run revokes it."""
        with self._lock:
            if not fast:
                self._fast_sql.pop(sql, None)
                return
            if sql not in self._fast_sql and len(self._fast_sql) >= 512:
                self._fast_sql.pop(next(iter(self._fast_sql)))
            self._fast_sql[sql] = True

    def enable_fleet(self, node_id: str, peers=(),
                     advertised_host: str = "127.0.0.1",
                     heartbeat_s: float = 1.0,
                     staleness_grace_s: Optional[float] = None):
        """Join a coordinator fleet (serving/fleet.py): coherent caches
        via write-bump broadcast, fleet-wide resource-group limits via
        heartbeat federation. ``peers`` is the other coordinators'
        base URLs; call :meth:`start` (or have a bound port) first so
        the advertised self URL is real. Idempotent per server."""
        if self.fleet is not None:
            return self.fleet
        from ..serving.fleet import FleetMember
        catalogs = getattr(
            getattr(self.runner, "session", None), "catalogs", None)
        self.fleet = FleetMember(
            node_id, f"http://{advertised_host}:{self.port}",
            catalogs=catalogs,
            resource_groups=self.resource_groups,
            discovery=self.discovery, peers=peers,
            heartbeat_s=heartbeat_s,
            staleness_grace_s=staleness_grace_s)
        self.fleet.start()
        return self.fleet

    def start(self) -> None:
        # the health plane rides server lifetime: one process-wide
        # sampler feeds the time-series store, the SLO tracker
        # evaluates after every tick (both idempotent — a process
        # running several servers shares one plane)
        from ..obs.slo import SLO
        from ..obs.timeseries import TIMESERIES
        SLO.install()
        TIMESERIES.ensure_started()
        self._thread.start()

    def begin_shutdown(self) -> None:
        """Drain: refuse new statements (503), let running queries page
        out, then stop the server (the coordinator half of the worker's
        GracefulShutdownHandler-style drain)."""
        self.shutting_down = True
        if self.fleet is not None:
            # clean drain: tell peers to drop our federated counts NOW
            # (a drain is not a loss — no staleness grace, no
            # coordinator_lost_total)
            self.fleet.leave()

        def drain():
            # terminal state is set when the last page is ENQUEUED, not
            # when the client fetched it: wait for page queues to empty
            # too, under a grace window so an abandoned client cannot
            # pin the drain forever
            grace_until = None
            while True:
                qs = list(self.queries.values())
                if any(q.state in ("QUEUED", "RUNNING") for q in qs):
                    grace_until = None
                elif not any(not q._pages.empty() for q in qs):
                    break
                else:
                    now = time.monotonic()
                    if grace_until is None:
                        grace_until = now + 30.0
                    elif now > grace_until:
                        break
                time.sleep(0.2)
            self.stop()
        threading.Thread(target=drain, daemon=True).start()

    def stop(self) -> None:
        # shutdown() handshakes with serve_forever — calling it on a
        # server whose loop never started (embedded create_query use)
        # would block forever
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.fleet is not None:
            self.fleet.stop()
        if self._thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()

    def kill(self) -> None:
        """Process-death stand-in for in-process chaos tests: stop
        accepting, RESET every established client connection (a real
        SIGKILL'd process drops its sockets — in-flight requests see a
        transport error, exercising client failover), and silence the
        fleet heartbeat so peers declare this coordinator lost via the
        staleness grace. No drain, no ``leaving`` farewell."""
        if self.fleet is not None:
            self.fleet.stop()
        self.shutting_down = True
        if self._thread.is_alive():
            self.httpd.shutdown()
        self.httpd.close_client_connections()  # type: ignore[attr-defined]
        self.httpd.server_close()


#: the protocol-facing name (reference dispatcher/QueuedStatementResource
#: serves POST /v1/statement); PrestoTpuServer remains the historical alias
StatementServer = PrestoTpuServer
