"""Interactive SQL shell over the statement protocol.

The counterpart of ``presto_tpu/cli.py``: a terminal client in the
spirit of the reference CLI (presto-cli/.../Console.java and
AlignedTablePrinter). It reads ``;``-terminated statements, runs them
over the HTTP protocol and prints aligned tables (or CSV, TSV, JSON).
``--execute`` runs the given statements and exits. Without ``--server``
it runs an in-process server over a ``LocalRunner`` on ``--device``
(the GPU when none is named; without one the CLI raises).

Usage:
    python -m presto_tpu_torch.cli [--server http://host:port]
                                   [--catalog tpch] [--schema default]
                                   [--execute SQL] [--sf 0.01]
                                   [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

from .client import QueryFailed, StatementClient


def format_aligned(columns, rows) -> str:
    headers = [c[0] for c in columns]
    cells = [["NULL" if v is None else str(v) for v in r] for r in rows]
    widths = [len(h) for h in headers]
    for r in cells:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    numeric = [t in ("bigint", "integer", "double", "real", "smallint",
                     "tinyint") or t.startswith("decimal")
               for _, t in columns]

    def fmt_row(vals):
        out = []
        for v, w, num in zip(vals, widths, numeric):
            out.append(v.rjust(w) if num else v.ljust(w))
        return " | ".join(out)

    lines = [fmt_row(headers),
             "-+-".join("-" * w for w in widths)]
    lines += [fmt_row(r) for r in cells]
    return "\n".join(lines)


def format_separated(columns, rows, sep: str, header: bool) -> str:
    """CSV/TSV output (reference presto-cli OutputFormat CSV/TSV[_HEADER]):
    CSV quotes every field, TSV escapes separators."""
    def cell(v) -> str:
        if v is None:
            return ""
        s = str(v)
        if sep == ",":
            return '"' + s.replace('"', '""') + '"'
        return (s.replace("\\", "\\\\").replace("\t", "\\t")
                .replace("\n", "\\n"))

    lines = []
    if header:
        lines.append(sep.join(cell(c[0]) for c in columns))
    lines += [sep.join(cell(v) for v in r) for r in rows]
    return "\n".join(lines)


def format_json(columns, rows) -> str:
    import json
    names = [c[0] for c in columns]
    return "\n".join(
        json.dumps(dict(zip(names, r)), default=str) for r in rows)


def format_rows(columns, rows, output_format: str) -> str:
    f = output_format.upper()
    if f == "ALIGNED":
        return format_aligned(columns, rows)
    if f in ("CSV", "CSV_HEADER"):
        return format_separated(columns, rows, ",", f.endswith("HEADER"))
    if f in ("TSV", "TSV_HEADER"):
        return format_separated(columns, rows, "\t", f.endswith("HEADER"))
    if f == "JSON":
        return format_json(columns, rows)
    raise ValueError(f"unknown output format {output_format!r}")


def run_statement(client: StatementClient, sql: str,
                  out=None, output_format: str = "ALIGNED") -> None:
    out = out if out is not None else sys.stdout
    try:
        res = client.execute(sql)
    except QueryFailed as e:
        print(f"Query failed: {e}", file=sys.stderr)
        return
    if res.columns:
        print(format_rows(res.columns, res.rows, output_format), file=out)
    if output_format.upper() == "ALIGNED":
        print(f"({len(res.rows)} row{'s' if len(res.rows) != 1 else ''})",
              file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu")
    ap.add_argument("--server", default=None,
                    help="server URL; omitted = embedded in-process server")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="default")
    ap.add_argument("--user", default="presto")
    ap.add_argument("--execute", "-e", default=None,
                    help="run this statement and exit")
    ap.add_argument("--output-format", default="ALIGNED",
                    choices=["ALIGNED", "CSV", "CSV_HEADER", "TSV",
                             "TSV_HEADER", "JSON"],
                    help="result rendering (reference presto-cli "
                         "OutputFormat)")
    ap.add_argument("--password", default=None,
                    help="password for HTTP basic authentication")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="tpch scale factor for the embedded server")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome-trace "
                         "(chrome://tracing / Perfetto) JSON file on "
                         "exit; in-process spans only — point a remote "
                         "worker at the same trace with "
                         "PRESTO_TPU_TORCH_TRACE=1")
    ap.add_argument("--profile-out", default=None, metavar="DIR",
                    help="deep-profile mode: enable span tracing AND "
                         "the `profile` session property (device-time "
                         "attribution), capture a torch.profiler trace "
                         "(CPU and CUDA activities) of the executed "
                         "statements, and write DIR/merged_trace.json "
                         "with host spans and the CUDA kernels on one "
                         "Perfetto timeline; "
                         "embedded server only — with --server the "
                         "device runs in the server process")
    ap.add_argument("--history-out", default=None, metavar="PATH",
                    help="append one JSON line per completed query "
                         "(the system.runtime.completed_queries "
                         "record) to this file; embedded server only — "
                         "with --server, configure HISTORY in the "
                         "server process")
    ap.add_argument("--history-max-bytes", type=int, default=None,
                    metavar="N",
                    help="rotate the --history-out file past N bytes "
                         "(one .1 generation kept; default 64 MiB, "
                         "0 = unbounded). Dropped records count in "
                         "history_records_dropped_total")
    ap.add_argument("--slow-query-log", type=float, default=None,
                    metavar="SECONDS",
                    help="emit the full history record of queries "
                         "slower than this through the structured "
                         "JSON-lines logger (stderr unless "
                         "PRESTO_TPU_TORCH_LOG points elsewhere); "
                         "embedded server only, like --history-out")
    ap.add_argument("--device", default=None,
                    help="torch device of the embedded server's runner "
                         "(cuda, cpu, ...); omitted = the GPU, and the "
                         "CLI raises without one")
    args = ap.parse_args(argv)
    device = None
    if args.server is None:
        from .device import resolve_device
        device = resolve_device(args.device)

    if args.trace_out or args.profile_out:
        from .obs.trace import TRACER
        TRACER.enable(True)
    if args.history_out or args.slow_query_log is not None:
        from .obs.history import HISTORY
        HISTORY.configure(sink_path=args.history_out,
                          slow_threshold_s=args.slow_query_log,
                          max_sink_bytes=args.history_max_bytes)
        if args.slow_query_log is not None:
            from .obs.log import LOG
            if not LOG.enabled:
                LOG.configure(stream=sys.stderr)
    prof = None
    if args.profile_out:
        import os
        os.makedirs(args.profile_out, exist_ok=True)
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if device is not None and device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:   # profile capture must not block queries
            prof = None
            print(f"device profiler unavailable: {e}", file=sys.stderr)

    embedded = None
    url = args.server
    if url is None:
        from .exec.runner import LocalRunner
        from .server import PrestoTpuServer
        embedded = PrestoTpuServer(LocalRunner(tpch_sf=args.sf,
                                               device=device))
        embedded.start()
        url = f"http://127.0.0.1:{embedded.port}"
        print(f"embedded server at {url}", file=sys.stderr)

    client = StatementClient(url, user=args.user, catalog=args.catalog,
                             schema=args.schema, password=args.password)
    try:
        if args.profile_out:
            # device-time attribution for everything this session runs
            # (per-operator frames and per-kernel launches)
            client.execute("SET SESSION profile = true")
        if args.execute is not None:
            for stmt in args.execute.split(";"):
                if stmt.strip():
                    run_statement(client, stmt,
                                  output_format=args.output_format)
            return 0
        buf = ""
        while True:
            try:
                prompt = "presto-tpu> " if not buf else "        ...> "
                line = input(prompt)
            except EOFError:
                break
            buf += ("\n" if buf else "") + line
            while ";" in buf:
                stmt, buf = buf.split(";", 1)
                if stmt.strip():
                    if stmt.strip().lower() in ("quit", "exit"):
                        return 0
                    run_statement(client, stmt,
                                  output_format=args.output_format)
        return 0
    finally:
        if prof is not None:
            import os

            from .obs.profiler import device_trace_path, write_merged_trace
            from .obs.trace import TRACER
            try:
                prof.stop()
                prof.export_chrome_trace(device_trace_path(args.profile_out))
            except Exception as e:   # must not mask the query outcome
                print(f"device trace export failed: {e}", file=sys.stderr)
            merged = os.path.join(args.profile_out, "merged_trace.json")
            try:
                write_merged_trace(merged, TRACER.export(),
                                   args.profile_out)
                print(f"wrote merged host+device trace to {merged} "
                      "(open in ui.perfetto.dev)", file=sys.stderr)
            except Exception as e:   # must not mask the query outcome
                print(f"merged-trace write failed: {e}",
                      file=sys.stderr)
        if args.trace_out:
            from .obs.trace import TRACER, write_chrome_trace
            write_chrome_trace(args.trace_out, TRACER.export())
            print(f"wrote trace to {args.trace_out} "
                  "(open in chrome://tracing or ui.perfetto.dev)",
                  file=sys.stderr)
        if embedded is not None:
            embedded.stop()


if __name__ == "__main__":
    sys.exit(main())
