"""One query's device profile as one JSON document.

The counterpart of the JAX package's ``tools/profile_query.py``: runs a
query (by name: q1, q3, q55, q27, the port's own copies of the bench
SQL, at ``--sf``; or any ``--sql``) under the profiler
(``obs/profiler.py``: every operator's iterator frames timed on the
device's clock, exclusive of its children's, and every hand-kernel
launch bracketed and charged to the operator that made it), and emits
the per-operator table (wall, self, rows, batches, device seconds,
kernel seconds, bound-formula bytes, join strategy), the hand kernels
ranked by device seconds with their launches, and the cost verdict.
With ``--mesh N`` the query runs on an N-slot mesh and the document
gains the fragmenter's stage recipe and the flight recorder's
attribution. Eager PyTorch compiles no programs, so the hand kernels
are the whole of the ranked list.

Usage::

    python -m presto_tpu_torch._devtools.profile_query --query q3 --sf 1
    PRESTO_TPU_TORCH_MESH_SLOTS=4 python -m \\
        presto_tpu_torch._devtools.profile_query --query q3 --sf 0.01 \\
        --device cpu --mesh 4
    python -m presto_tpu_torch._devtools.profile_query \\
        --catalog tpch --sql "select ..." --out prof.json

The timed run is the second execution (the first pays the scan's
generation and copy to the device), unless ``--cold`` keeps the first.
The document names the torch device and, on ``cuda``, the card's name
and power limit. It runs on ``cuda`` unless ``--device cpu``; with no
GPU and no device named it raises. Exit 0 with the JSON on stdout (and
in ``--out``, written through a temporary file and a rename).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

#: TPC-H Q3 through the SQL path
TPCH_Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10
"""

#: the bench harness's TPC-H Q1 text
TPCH_Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

#: the bench harness's TPC-DS q55 text
DS_Q55 = """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 28 and d_moy = 11 and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, i_brand_id
limit 100
"""

#: the bench harness's TPC-DS q27 text
DS_Q27 = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College' and d_year = 2002
  and s_state in ('TN', 'TN', 'TN', 'TN', 'TN', 'TN')
group by rollup (i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100
"""

#: named queries -> (catalog, SQL)
NAMED = {
    "q1": ("tpch", TPCH_Q1),
    "q3": ("tpch", TPCH_Q3),
    "q55": ("tpcds", DS_Q55),
    "q27": ("tpcds", DS_Q27),
}


def _node_rows(plan, stats) -> List[Dict]:
    """The per-operator table in plan order (root first)."""
    from ..planner.printer import _label
    rows: List[Dict] = []

    def walk(n, depth):
        st = stats.stats_for(n)
        dev = stats.device_for(n)
        js = stats.join_strategy_for(n)
        row = {"depth": depth, "operator": _label(n)}
        if st is not None:
            child_wall = sum(
                (stats.stats_for(c).wall_s
                 if stats.stats_for(c) is not None else 0.0)
                for c in n.children)
            row.update({
                "wall_s": round(st.wall_s, 6),
                "self_s": round(max(st.wall_s - child_wall, 0.0), 6),
                "rows": st.rows, "batches": st.batches,
            })
        if dev is not None:
            row.update({
                "device_time_s": round(dev["device_time_s"], 6),
                "kernel_s": round(dev["kernel_s"], 6),
                "bytes": dev["bytes"],
            })
        if js is not None:
            row["join_strategy"] = f"{js[0]}/{js[1]}"
        rows.append(row)
        for c in n.children:
            walk(c, depth + 1)

    walk(plan.root, 0)
    return rows


def _json_rows(rows) -> List[List]:
    from ..server.protocol import _json_value
    return [[_json_value(v) for v in r] for r in rows]


def device_doc(device) -> Dict:
    """The torch device the profile ran on; on ``cuda`` also the card's
    name and power limit as ``nvidia-smi`` reports them (None where it
    cannot be read)."""
    import torch
    device = torch.device(device)
    doc: Dict = {"type": device.type, "name": None, "power_limit": None}
    if device.type != "cuda":
        return doc
    doc["name"] = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        line = out.stdout.strip().splitlines()[device.index or 0]
        doc["power_limit"] = line.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return doc


def profile_query(runner, sql: str, warm_runs: int = 1,
                  mesh: Optional[int] = None, rows: bool = False) -> Dict:
    """One profiled execution of ``sql`` on ``runner``'s device, after
    ``warm_runs`` untimed runs, as the JSON document. ``mesh`` (slot
    count, 0 = every visible slot) runs the query on the mesh path: per
    operator device time then also divides per slot, and the document
    gains the fragmenter's stage recipe, whether the router chose the
    mesh, and the flight recorder's attribution. ``rows`` adds the
    query's result rows (as the statement protocol encodes them)."""
    from ..exec.local import execute_plan
    from ..exec.stats import StatsCollector
    from ..obs.metrics import REGISTRY
    from ..obs.profiler import cost_verdict

    n_mesh = None
    session = runner.session
    if mesh is not None:
        from ..exec.distributed import mesh_device_count
        # a per-call overlay, never the shared session: a later profile
        # on the same runner must not inherit this call's mesh routing
        session = dataclasses.replace(
            session,
            properties={**session.properties,
                        "mesh_execution": "auto",
                        "mesh_devices": int(mesh)})
        n_mesh = mesh_device_count(session, runner.device)

    def selected() -> float:
        return REGISTRY.counter("mesh_path_selected_total").value

    plan = runner.plan(sql)
    for _ in range(max(warm_runs, 0)):
        execute_plan(plan, session, runner.device, runner.rows_per_batch,
                     collect_rows=False)
    sel0 = selected()
    stats = StatsCollector(count_rows=True)
    t0 = time.perf_counter()
    result = execute_plan(plan, session, runner.device,
                          runner.rows_per_batch, stats=stats,
                          collect_rows=rows)
    stats.total_wall_s = time.perf_counter() - t0
    operators = _node_rows(plan, stats)
    doc: Dict = {
        "sql": " ".join(sql.split()),
        "wall_s": round(stats.total_wall_s, 6),
        "device": device_doc(runner.device),
        "operators": operators,
        "kernels": [
            {"name": e["name"], "source": e["source"],
             "launches": e["invocations"],
             "device_time_s": e["device_time_s"],
             "build_seconds": e["build_seconds"],
             "bytes_per_call": e["bytes_per_call"]}
            for e in stats.executables_used()],
        "cost_verdict": cost_verdict(stats),
    }
    if rows:
        doc["rows"] = _json_rows(result.rows)
    if mesh is not None:
        on_mesh = selected() > sel0
        if on_mesh and n_mesh:
            for row in operators:
                if "device_time_s" in row:
                    row["device_time_per_shard_s"] = round(
                        row["device_time_s"] / n_mesh, 6)
        from ..planner.fragmenter import plan_mesh_stages
        mp = plan_mesh_stages(plan.root)
        doc["mesh"] = {
            "n_devices": n_mesh,
            "selected": on_mesh,
            "supported": mp.supported,
            "stages": [{"id": s.id, "kind": s.kind,
                        "exchange": s.exchange, "keys": list(s.keys),
                        "ops": list(s.ops), "fused": s.fused}
                       for s in mp.stages],
        }
        fl = stats.mesh_flight
        if fl is not None and fl.attribution is not None:
            doc["mesh"]["attribution"] = fl.attribution
    return doc


def make_runner(catalog: str, sf: float, rows_per_batch: int, device):
    """A runner over one generated catalog at ``sf`` on ``device`` (the
    GPU when None; raises without one)."""
    from ..connectors.spi import CatalogManager
    from ..exec.runner import LocalRunner
    catalogs = CatalogManager()
    if catalog == "tpcds":
        from ..connectors.tpcds import TpcdsConnector
        catalogs.register("tpcds", TpcdsConnector(sf=sf))
    else:
        from ..connectors.tpch import TpchConnector
        catalogs.register("tpch", TpchConnector(sf=sf))
    return LocalRunner(catalogs=catalogs, catalog=catalog,
                       rows_per_batch=rows_per_batch, device=device)


def write_atomically(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text + "\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="profile one query; emit per-operator device time, "
                    "the kernels and the cost verdict as JSON")
    ap.add_argument("--query", choices=sorted(NAMED),
                    help="named query (the bench SQL texts)")
    ap.add_argument("--sql", help="any SQL instead of --query")
    ap.add_argument("--catalog", default=None,
                    help="catalog for --sql (default from --query, "
                         "else tpch)")
    ap.add_argument("--sf", type=float, default=1.0,
                    help="scale factor (default 1)")
    ap.add_argument("--rows-per-batch", type=int, default=1 << 20)
    ap.add_argument("--cold", action="store_true",
                    help="profile the FIRST run (generation and copy to "
                         "the device included)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="profile on an N-slot mesh (0 = every visible "
                         "slot); the document gains the stage recipe "
                         "and the flight recorder's attribution. Needs "
                         "N visible slots: PRESTO_TPU_TORCH_MESH_SLOTS=K "
                         "makes every device K slots")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must "
                         "exist; 'cpu' for the CPU)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON here (temp + rename)")
    args = ap.parse_args(argv)

    if bool(args.query) == bool(args.sql):
        print(json.dumps({"error": "exactly one of --query/--sql"}))
        return 2
    if args.query:
        catalog, sql = NAMED[args.query]
    else:
        catalog, sql = args.catalog or "tpch", args.sql
    runner = make_runner(catalog, args.sf, args.rows_per_batch,
                         args.device)
    doc = profile_query(runner, sql, warm_runs=0 if args.cold else 1,
                        mesh=args.mesh)
    doc["sf"] = args.sf
    text = json.dumps(doc, indent=2, default=str)
    print(text)
    if args.out:
        write_atomically(args.out, text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
