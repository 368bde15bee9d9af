"""How far the fair scheduler's bill strays from the device time: over
the ``quantum`` spans inside the traced slice, 100 x the sum of |seconds
billed - device seconds| over the sum of device seconds. A quantum's
device seconds are those of the CUDA records launched during it by any
span of its query. Needs the launch records
(``harness/attribution.py``)."""
import bisect

from gpubench.harness.attribution import launch_slice


def read(ctx):
    sl = launch_slice(ctx)
    if sl is None:
        return None
    lo, hi = sl.bounds_ns()
    quanta = {}
    for s in sl.spans:
        if s["name"] == "quantum" and "billed_s" in s["attrs"] \
                and lo <= s["startNs"] and s["endNs"] <= hi:
            quanta.setdefault(s["queryId"], []).append(s)
    starts = {}
    for qid, qs in quanta.items():
        qs.sort(key=lambda s: s["startNs"])
        starts[qid] = [q["startNs"] for q in qs]
    device = {}
    for r, s, t in zip(sl.records, sl.charged(), sl.launch_instants()):
        qs = quanta.get(s["queryId"]) if s is not None else None
        if not qs:
            continue
        k = bisect.bisect_right(starts[s["queryId"]], t) - 1
        if k >= 0 and t <= qs[k]["endNs"]:
            device[qs[k]["spanId"]] = \
                device.get(qs[k]["spanId"], 0) + r[3] - r[2]
    total = sum(device.values())
    if total <= 0:
        return None
    gap = sum(abs(q["attrs"]["billed_s"] - device.get(q["spanId"], 0) / 1e9)
              for qs in quanta.values() for q in qs)
    return 100.0 * gap / (total / 1e9)
