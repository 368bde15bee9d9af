"""Share of split lookups that the device scan cache served over the
window (``scan_cache_hit_total`` against ``scan_cache_miss_total``)."""


def read(ctx):
    hits = ctx.counters["scan_cache_hits"]
    total = hits + ctx.counters["scan_cache_misses"]
    return 100.0 * hits / total if total else None
