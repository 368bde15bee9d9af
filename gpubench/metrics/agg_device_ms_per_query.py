"""Device time of the CUDA records whose innermost operator span on the
launching thread, at the launch, was ``op:Aggregation``, per statement
completed in the traced slice. Needs the launch records
(``harness/attribution.py``)."""
from gpubench.harness.attribution import done_in_slice, launch_slice


def read(ctx):
    sl = launch_slice(ctx)
    if sl is None:
        return None
    ns = sum(r[3] - r[2] for r, s in zip(sl.records, sl.charged("op:"))
             if s is not None and s["name"] == "op:Aggregation")
    done = done_in_slice(ctx)
    return ns / 1e6 / len(done) if done else None
