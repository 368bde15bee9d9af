"""The span tracer's clock and thread ids against the CUDA runtime's
launch records in ``torch.profiler``, profiling CUDA activity alone as
the benchmark's traced slice does (needs an NVIDIA GPU): a kernel
launched inside a span has its launch record inside the span's interval
on ``obs/trace.clock_ns`` and names the span's thread, so the
benchmark's attribution (``gpubench/harness/attribution.py``) charges
the kernel to that span."""
import threading

import pytest
import torch

from gpubench.harness import attribution
from presto_tpu_torch.obs.trace import Tracer


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: launch records exist only on a GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_records_fall_in_the_span_that_launched_them(gpu):
    x = torch.ones(1 << 20, device=gpu)
    torch.cuda.synchronize()
    t = Tracer(node="clock")
    t.enable(True)

    def launch(name):
        with t.span(name):
            (x * 2).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        launch("main")
        th = threading.Thread(target=launch, args=("other",))
        th.start()
        th.join()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    records = [(e.name(), e.device_resource_id(), e.start_ns(),
                e.start_ns() + e.duration_ns(), e.correlation_id())
               for e in events if e.device_type() == cuda]
    ids, launches = attribution.link(events, cuda, 0, 1 << 62)
    assert ids == [r[4] for r in records] and len(records) >= 4
    # one launch record a CUDA record: the first launch's module loading
    # shares its correlation id and is left out
    assert sorted(c for *_, c in launches) == sorted(ids)
    spans = t.export()
    for thread, at, _ in launches:
        (mine,) = [s for s in spans if s["thread"] == thread]
        assert mine["startNs"] <= at <= mine["endNs"]
    got = attribution.attribute(records, launches, spans)
    assert None not in got
    assert {s["name"] for s in got} == {"main", "other"}
