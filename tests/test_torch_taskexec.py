"""The fair device scheduler of presto_tpu_torch (exec/taskexec.py): the
tests of tests/test_taskexec.py against the port's scheduler and runner,
the same level and stride accounting as presto_tpu's scheduler on the
same billed quanta, per-slot billing of a mesh query, and the
``fair_scheduling`` session property."""
import threading
import time

import pytest

from presto_tpu.exec import taskexec as jtx
from presto_tpu_torch.exec import taskexec as tx
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.taskexec import DeviceScheduler, LEVEL_THRESHOLDS
from presto_tpu_torch.obs.metrics import REGISTRY


def test_levels_by_cumulative_time():
    s = DeviceScheduler()
    h = s.task("t")
    assert h.level == 0
    h.device_seconds = 2.0
    assert h.level == 1
    h.device_seconds = 400.0
    assert h.level == len(LEVEL_THRESHOLDS) - 1
    assert LEVEL_THRESHOLDS == jtx.LEVEL_THRESHOLDS


@pytest.mark.parametrize("secs", [0.0, 0.5, 1.0, 9.99, 10.0, 59.0, 61.0,
                                  300.0, 1e4])
def test_levels_equal_reference(secs):
    h, jh = DeviceScheduler().task("a"), jtx.DeviceScheduler().task("a")
    h.device_seconds = jh.device_seconds = secs
    assert h.level == jh.level


def test_stride_accounting_equals_reference(monkeypatch):
    """The same quanta (fixed billed walls) leave the same per-group
    virtual times, device seconds and quanta in both schedulers."""
    walls = iter([0.25, 0.5, 0.125, 1.0, 0.75, 0.25] * 2)
    fake = {"t": 0.0}

    def clock():
        return fake["t"]

    def run(mod):
        s = mod.DeviceScheduler()
        a = s.task("a", group="g1", weight=1)
        b = s.task("b", group="g2", weight=2, devices=4)
        for h in (a, b, a, b, b, a):
            dt = next(walls)

            def fn(dt=dt):
                fake["t"] += dt
            s.run_quantum(h, fn)
        return s.group_shares(), (a.device_seconds, b.device_seconds)

    monkeypatch.setattr(tx.time, "perf_counter", clock)
    got = run(tx)
    monkeypatch.setattr(jtx.time, "perf_counter", clock)
    want = run(jtx)
    assert got == want
    assert got[0]["g2"]["quanta"] == 3


def test_low_usage_task_preempts_between_quanta():
    """A fresh task is granted the device ahead of a task that has
    accumulated more device time, at every quantum boundary."""
    s = DeviceScheduler()
    heavy = s.task("heavy")
    light = s.task("light")
    order = []
    stop = threading.Event()

    def heavy_loop():
        while not stop.is_set():
            s.run_quantum(heavy, lambda: (order.append("heavy"),
                                          time.sleep(0.02)))

    t = threading.Thread(target=heavy_loop, daemon=True)
    t.start()
    time.sleep(0.08)        # heavy accumulates usage
    for _ in range(5):
        s.run_quantum(light, lambda: order.append("light"))
    stop.set()
    t.join(timeout=5)
    lights = [i for i, x in enumerate(order) if x == "light"]
    assert len(lights) == 5
    assert heavy.device_seconds > light.device_seconds
    gaps = [b - a for a, b in zip(lights, lights[1:])]
    assert max(gaps) <= 2


def test_concurrent_queries_interleave():
    """A short query against a busy runner completes while a long query
    is still executing."""
    runner = LocalRunner(tpch_sf=0.05, rows_per_batch=1 << 12,
                         device="cpu")
    runner.execute("select 1")      # warm caches
    short_done_at, long_done_at = [], []
    t0 = time.perf_counter()

    def long_query():
        runner.execute(
            "select l_suppkey, count(*), sum(l_extendedprice) "
            "from lineitem group by 1")
        long_done_at.append(time.perf_counter() - t0)

    def short_query():
        time.sleep(0.05)   # start after the long query is underway
        runner.execute("select count(*) from nation")
        short_done_at.append(time.perf_counter() - t0)

    tl = threading.Thread(target=long_query)
    ts = threading.Thread(target=short_query)
    tl.start()
    ts.start()
    tl.join(timeout=120)
    ts.join(timeout=120)
    assert short_done_at and long_done_at
    assert short_done_at[0] <= long_done_at[0] + 0.5


def test_mesh_query_billed_per_slot(monkeypatch):
    """A mesh query's quanta hold every slot of its mesh: the scheduler
    bills them per slot (scheduler_chip_quanta_total counts slots)."""
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    runner = LocalRunner(tpch_sf=0.01, device="cpu")
    q = "select l_returnflag, count(*) from lineitem group by 1"
    chips0 = REGISTRY.counter("scheduler_chip_quanta_total").value
    quanta0 = REGISTRY.counter("scheduler_quanta_total").value
    runner.execute(q, properties={"mesh_execution": "on",
                                  "mesh_devices": 4})
    acct = runner.last_stats.scheduler
    assert acct["devices"] == 4 and acct["quanta"] >= 1
    assert REGISTRY.counter("scheduler_chip_quanta_total").value - chips0 == \
        4 * (REGISTRY.counter("scheduler_quanta_total").value - quanta0)
    runner.execute(q, properties={"mesh_execution": "off"})
    assert runner.last_stats.scheduler["devices"] == 1


def test_fair_scheduling_off_bypasses_the_scheduler():
    runner = LocalRunner(tpch_sf=0.01, device="cpu")
    quanta0 = REGISTRY.counter("scheduler_quanta_total").value
    runner.execute("set session fair_scheduling = false")
    runner.execute("select count(*) from nation")
    assert REGISTRY.counter("scheduler_quanta_total").value == quanta0
    assert runner.last_stats.scheduler is None


def test_scan_stall_credit_reaches_the_running_quantum():
    """note_stall credits the thread that runs the quantum, and only
    it: the credit comes off the billed seconds."""
    s = DeviceScheduler()
    h = s.task("stall")

    def fn():
        s.note_stall(10.0)        # more than the quantum: clamps to it
        time.sleep(0.01)
    s.run_quantum(h, fn)
    assert h.device_seconds == 0.0 and h.stall_credit == 0.0
    other = s.task("outside")
    s.note_stall(5.0)             # no running quantum: nobody credited
    s.run_quantum(other, lambda: time.sleep(0.01))
    assert other.device_seconds > 0.0


def test_stalled_releases_device_then_restores_bookkeeping():
    s = DeviceScheduler()
    a = s.task("stall-a")
    b = s.task("other-b")
    stalled_now = threading.Event()
    release = threading.Event()
    order = []

    def a_quantum():
        order.append("a-enter")
        with s.stalled(a):
            stalled_now.set()
            assert release.wait(timeout=5)
        order.append("a-resume")

    before = REGISTRY.counter("device_stall_release_total").value
    t = threading.Thread(
        target=lambda: s.run_quantum(a, a_quantum), daemon=True)
    t.start()
    assert stalled_now.wait(timeout=5)
    s.run_quantum(b, lambda: order.append("b-ran"))
    release.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert order == ["a-enter", "b-ran", "a-resume"]
    assert REGISTRY.counter(
        "device_stall_release_total").value == before + 1
    assert s._running is None
    assert s._running_depth == 0


def test_stalled_inside_nested_quantum_keeps_reentrancy():
    s = DeviceScheduler()
    a = s.task("nested")

    def inner():
        with s.stalled(a):
            assert s._running is a
            assert s._running_depth == 1
        assert s._running_depth == 2

    def outer():
        s.run_quantum(a, inner)

    s.run_quantum(a, outer)
    assert s._running is None
    assert s._running_depth == 0


def test_stalled_without_held_quantum_is_a_noop():
    s = DeviceScheduler()
    a = s.task("free")
    before = REGISTRY.counter("device_stall_release_total").value
    with s.stalled(a):
        pass
    with s.stalled(None):
        pass
    assert REGISTRY.counter(
        "device_stall_release_total").value == before
    assert s._running is None and s._running_depth == 0


def test_device_floor_pad_models_fixed_throughput(monkeypatch):
    monkeypatch.setattr(tx, "_SERVICE_FLOOR_S", 0.05)
    t0 = time.perf_counter()
    tx.device_floor_pad(0.0)
    assert time.perf_counter() - t0 >= 0.045
    t0 = time.perf_counter()
    tx.device_floor_pad(10.0)         # chain already past the floor
    assert time.perf_counter() - t0 < 0.02
    monkeypatch.setattr(tx, "_SERVICE_FLOOR_S", 0.0)
    t0 = time.perf_counter()
    tx.device_floor_pad(0.0)          # disabled: free
    assert time.perf_counter() - t0 < 0.02


def test_lock_discipline_clean_after_scheduler_exercise():
    """The scheduler's checked locks fed the lock-order validator through
    every test above: no observed inversion cycle."""
    from presto_tpu_torch._devtools import lockcheck
    assert lockcheck.ENABLED
    assert lockcheck.GRAPH.check() == [], lockcheck.GRAPH.check()


def test_set_service_floor_ms_sets_and_returns_the_floor():
    old = tx.set_service_floor_ms(30.0)
    try:
        t0 = time.perf_counter()
        tx.device_floor_pad(0.0)
        assert time.perf_counter() - t0 >= 0.03
        assert tx.set_service_floor_ms(-5.0) == pytest.approx(30.0)
        assert tx._SERVICE_FLOOR_S == 0.0
    finally:
        tx.set_service_floor_ms(old)
