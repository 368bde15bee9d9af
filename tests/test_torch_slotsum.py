"""The dense GROUP BY's slot sums (presto_tpu_torch/ops/slotsum.py): the
reducers' dispatch rule, the plain version against numpy, the reducers'
counts and sums through either route, the route counters, and TPC-H Q1
on the dense path.

On the CPU the wrapper runs its plain version (``index_add_`` into
zeros); the ``cuda``-marked tests hold the CUDA kernel of
``csrc/slotsum.cu`` against it on a GPU: int64 bit for bit (sums that
wrap mod 2^64 included), float64 within 1e-12 relative (the order of
addition differs), bool counts exactly, and two launches on the same
input bit for bit. The float64 inputs are non-negative, as TPC-H's
prices and quantities are, so that a relative gap measures the order of
addition and not cancellation.
"""
import types

import numpy as np
import pytest
import torch

from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.ops import aggregation, slotsum

from tpch_queries import Q

SLOTS = [1, 13, 32, 33, 4097, 4098, 1 << 21]

# (device type, dtype, ndim, whether the sum may go through slot_sum)
SHAPES = [("cuda", torch.float64, 1, True), ("cuda", torch.int64, 1, True),
          ("cuda", torch.bool, 1, True), ("cpu", torch.float64, 1, True),
          ("cpu", torch.bool, 1, True), ("cuda", torch.float32, 1, False),
          ("cuda", torch.int32, 1, False), ("cuda", torch.int64, 2, False)]


def _fake(device, dtype, ndim):
    """What ``routed`` reads of a tensor, for a device this host lacks."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 ndim=ndim)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("device,dtype,ndim,takes", SHAPES)
def test_dispatch_rule(device, dtype, ndim, takes, slots):
    """1-D float64, int64 and bool sums over at most 4097 slots (the
    unbounded dense path's 4096 keys and the dead lanes' slot) go
    through slot_sum, the kernel on CUDA and the plain version on the
    CPU; every other sum keeps index_add_."""
    want = takes and slots <= slotsum.MAX_SLOTS
    assert slotsum.routed(_fake(device, dtype, ndim), slots) is want


def _case(dtype, slots, n, live=None, seed=0):
    """(gid, x) numpy arrays: ``n`` lanes over ``live`` of the ``slots``
    slots (all of them by default); int64 values near +-2^62 so that
    sums wrap, float64 values in [0, 1e5)."""
    rng = np.random.default_rng(seed + 7 * slots + n)
    pool = (rng.choice(slots, size=live, replace=False) if live
            else np.arange(slots))
    gid = pool[rng.integers(0, len(pool), n)].astype(np.int64)
    if dtype == torch.int64:
        x = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        x[: n // 3] = (1 << 62) + rng.integers(0, 1000, n // 3)
    elif dtype == torch.float64:
        x = rng.uniform(0.0, 1e5, n)
    else:
        x = rng.random(n) < 0.7
    return gid, x


def _numpy_sums(gid, x, slots):
    dtype = np.float64 if x.dtype == np.float64 else np.int64
    out = np.zeros(slots, dtype=dtype)
    np.add.at(out, gid, x.astype(dtype))      # int64 wraps, as the kernel
    return out


@pytest.mark.parametrize("slots", [1, 13, 33, 4097])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.bool])
def test_plain_matches_numpy(dtype, slots):
    gid, x = _case(dtype, slots, 5000)
    before = slotsum.plain_calls
    got = slotsum.slot_sum(torch.from_numpy(gid), torch.from_numpy(x),
                           slots)
    assert slotsum.plain_calls == before + 1
    want = _numpy_sums(gid, x, slots)
    assert got.dtype == (torch.float64 if dtype == torch.float64
                         else torch.int64)
    if dtype == torch.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    else:
        assert np.array_equal(got.numpy(), want)


def test_plain_int64_sums_wrap_mod_2_64():
    gid = torch.zeros(4, dtype=torch.int64)
    x = torch.full((4,), 1 << 62, dtype=torch.int64)
    assert int(slotsum.slot_sum(gid, x, 1)[0]) == 0      # 2^64 wraps to 0


def test_wrapper_checks_its_inputs():
    gid = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        slotsum.slot_sum(gid.to(torch.int32), torch.zeros(8), 2)
    with pytest.raises(TypeError):
        slotsum.slot_sum(gid, torch.zeros(8, dtype=torch.float32), 2)
    with pytest.raises(TypeError):
        slotsum.slot_sum(gid, torch.zeros(8, 2, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        slotsum.slot_sum(gid, torch.zeros(7, dtype=torch.float64), 2)
    for slots in (0, slotsum.MAX_SLOTS + 1):
        with pytest.raises(ValueError):
            slotsum.slot_sum(gid, torch.zeros(8, dtype=torch.float64), slots)


@pytest.mark.parametrize("reducers", ["slot", "seg"])
def test_reducer_counts_take_bool_as_before(reducers):
    """A reducer's count takes the bool column as it is and gives the
    int64 counts the int64 index_add_ gave (and, on the sort path, the
    sorted-run segment sums)."""
    gid, valid = _case(torch.bool, 13, 3000, live=4)
    if reducers == "seg":
        # sorted runs of groups 0..3, groups 4..12 absent (starts == n)
        gid = np.unique(gid, return_inverse=True)[1].astype(np.int64)
        gid.sort()
    g, v = torch.from_numpy(gid), torch.from_numpy(valid)
    if reducers == "slot":
        red = aggregation._SlotReducers(g, 13)
    else:
        starts = np.searchsorted(gid, np.arange(13)).astype(np.int32)
        red = aggregation._SegReducers(g, 13, torch.from_numpy(starts))
    got = red.count(v)
    want = torch.zeros(13, dtype=torch.int64).index_add_(
        0, g, v.to(torch.int64))
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_counters_rise_only_for_cuda_sums():
    kernel = slotsum.KERNEL_SUMS.value
    index_add = slotsum.INDEX_ADD_SUMS.value
    plain = slotsum.plain_calls
    gid, x = _case(torch.float64, 13, 1000, live=4)
    red = aggregation._SlotReducers(torch.from_numpy(gid), 13)
    red.sum(torch.from_numpy(x))
    red.count(torch.from_numpy(x > 5e4))
    # CPU sums run the plain version and count under neither route
    assert slotsum.plain_calls == plain + 2
    assert slotsum.KERNEL_SUMS.value == kernel
    assert slotsum.INDEX_ADD_SUMS.value == index_add
    assert slotsum.routed(_fake("cuda", torch.float64, 1), 13)
    assert slotsum.routed(_fake("cuda", torch.bool, 1), 4097)
    assert slotsum.KERNEL_SUMS.value == kernel + 2
    assert not slotsum.routed(_fake("cuda", torch.int64, 1), 4098)
    assert not slotsum.routed(_fake("cuda", torch.int64, 2), 13)
    assert slotsum.INDEX_ADD_SUMS.value == index_add + 2
    assert not slotsum.routed(_fake("cpu", torch.float64, 1), 4098)
    assert slotsum.KERNEL_SUMS.value == kernel + 2
    assert slotsum.INDEX_ADD_SUMS.value == index_add + 2


_Q1 = {name: sql for name, sql, _ in Q}["q1"]


@pytest.fixture(scope="module")
def q1_runner():
    return LocalRunner(tpch_sf=0.01, device="cpu")


def _rows_close(got, want):
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            if isinstance(u, float):
                assert u == pytest.approx(v, rel=1e-12)
            else:
                assert u == v


def test_q1_dense_path_unchanged(q1_runner):
    """Q1 (two dictionary keys: 13 slots, 4 live) on the dense path
    equals the sort path, and its counts add up to the filtered rows."""
    dense = q1_runner.execute(_Q1).rows
    by_sort = q1_runner.execute(_Q1, properties={"dense_grouping": False})
    _rows_close(dense, by_sort.rows)
    total = q1_runner.execute(
        "select count(*) from lineitem where l_shipdate <= date "
        "'1998-12-01' - interval '90' day").rows[0][0]
    assert sum(r[-1] for r in dense) == total and len(dense) == 4


def test_q1_through_the_kernel_route(q1_runner, monkeypatch):
    """Q1's reducer sums go through the wrapper (its plain version on
    the CPU), the bool counts as they are, and its answers are those of
    index_add_ in the reducers."""
    before = slotsum.plain_calls
    got = q1_runner.execute(_Q1).rows
    # per batch: 7 double sums, 7 validity counts, count(*) and the live
    # slots' count
    assert slotsum.plain_calls - before >= 16
    monkeypatch.setattr(slotsum, "routed", lambda x, slots: False)
    _rows_close(got, q1_runner.execute(_Q1).rows)


# -- on the GPU ---------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda")


# (slots, live slots or None for all)
SLOT_CASES = [(1, None), (13, 4), (32, None), (33, None), (4097, None),
              (4097, 4)]
LANES = [0, 1, 2 * 256 * 4 * 2 + 7, 1 << 23]


def _assert_matches(got, want, dtype):
    if dtype == torch.float64:
        gap = ((got - want).abs() / want.abs().clamp(min=1e-300)).max()
        assert float(gap) <= 1e-12
    else:
        assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("slots,live", SLOT_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.bool])
def test_cuda_kernel_matches_plain(gpu, dtype, slots, live, lanes):
    gid, x = _case(dtype, slots, lanes, live)
    g, v = torch.from_numpy(gid).to(gpu), torch.from_numpy(x).to(gpu)
    before = slotsum.launches
    got = slotsum.slot_sum(g, v, slots)
    torch.cuda.synchronize()
    assert slotsum.launches == before + 1
    _assert_matches(got, slotsum.slot_sum_plain(g, v, slots), dtype)
    again = slotsum.slot_sum(g, v, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # the same bits every launch


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [13, 33, 4097])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.bool])
def test_cuda_every_lane_in_one_slot(gpu, dtype, slots):
    """The worst contention: every lane adds into one slot."""
    _, x = _case(dtype, slots, (1 << 20) + 3)
    g = torch.full((x.shape[0],), slots - 1, dtype=torch.int64, device=gpu)
    v = torch.from_numpy(x).to(gpu)
    got = slotsum.slot_sum(g, v, slots)
    _assert_matches(got, slotsum.slot_sum_plain(g, v, slots), dtype)
    assert torch.equal(got, slotsum.slot_sum(g, v, slots))


@pytest.mark.cuda
def test_cuda_misaligned_views_are_copied(gpu):
    gid, x = _case(torch.float64, 13, 1001, live=4)
    g = torch.from_numpy(gid).to(gpu)[1:]
    v = torch.from_numpy(x).to(gpu)[1:]
    assert v.data_ptr() % 16 != 0
    _assert_matches(slotsum.slot_sum(g, v, 13),
                    slotsum.slot_sum_plain(g, v, 13), torch.float64)


@pytest.mark.cuda
def test_cuda_reducers_take_the_kernel(gpu):
    """On the card a dense reducer's sums and counts launch the kernel
    and count under its route; 4098 slots and 2-D planes keep
    index_add_ and count under that route."""
    gid, x = _case(torch.float64, 13, 4096, live=4)
    g, v = torch.from_numpy(gid).to(gpu), torch.from_numpy(x).to(gpu)
    kernel, index_add = (slotsum.KERNEL_SUMS.value,
                         slotsum.INDEX_ADD_SUMS.value)
    launches = slotsum.launches
    red = aggregation._SlotReducers(g, 13)
    s = red.sum(v)
    c = red.count(v > 5e4)
    assert slotsum.launches == launches + 2
    assert slotsum.KERNEL_SUMS.value == kernel + 2
    _assert_matches(s, slotsum.slot_sum_plain(g, v, 13), torch.float64)
    assert torch.equal(c, slotsum.slot_sum_plain(g, v > 5e4, 13))
    aggregation._SlotReducers(g, 4098).sum(v)
    red.sum(torch.stack([v, v], 1))
    assert slotsum.launches == launches + 2
    assert slotsum.INDEX_ADD_SUMS.value == index_add + 2
