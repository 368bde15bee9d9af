"""The port's sorted-run segment sums (presto_tpu_torch/ops/scan.py)
against presto_tpu's Pallas scan kernels in interpret mode: the same
seeded inputs, bit-exact int64 results (wraparound mod 2^64 included).

On the CPU the port's wrapper runs its plain version; the ``cuda``-marked
tests hold the CUDA kernel against it on a GPU, on the same edge cases
(runs around the kernel's row tiles, one run, no run, a ragged and a
one-row input) that ``chip_smoke.py`` checks on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto_tpu.ops.pallas_scan as ps
from presto_tpu_torch.ops import kernels, scan


def _sorted_run_case(rng, n_groups, n_rows, lo=-10**17, hi=10**17):
    """Runs as tests/test_pallas_scan.py makes them."""
    sizes = rng.multinomial(n_rows, np.ones(n_groups) / n_groups)
    vals = rng.integers(lo, hi, n_rows).astype(np.int64)
    starts = np.zeros(n_groups, dtype=np.int32)
    starts[1:] = np.cumsum(sizes)[:-1]
    return vals, starts


def _both(vals, starts, cap, max_rows):
    want = np.asarray(ps.segment_sum_sorted_i64(
        jnp.asarray(vals), jnp.asarray(starts), cap,
        max_rows_per_group=max_rows, interpret=True))
    got = scan.segment_sum_sorted_i64(torch.from_numpy(vals),
                                      torch.from_numpy(starts), cap)
    return want, got.numpy()


def test_segment_sum_sorted_i64_exact():
    rng = np.random.default_rng(3)
    vals, starts = _sorted_run_case(rng, 64, 5000)
    want, got = _both(vals, starts, 64, 5000)
    assert np.array_equal(got, want)


def test_segment_sum_sorted_trailing_and_absent_groups():
    # groups [0,0,1] then dead rows (zero-valued), groups 2..3 absent
    vals = np.asarray([5, 7, 11, 0, 0], dtype=np.int64)
    starts = np.asarray([0, 2, 5, 5], dtype=np.int32)
    want, got = _both(vals, starts, 4, 5)
    assert got[0] == 12 and got[1] == 11
    assert np.array_equal(got[:2], want[:2])


@pytest.mark.parametrize("n", [1, 100, ps.TILE, ps.TILE + 1, 3 * ps.TILE + 17])
def test_segment_sum_sorted_tile_edges(n):
    """The cumsum tile-edge lengths of tests/test_pallas_scan.py, with a
    handful of runs and a trailing absent group."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    k = min(n, 5)
    starts = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
    starts[0] = 0
    starts = np.concatenate([starts, np.asarray([n], np.int32)])
    want, got = _both(vals, starts, k + 1, n)
    assert np.array_equal(got[:k], want[:k])


def test_segment_sum_sorted_wraps_mod_2_64():
    """Values near +-2^62 overflow int64 within a run: both engines wrap
    to the same bits."""
    rng = np.random.default_rng(7)
    vals, starts = _sorted_run_case(rng, 8, 4000, lo=-(1 << 62),
                                    hi=1 << 62)
    vals[:1000] = (1 << 62) + rng.integers(0, 1000, 1000)
    want, got = _both(vals, starts, 8, 4000)
    assert np.array_equal(got, want)
    exact = [sum(int(v) for v in vals[a:b])
             for a, b in zip(starts, list(starts[1:]) + [len(vals)])]
    assert any(not -(1 << 63) <= e < (1 << 63) for e in exact)


def _edge_case(name):
    """(values, starts) of one edge case around the CUDA kernel's tiles of
    ``scan.TILE_ROWS`` rows; every segment is compared, absent ones
    included."""
    rng = np.random.default_rng(17)
    tile = scan.TILE_ROWS
    n = 5 * tile + 3

    def vals(rows):
        return rng.integers(-(1 << 62), 1 << 62, rows, dtype=np.int64)

    def starts_of(points, cap, rows):
        s = np.full(cap, rows, np.int32)
        s[:len(points)] = points
        return s

    if name == "tile_edges":
        edges = [0, tile - 1, tile, tile + 1, 2 * tile - 1, 3 * tile + 1,
                 4 * tile, 4 * tile + 2, 5 * tile]
        return vals(n), starts_of(edges, len(edges) + 4, n)
    if name == "one_run_all_rows":
        return vals(n), starts_of([0], 8, n)
    if name == "all_groups_absent":
        return vals(n), starts_of([], 16, n)
    if name == "ragged_n":
        rows = 3 * tile + 1001
        cuts = np.sort(rng.choice(np.arange(1, rows), 300, replace=False))
        return vals(rows), starts_of(np.concatenate([[0], cuts]), 400, rows)
    if name == "one_row":
        return vals(1), starts_of([0], 2, 1)
    assert name == "empty_at_row_0"   # empty runs at row 0 give values[0]
    return vals(n), starts_of([0, 0, 0, 7, 7, tile], 9, n)


EDGE_CASES = ["tile_edges", "one_run_all_rows", "all_groups_absent",
              "ragged_n", "one_row", "empty_at_row_0"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_segment_sum_sorted_edge_cases(case):
    vals, starts = _edge_case(case)
    want, got = _both(vals, starts, len(starts), len(vals))
    assert np.array_equal(got, want)


def test_segment_count_sorted():
    live = np.asarray([True, True, False, True, False])
    starts = np.asarray([0, 2, 5], dtype=np.int32)
    want = np.asarray(ps.segment_count_sorted(
        jnp.asarray(live), jnp.asarray(starts), 3, interpret=True))
    got = scan.segment_count_sorted(torch.from_numpy(live),
                                    torch.from_numpy(starts), 3).numpy()
    assert got[0] == 2 and got[1] == 1
    assert np.array_equal(got[:2], want[:2])


def test_wrapper_checks_its_inputs():
    vals = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        scan.segment_sum_sorted_i64(vals.to(torch.int32),
                                    torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        scan.segment_sum_sorted_i64(vals, torch.zeros(3, dtype=torch.int32),
                                    2)


def test_aligned16_copies_only_misaligned_tensors():
    """The kernels read 16 bytes at a time: a tensor whose data starts off
    a 16-byte boundary is copied, any other is passed as it is."""
    base = torch.arange(9, dtype=torch.int64)
    assert kernels.aligned16(base) is base
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    moved = kernels.aligned16(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(gpu):
    rng = np.random.default_rng(11)
    vals, starts = _sorted_run_case(rng, 3000, 1 << 16, lo=-(1 << 62),
                                    hi=1 << 62)
    v, s = torch.from_numpy(vals).to(gpu), torch.from_numpy(starts).to(gpu)
    before = scan.launches
    got = scan.segment_sum_sorted_i64(v, s, len(starts))
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    want = scan.segment_sum_sorted_plain(v, s, len(starts))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_kernel_edge_cases(gpu, case):
    vals, starts = _edge_case(case)
    v, s = torch.from_numpy(vals).to(gpu), torch.from_numpy(starts).to(gpu)
    got = scan.segment_sum_sorted_i64(v, s, len(starts))
    torch.cuda.synchronize()
    assert torch.equal(got, scan.segment_sum_sorted_plain(v, s, len(starts)))
