"""Window functions: presto_tpu_torch's evaluate_window against
presto_tpu's on the same seeded batch (every function of RANKING,
VALUE_FNS and AGG_FNS; partitions, ordering ties, ROWS and RANGE frames,
NULL keys and arguments, dead lanes), and tests/test_window.py's
WINDOW_QUERIES by SQL through both runners on the CPU.

Double arguments are multiples of 1/4, so every prefix sum is exact in
either engine's summation order: the kernel outputs must agree exactly
(``assert_rows_match`` at rel 0). The SQL queries sum TPC-H prices, so
their doubles agree within rel 1e-12."""
import numpy as np
import pytest

from presto_tpu import types as T
from presto_tpu.batch import Batch
from presto_tpu.exec.runner import LocalRunner
from presto_tpu.ops import sort as S
from presto_tpu.ops import window as W
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.ops import sort as TS
from presto_tpu_torch.ops import window as TW

from test_window import WINDOW_QUERIES
from torch_parity import assert_results_match, assert_rows_match, to_port

N, CAP = 300, 512
P_INT, P_STR, O_INT, O_DBL, V_DBL, V_INT, S_STR = range(7)


@pytest.fixture(scope="module")
def batches():
    """A seeded 300-row batch in a 512-lane capacity, every tenth live row
    killed: partition keys with NULLs, an integer order key with many
    ties and NULLs, a double order key, double / bigint / varchar
    arguments with NULLs."""
    rng = np.random.default_rng(20261016)

    def nullify(vals, p):
        return [None if rng.random() < p else v for v in vals]

    words = ["pear", "apple", "fig", "kiwi", "date", "lime"]
    data = {
        "p_int": (T.BIGINT, nullify(rng.integers(0, 4, N).tolist(), 0.05)),
        "p_str": (T.VARCHAR, nullify(
            [["c", "a", "b"][i] for i in rng.integers(0, 3, N)], 0.05)),
        "o_int": (T.INTEGER, nullify(rng.integers(0, 10, N).tolist(), 0.1)),
        "o_dbl": (T.DOUBLE, (rng.permutation(N) / 4.0).tolist()),
        "v_dbl": (T.DOUBLE, nullify(
            (rng.integers(-400, 400, N) / 4.0).tolist(), 0.15)),
        "v_int": (T.BIGINT, nullify(
            rng.integers(-10**6, 10**6, N).tolist(), 0.15)),
        "s": (T.VARCHAR, nullify(
            [words[i] for i in rng.integers(0, len(words), N)], 0.15)),
    }
    full = Batch.from_pydict(data, capacity=CAP)
    mask = np.asarray(full.row_mask).copy()
    mask[:N:10] = False
    jb = Batch(full.schema, full.columns, mask)
    return jb, to_port(jb)


def _spec(fn, args, typ, name, offset=1, ignore_order=False, frame=None):
    kw = {}
    if frame is not None:
        kw = {"frame": frame[0], "frame_start": frame[1],
              "frame_end": frame[2]}
    return (fn, tuple(args), typ, name, offset, ignore_order, kw)


UP, CUR, UF = ("unbounded_preceding", 0), ("current_row", 0), \
    ("unbounded_following", 0)


def pre(n):
    return ("preceding", n)


def fol(n):
    return ("following", n)


RANKS = [_spec("row_number", [], T.BIGINT, "rn"),
         _spec("rank", [], T.BIGINT, "rk"),
         _spec("dense_rank", [], T.BIGINT, "dr"),
         _spec("percent_rank", [], T.DOUBLE, "pr"),
         _spec("cume_dist", [], T.DOUBLE, "cd"),
         _spec("ntile", [], T.BIGINT, "nt3", offset=3),
         _spec("ntile", [], T.BIGINT, "nt7", offset=7)]

CASES = {
    "ranking_by_int_partition": ([P_INT], [(O_INT, True, None)], RANKS),
    "ranking_desc_nulls_first_by_string_partition": (
        [P_STR], [(O_INT, False, None)], RANKS),
    "ranking_nulls_first_two_keys": (
        [P_INT, P_STR], [(O_INT, True, True), (O_DBL, False, None)], RANKS),
    "value_functions": ([P_INT], [(O_INT, True, None), (O_DBL, True, None)], [
        _spec("first_value", [V_DBL], T.DOUBLE, "fv"),
        _spec("last_value", [S_STR], T.VARCHAR, "lv"),
        _spec("lag", [V_INT], T.BIGINT, "lag1"),
        _spec("lag", [S_STR], T.VARCHAR, "lag2", offset=2),
        _spec("lead", [V_DBL], T.DOUBLE, "lead1"),
        _spec("lead", [S_STR], T.VARCHAR, "lead3", offset=3),
        _spec("nth_value", [V_INT], T.BIGINT, "nth2", offset=2),
        _spec("nth_value", [S_STR], T.VARCHAR, "nth9", offset=9)]),
    "running_aggregates_over_ties": ([P_INT, P_STR], [(O_INT, True, None)], [
        _spec("sum", [V_DBL], T.DOUBLE, "sd"),
        _spec("sum", [V_INT], T.BIGINT, "si"),
        _spec("count", [V_DBL], T.BIGINT, "c"),
        _spec("count_star", [], T.BIGINT, "cs"),
        _spec("avg", [V_DBL], T.DOUBLE, "ad"),
        _spec("avg", [V_INT], T.DOUBLE, "ai"),
        _spec("min", [V_DBL], T.DOUBLE, "mnd"),
        _spec("max", [V_INT], T.BIGINT, "mxi"),
        _spec("min", [S_STR], T.VARCHAR, "mns"),
        _spec("max", [S_STR], T.VARCHAR, "mxs")]),
    "whole_partition_aggregates": ([P_STR], [], [
        _spec("sum", [V_DBL], T.DOUBLE, "sd", ignore_order=True),
        _spec("count", [V_INT], T.BIGINT, "c", ignore_order=True),
        _spec("count_star", [], T.BIGINT, "cs", ignore_order=True),
        _spec("avg", [V_INT], T.DOUBLE, "a", ignore_order=True),
        _spec("min", [V_INT], T.BIGINT, "mn", ignore_order=True),
        _spec("max", [S_STR], T.VARCHAR, "mx", ignore_order=True)]),
    "rows_frames": ([P_INT], [(O_INT, True, None), (O_DBL, True, None)], [
        _spec("sum", [V_DBL], T.DOUBLE, "s2p",
              frame=("rows", pre(2), CUR)),
        _spec("avg", [V_INT], T.DOUBLE, "a11",
              frame=("rows", pre(1), fol(1))),
        _spec("min", [V_DBL], T.DOUBLE, "mn31",
              frame=("rows", pre(3), fol(1))),
        _spec("max", [S_STR], T.VARCHAR, "mxcuf",
              frame=("rows", CUR, UF)),
        _spec("first_value", [V_DBL], T.DOUBLE, "fv21",
              frame=("rows", pre(2), pre(1))),
        _spec("last_value", [V_INT], T.BIGINT, "lv13",
              frame=("rows", fol(1), fol(3))),
        _spec("nth_value", [V_DBL], T.DOUBLE, "nv2",
              frame=("rows", pre(2), fol(2)), offset=2),
        _spec("count", [V_DBL], T.BIGINT, "c52",
              frame=("rows", pre(5), pre(2))),
        _spec("count_star", [], T.BIGINT, "cs_up",
              frame=("rows", UP, CUR)),
        _spec("sum", [V_INT], T.BIGINT, "s1uf",
              frame=("rows", pre(1), UF))]),
    "range_frames": ([P_INT], [(O_INT, True, None)], [
        _spec("count_star", [], T.BIGINT, "c3p",
              frame=("range", pre(3), CUR)),
        _spec("sum", [V_DBL], T.DOUBLE, "s22",
              frame=("range", pre(2), fol(2))),
        _spec("min", [V_INT], T.BIGINT, "mn11",
              frame=("range", pre(1), fol(1))),
        _spec("max", [V_DBL], T.DOUBLE, "mxcuf",
              frame=("range", CUR, UF)),
        _spec("count", [V_INT], T.BIGINT, "c53",
              frame=("range", pre(5), pre(3)))]),
    "range_frames_descending": ([P_STR], [(O_INT, False, None)], [
        _spec("count_star", [], T.BIGINT, "c3p",
              frame=("range", pre(3), CUR)),
        _spec("sum", [V_INT], T.BIGINT, "s14",
              frame=("range", fol(1), fol(4)))]),
    "range_frame_on_double_key": ([], [(O_DBL, True, None)], [
        _spec("count_star", [], T.BIGINT, "c",
              frame=("range", pre(10), fol(10))),
        _spec("avg", [V_DBL], T.DOUBLE, "a",
              frame=("range", pre(5), CUR))]),
    "no_partition": ([], [(O_DBL, True, None)], [
        _spec("row_number", [], T.BIGINT, "rn"),
        _spec("sum", [V_DBL], T.DOUBLE, "run"),
        _spec("lag", [S_STR], T.VARCHAR, "prev"),
        _spec("cume_dist", [], T.DOUBLE, "cd")]),
}


def _run(pkg_sort, pkg_window, batch, part, order, specs, port):
    keys = [pkg_sort.SortKey(c, asc, nf) for c, asc, nf in order]
    ws = []
    for fn, args, typ, name, offset, ignore, kw in specs:
        if port:
            from torch_parity import port_type
            typ = port_type(typ)
        ws.append(pkg_window.WindowSpec(fn, args, typ, name, offset, ignore,
                                        **kw))
    return pkg_window.evaluate_window(batch, part, keys, ws)


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_window_matches_reference(batches, case):
    jb, tb = batches
    part, order, specs = CASES[case]
    want = _run(S, W, jb, part, order, specs, port=False)
    got = _run(TS, TW, tb, part, order, specs, port=True)
    assert got.schema.names == want.schema.names
    assert np.array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    rows = want.to_pylist()
    assert len(rows) == N - len(range(0, N, 10))
    assert_rows_match(got.to_pylist(), rows, 0.0)


def test_functions_cover_every_window_function():
    covered = {s[0] for _, _, specs in CASES.values() for s in specs}
    assert set(TW.RANKING + TW.VALUE_FNS + TW.AGG_FNS) <= covered
    assert (TW.RANKING, TW.VALUE_FNS, TW.AGG_FNS) == \
        (W.RANKING, W.VALUE_FNS, W.AGG_FNS)


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01, device="cpu")


@pytest.mark.parametrize("sql", WINDOW_QUERIES, ids=range(len(WINDOW_QUERIES)))
def test_window_query_matches_reference(runners, sql):
    jax_runner, torch_runner = runners
    want = jax_runner.execute(sql)
    got = torch_runner.execute(sql)
    assert got.rows
    assert_results_match(got, want, 1e-12)
