"""The port's direct-address probe (presto_tpu_torch/ops/probe.py)
against presto_tpu's Pallas probe kernel in interpret mode
(FORCE_PALLAS_PROBE monkeypatched on, as tests/test_join_strategy.py
does): the same seeded batches through both, identical rows across the
payload dtype zoo, with NULL and out-of-domain lanes.

On the CPU the port's wrapper runs its plain version; the ``cuda``-marked
tests hold the CUDA kernel against it on a GPU, on the edge cases that
``chip_smoke.py`` also checks on the card (all lanes dead, an empty
build, the full 31-column descriptor set, int128 and 1-byte columns at a
ragged lane count).
"""
import ctypes
import decimal
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import types as T
from presto_tpu.batch import Batch, Column
from presto_tpu.ops import join as J
from presto_tpu.ops import pallas_join as PJ
from presto_tpu_torch.ops import join as TJ
from presto_tpu_torch.ops import probe as TP

from torch_parity import sorted_rows, to_port


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setattr(PJ, "FORCE_PALLAS_PROBE", True)
    monkeypatch.setitem(PJ._STATE, "broken", False)


def _with_nulls(b: Batch, col: int, null_rows) -> Batch:
    cols = list(b.columns)
    mask = np.ones(b.capacity, dtype=bool)
    mask[list(null_rows)] = False
    c = cols[col]
    cols[col] = Column(c.type, c.data, c.validity & jnp.asarray(mask),
                       c.dictionary)
    return Batch(b.schema, cols, b.row_mask)


def _zoo(n=40, seed=3):
    """The payload dtype zoo of test_pallas_lookup_parity_dtypes: 64-bit
    ints, doubles, 32-bit ints, booleans, dictionary strings and
    decimal128 limb pairs, with NULLs, plus a probe with out-of-domain
    keys."""
    rng = np.random.default_rng(seed)
    build = Batch.from_pydict({
        "k": (T.BIGINT, list(range(1, n + 1))),
        "big": (T.BIGINT, rng.integers(-2**52, 2**52, n).tolist()),
        "dbl": (T.DOUBLE, (rng.standard_normal(n) * 1e9).tolist()),
        "i": (T.INTEGER, rng.integers(-100, 100, n).tolist()),
        "b": (T.BOOLEAN, (rng.random(n) < 0.5).tolist()),
        "s": (T.VARCHAR, [f"s{i % 7}" for i in range(n)]),
        "dec": (T.decimal(30, 2),
                [decimal.Decimal(int(v)) * 1000000
                 + decimal.Decimal(int(w)) / 100
                 for v, w in zip(rng.integers(-2**52, 2**52, n),
                                 rng.integers(0, 10**4, n))]),
    })
    build = _with_nulls(build, 1, [2, 5])
    build = _with_nulls(build, 6, [4])
    probe = Batch.from_pydict({
        "p": (T.BIGINT, rng.integers(-3, n + 4, 64).tolist())})
    probe = _with_nulls(probe, 0, [1, 9])
    return build, probe


PAYLOAD = [1, 2, 3, 4, 5, 6]
NAMES = ["big", "dbl", "i", "b", "s", "dec"]


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_lookup_join_direct_matches_pallas(force_pallas, jt):
    build, probe = _zoo()
    want = PJ.lookup_join_direct(probe, build, [0], [0], PAYLOAD, NAMES, jt,
                                 J.prepare_direct(build, [0], 1, 64))
    tb, tp = to_port(build), to_port(probe)
    got = TP.lookup_join_direct(tp, tb, [0], [0], PAYLOAD, NAMES, jt,
                                TJ.prepare_direct(tb, [0], 1, 64))
    assert sorted_rows(got) == sorted_rows(want)
    plain = TJ.lookup_join(tp, tb, [0], [0], PAYLOAD, NAMES, jt,
                           prepared=TJ.prepare_direct(tb, [0], 1, 64))
    assert sorted_rows(plain) == sorted_rows(want)


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_lookup_join_direct_keyed_matches_pallas(force_pallas, jt):
    """Planner-keyed composite direct tables (two keys)."""
    rng = np.random.default_rng(5)
    n = 30
    k1 = [i % 5 for i in range(n)]
    k2 = [i // 5 for i in range(n)]
    build = Batch.from_pydict({
        "k1": (T.BIGINT, k1), "k2": (T.BIGINT, k2),
        "v": (T.DOUBLE, rng.standard_normal(n).tolist())})
    probe = Batch.from_pydict({
        "a": (T.BIGINT, rng.integers(-1, 7, 50).tolist()),
        "b": (T.BIGINT, rng.integers(-1, 8, 50).tolist())})
    los, sizes, K = J.direct_keyed_plan(((0, 4), (0, 5)))
    jprep = J.prepare_direct_keyed(build, [0, 1], los, sizes, 64)
    want = PJ.lookup_join_direct(probe, build, [0, 1], [0, 1], [2], ["v"],
                                 jt, jprep)
    tb, tp = to_port(build), to_port(probe)
    tprep = TJ.prepare_direct_keyed(tb, [0, 1], los, sizes, 64)
    got = TP.lookup_join_direct(tp, tb, [0, 1], [0, 1], [2], ["v"], jt,
                                tprep)
    assert sorted_rows(got) == sorted_rows(want)


def test_direct_probe_matches_pallas_kernel():
    """The kernel-level function on the same i32 inputs: equal match
    counts everywhere, equal validity bits and payload on matched lanes
    (unmatched lanes carry zeros in the port)."""
    rng = np.random.default_rng(9)
    size, n_build, n = 512, 300, 1000
    keys = np.sort(rng.choice(size, n_build, replace=False))
    lo = np.full(size, n_build, np.int32)
    lo[keys] = np.arange(n_build, dtype=np.int32)
    cnt = np.zeros(size, np.int32)
    cnt[keys] = 1
    codes = rng.integers(-1, size, n).astype(np.int32)
    vbits = rng.integers(0, 8, n_build).astype(np.int32)
    planes = [rng.integers(-2**31, 2**31, n_build).astype(np.int32)
              for _ in range(3)]
    jc, jv, jp = PJ.direct_probe(jnp.asarray(codes), jnp.asarray(lo),
                                 jnp.asarray(cnt), jnp.asarray(vbits),
                                 [jnp.asarray(p) for p in planes],
                                 interpret=True)
    tc, tv, tps = TP.direct_probe(*(torch.from_numpy(a) for a in
                                    (codes, lo, cnt, vbits)),
                                  [torch.from_numpy(p) for p in planes])
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    hit = tc.numpy() > 0
    assert hit.any() and (~hit).any()
    assert np.array_equal(tv.numpy()[hit], np.asarray(jv)[hit])
    for a, b in zip(tps, jp):
        assert np.array_equal(a.numpy()[hit], np.asarray(b)[hit])
        assert not a.numpy()[~hit].any()


def test_payload_beyond_one_validity_plane():
    """More than 31 payload columns: one validity plane per 31 columns."""
    n = 50
    data = {"k": (T.BIGINT, list(range(n)))}
    for c in range(40):
        data[f"c{c}"] = (T.INTEGER, [None if (i + c) % 7 == 0 else i * c
                                     for i in range(n)])
    build = Batch.from_pydict(data)
    probe = Batch.from_pydict({"p": (T.BIGINT, list(range(-5, n + 5)))})
    payload = list(range(1, 41))
    names = [f"c{c}" for c in range(40)]
    want = J.lookup_join(probe, build, [0], [0], payload, names, "left")
    tb, tp = to_port(build), to_port(probe)
    got = TP.lookup_join_direct(tp, tb, [0], [0], payload, names, "left",
                                TJ.prepare_direct(tb, [0], 0, 64))
    assert sorted_rows(got) == sorted_rows(want)


def test_probe_args_layout_matches_probe_cu():
    """The ctypes mirror of the kernel's by-value arguments has the size
    and field offsets that csrc/probe.cu asserts for its struct."""
    src = (pathlib.Path(TP.__file__).resolve().parent.parent / "csrc"
           / "probe.cu").read_text()
    sizes = dict(re.findall(r"sizeof\((\w+)\) == (\d+)", src))
    assert ctypes.sizeof(TP.ProbeArgs) == int(sizes["ProbeArgs"])
    assert ctypes.sizeof(TP.ColDesc) == int(sizes["ColDesc"])
    offsets = re.findall(r"offsetof\(ProbeArgs, (\w+)\) == (\d+)", src)
    assert [f for f, _ in offsets] == [f for f, _ in TP.ProbeArgs._fields_]
    for field, off in offsets:
        assert getattr(TP.ProbeArgs, field).offset == int(off), field
    max_cols = re.search(r"kMaxCols = (\d+);", src).group(1)
    assert int(max_cols) == TP.VBITS_COLUMNS
    assert TP.ProbeArgs.cols.size == (TP.VBITS_COLUMNS
                                      * ctypes.sizeof(TP.ColDesc))


def _tables(rng, size=4096, n_build=3000, live=2500, span=4000):
    keys = np.sort(rng.choice(span, live, replace=False))
    lo = np.full(size, n_build, np.int32)
    lo[keys] = np.arange(live, dtype=np.int32)
    cnt = np.zeros(size, np.int32)
    cnt[keys] = 1
    return lo, cnt


def _codes(rng, n, span=4000, dead=0.3):
    c = rng.integers(0, span, n).astype(np.int32)
    c[rng.random(n) < dead] = -1
    return c


@pytest.mark.parametrize("case", ["all_lanes_dead", "31_columns"])
def test_direct_probe_edge_cases_match_pallas_kernel(case):
    """All lanes dead, and the largest by-value descriptor set (31 int32
    payload columns), through both kernel-level functions."""
    rng = np.random.default_rng(23)
    lo, cnt = _tables(rng)
    ncols = 31 if case == "31_columns" else 3
    codes = (_codes(rng, 9000) if case == "31_columns"
             else np.full(5000, -1, np.int32))
    vbits = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    planes = [rng.integers(-2**31, 2**31, 3000).astype(np.int32)
              for _ in range(ncols)]
    jc, jv, jp = PJ.direct_probe(jnp.asarray(codes), jnp.asarray(lo),
                                 jnp.asarray(cnt), jnp.asarray(vbits),
                                 [jnp.asarray(p) for p in planes],
                                 interpret=True)
    tc, tv, tps = TP.direct_probe(*(torch.from_numpy(a) for a in
                                    (codes, lo, cnt, vbits)),
                                  [torch.from_numpy(p) for p in planes])
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    hit = tc.numpy() > 0
    assert hit.any() == (case == "31_columns")
    assert np.array_equal(tv.numpy()[hit], np.asarray(jv)[hit])
    assert not tv.numpy()[~hit].any()
    for a, b in zip(tps, jp):
        assert np.array_equal(a.numpy()[hit], np.asarray(b)[hit])
        assert not a.numpy()[~hit].any()


def test_direct_probe_empty_build():
    """A build without rows: counts come from the tables, everything
    gathered is zero. (The Pallas kernel cannot take an empty build; the
    join-level test below holds the same case against presto_tpu.)"""
    rng = np.random.default_rng(29)
    lo, _ = _tables(rng)
    codes = _codes(rng, 5000)
    payload = [torch.zeros(0, dtype=torch.bool),
               torch.zeros((0, 2), dtype=torch.int64)]
    cnt, vb, outs = TP.direct_probe(
        torch.from_numpy(codes), torch.from_numpy(lo),
        torch.zeros(lo.shape[0], dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), payload)
    assert not cnt.any() and not vb.any()
    assert [tuple(o.shape) for o in outs] == [(5000,), (5000, 2)]
    assert not any(o.any() for o in outs)


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_lookup_join_direct_empty_build_matches_presto_tpu(jt):
    build = Batch.from_pydict({"k": (T.BIGINT, []), "v": (T.INTEGER, []),
                               "b": (T.BOOLEAN, [])})
    probe = Batch.from_pydict({"p": (T.BIGINT, [1, 2, None, 4, -3])})
    want = J.lookup_join(probe, build, [0], [0], [1, 2], ["v", "b"], jt)
    tb, tp = to_port(build), to_port(probe)
    got = TP.lookup_join_direct(tp, tb, [0], [0], [1, 2], ["v", "b"], jt,
                                TJ.prepare_direct(tb, [0], 1, 64))
    assert sorted_rows(got) == sorted_rows(want)


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_lookup_join_direct_int128_and_bool_ragged_lanes(force_pallas, jt):
    """int128 and 1-byte payload columns at 3 * 1024 + 517 probe lanes: no
    multiple of the CUDA kernel's 1024 lanes a block or 4 a thread."""
    build, _ = _zoo(n=300, seed=31)
    rng = np.random.default_rng(31)
    probe = Batch.from_pydict({
        "p": (T.BIGINT, rng.integers(-3, 304, 3 * 1024 + 517).tolist())})
    payload, names = [4, 6], ["b", "dec"]
    want = PJ.lookup_join_direct(probe, build, [0], [0], payload, names, jt,
                                 J.prepare_direct(build, [0], 1, 512))
    tb, tp = to_port(build), to_port(probe)
    got = TP.lookup_join_direct(tp, tb, [0], [0], payload, names, jt,
                                TJ.prepare_direct(tb, [0], 1, 512))
    assert sorted_rows(got) == sorted_rows(want)


def _mixed_payload(rng, rows, ncols):
    """Payload columns cycling through the widths the kernel gathers:
    bool (1 byte), int32, int64, float64 and int128 (two int64 limbs)."""
    cols = []
    for c in range(ncols):
        kind = c % 5
        i64 = rng.integers(-(1 << 62), 1 << 62, rows, dtype=np.int64)
        if kind == 0:
            cols.append(torch.from_numpy(rng.random(rows) < 0.5))
        elif kind == 1:
            cols.append(torch.from_numpy(i64 >> 33).to(torch.int32))
        elif kind == 2:
            cols.append(torch.from_numpy(i64))
        elif kind == 3:
            cols.append(torch.from_numpy(i64.astype(np.float64) * 1e-9))
        else:
            cols.append(torch.from_numpy(np.stack([i64 >> 3, i64], 1)))
    return cols


def _kernel_edge_case(name):
    """(codes, lo, cnt, vbits, payload) tensors of one kernel edge case."""
    rng = np.random.default_rng(37)
    lo, cnt = _tables(rng)
    n, ncols, rows = 5000, 5, 3000
    codes = _codes(rng, n)
    if name == "all_lanes_dead":
        codes[:] = -1
    elif name == "empty_build":
        cnt[:] = 0
        rows = 0
    elif name == "31_columns":
        codes, ncols = _codes(rng, 9000), 31
    else:
        assert name == "int128_and_bool_ragged"
        codes = _codes(rng, 3 * 1024 + 517)
    payload = _mixed_payload(rng, 3000, ncols)
    if name == "int128_and_bool_ragged":
        payload = [payload[0], payload[4]]
    vbits = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    return ([torch.from_numpy(a) for a in (codes, lo, cnt, vbits[:rows])],
            [p[:rows] for p in payload])


def _bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(gpu):
    build, probe = _zoo(n=3000, seed=4)
    tb, tp = to_port(build, gpu), to_port(probe, gpu)
    prep = TJ.prepare_direct(tb, [0], 1, 4096)
    before = TP.launches
    got = TP.lookup_join_direct(tp, tb, [0], [0], PAYLOAD, NAMES, "left",
                                prep)
    torch.cuda.synchronize()
    assert TP.launches == before + 1
    want = TJ.lookup_join(tp, tb, [0], [0], PAYLOAD, NAMES, "left",
                          prepared=prep)
    assert sorted_rows(got) == sorted_rows(want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_lanes_dead", "empty_build",
                                  "31_columns", "int128_and_bool_ragged"])
def test_cuda_kernel_edge_cases(gpu, case):
    tables, payload = _kernel_edge_case(case)
    tables = [t.to(gpu) for t in tables]
    payload = [p.to(gpu) for p in payload]
    got = TP.direct_probe(*tables, payload)
    want = TP.direct_probe_plain(*tables, payload)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(_bits(a), _bits(b))
