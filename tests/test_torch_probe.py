"""The port's direct-address probe (presto_tpu_torch/ops/probe.py)
against presto_tpu's Pallas probe kernel in interpret mode
(FORCE_PALLAS_PROBE monkeypatched on, as tests/test_join_strategy.py
does): the same seeded batches through both, identical rows across the
payload dtype zoo, with NULL and out-of-domain lanes.

On the CPU the port's wrapper runs its plain version; the ``cuda``-marked
test holds the CUDA kernel against it on a GPU.
"""
import decimal

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
