"""Join operator parity for non-unique and membership joins:
presto_tpu_torch's ops/join.py against presto_tpu's on the same seeded
batches, over a sorted build (one and two keys) and a direct-address
build, with NULL keys and dead rows on both sides. Masks and ranks must
be identical lane for lane; expanded joins row for row in lane order."""
import numpy as np
import pytest

from presto_tpu import types as T
from presto_tpu.batch import Batch
from presto_tpu.ops import join as J
from presto_tpu_torch.ops import join as TJ

from torch_parity import to_port


def _inputs(seed=7):
    """A build with repeated keys (multiplicity up to 5), NULL keys and a
    dead row; a probe with NULL keys, misses and dead rows."""
    rng = np.random.default_rng(seed)
    n = 240
    k = rng.integers(0, 60, n).tolist()
    for i in (5, 17, 99):
        k[i] = None
    build = Batch.from_pydict({
        "k": (T.BIGINT, k),
        "k2": (T.BIGINT, rng.integers(0, 3, n).tolist()),
        "v": (T.DOUBLE, rng.standard_normal(n).tolist()),
        "s": (T.VARCHAR, [f"w{i % 7}" if i % 9 else None for i in range(n)])})
    build = Batch(build.schema, build.columns,
                  build.row_mask.at[40].set(False))
    pk = rng.integers(-5, 70, 500).tolist()
    pk[3] = pk[11] = None
    probe = Batch.from_pydict({"p": (T.BIGINT, pk),
                               "p2": (T.BIGINT, rng.integers(0, 3, 500)
                                      .tolist()),
                               "q": (T.INTEGER, list(range(500)))})
    probe = Batch(probe.schema, probe.columns,
                  probe.row_mask.at[8].set(False))
    return build, probe


def _prepared(kind, build, tb):
    if kind == "direct":
        return J.prepare_direct(build, [0], 0, 64), \
            TJ.prepare_direct(tb, [0], 0, 64)
    keys = [0] if kind == "sorted" else [0, 1]
    return J.prepare_build(build, keys), TJ.prepare_build(tb, keys)


KINDS = ["sorted", "direct", "sorted_two_keys"]


def _keys(kind):
    return ([0, 1], [0, 1]) if kind == "sorted_two_keys" else ([0], [0])


@pytest.fixture(scope="module")
def inputs():
    build, probe = _inputs()
    return build, probe, to_port(build), to_port(probe)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("jt", ["inner", "left"])
def test_expand_join(inputs, kind, jt):
    build, probe, tb, tp = inputs
    jprep, tprep = _prepared(kind, build, tb)
    pk, bk = _keys(kind)
    k = int(J.match_count_max(probe, build, pk, bk, jprep))
    assert int(TJ.match_count_max(tp, tb, pk, bk, tprep)) == k > 1
    want = J.expand_join(probe, build, pk, bk, [2, 3], ["v", "s"], jt, k,
                         jprep)
    got = TJ.expand_join(tp, tb, pk, bk, [2, 3], ["v", "s"], jt, k, tprep)
    assert np.array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("kind", KINDS)
def test_multiplicity_and_ranks(inputs, kind):
    build, probe, tb, tp = inputs
    jprep, tprep = _prepared(kind, build, tb)
    pk, bk = _keys(kind)
    assert int(TJ.max_multiplicity(tprep)) == int(J.max_multiplicity(jprep))
    if kind != "direct":
        assert np.array_equal(TJ.build_key_ranks(tb, bk, tprep).numpy(),
                              np.asarray(J.build_key_ranks(build, bk, jprep)))


@pytest.mark.parametrize("kind", KINDS)
def test_build_match_masks(inputs, kind):
    build, probe, tb, tp = inputs
    jprep, tprep = _prepared(kind, build, tb)
    pk, bk = _keys(kind)
    want = J.build_match_mask(probe, build, pk, bk, jprep)
    got = TJ.build_match_mask(tp, tb, pk, bk, tprep)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    survived = np.arange(probe.capacity) % 3 != 0
    import torch
    want = J.unique_match_build_mask(probe, build, pk, bk, survived, jprep)
    got = TJ.unique_match_build_mask(tp, tb, pk, bk,
                                     torch.from_numpy(survived), tprep)
    assert np.array_equal(got.numpy(), np.asarray(want))
    jorig, jm = J.expand_match_origins(probe, build, pk, bk, 4, jprep)
    torig, tm = TJ.expand_match_origins(tp, tb, pk, bk, 4, tprep)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(torig.numpy()[tm.numpy()],
                          np.asarray(jorig)[np.asarray(jm)])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("negated,null_aware", [
    (False, True), (True, True), (False, False), (True, False)])
@pytest.mark.parametrize("build_case", ["with_nulls", "no_nulls", "empty"])
def test_semi_join_mask(inputs, kind, negated, null_aware, build_case):
    build, probe, _, tp = inputs
    mask = np.asarray(build.row_mask)
    if build_case == "no_nulls":
        mask = mask & np.asarray(build.columns[0].validity)
    elif build_case == "empty":
        mask = np.zeros_like(mask)
    build = Batch(build.schema, build.columns, mask)
    tb = to_port(build)
    jprep, tprep = _prepared(kind, build, tb)
    pk, bk = _keys(kind)
    want = J.semi_join_mask(probe, build, pk, bk, negated, null_aware, jprep)
    got = TJ.semi_join_mask(tp, tb, pk, bk, negated, null_aware, tprep)
    assert np.array_equal(got.numpy(), np.asarray(want))
