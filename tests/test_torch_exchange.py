"""The mesh collectives of presto_tpu_torch (parallel/exchange.py)
against presto_tpu's inside one ``shard_map`` over the eight virtual CPU
devices of tests/conftest.py.

The same seeded batch (bigint, double, varchar, date, long decimal and
boolean columns with NULLs, dead lanes scattered through every shard)
goes through the JAX collective on a mesh of 8 devices and through the
port's on a list of 8 CPU slots; every shard's output is compared lane
for lane: row mask, validity, data (dead lanes included) and
vocabulary."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from presto_tpu import types as JT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.parallel import exchange as jx
from presto_tpu_torch.parallel import exchange as tx
from presto_tpu_torch.parallel.mesh import Mesh, make_mesh

try:                                    # jax >= 0.6
    from jax import shard_map
    _CHECK = {"check_vma": False}
except ImportError:                     # jax 0.4.x
    from jax.experimental.shard_map import shard_map
    _CHECK = {"check_rep": False}

from torch_parity import to_port

N = 8
SEED = 20261017
KEYS = [0, 2]                      # bigint + varchar


def _jax_mesh():
    devs = jax.devices()
    assert len(devs) >= N, "tests/conftest.py gives 8 CPU devices"
    return JMesh(np.array(devs[:N]), ("dp",))


def _seeded(rows: int = 1000, seed: int = SEED) -> JBatch:
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]

    def maybe(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    data = {
        "k": (JT.BIGINT, maybe([int(x) for x in
                                rng.integers(-50, 50, rows)])),
        "d": (JT.DOUBLE, maybe([float(x) for x in
                                rng.normal(0, 100, rows)])),
        "s": (JT.VARCHAR, maybe([words[int(i)] for i in
                                 rng.integers(0, 7, rows)])),
        "t": (JT.DATE, maybe([int(x) for x in
                              rng.integers(9000, 11000, rows)])),
        "m": (JT.parse_type("decimal(30,2)"),
              maybe([int(x) * 10**20 + 7 for x in
                     rng.integers(-9, 9, rows)])),
        "b": (JT.BOOLEAN, maybe([bool(x) for x in
                                 rng.integers(0, 2, rows)])),
    }
    b = JBatch.from_pydict(data)
    assert b.capacity == 1024
    # dead lanes inside every shard, not only the padding at the end
    keep = rng.random(b.capacity) > 0.15
    return JBatch(b.schema, b.columns, b.row_mask & jax.numpy.asarray(keep))


def _slots(jb: JBatch):
    """The port's slot list: shard i of the same batch on slot i."""
    mesh = Mesh("dp", tuple([torch.device("cpu")] * N))
    return tx.shard_batch(to_port(jb), mesh)


def _jax_shards(jout: JBatch, n: int = N):
    """Per-shard views of a JAX batch whose arrays are row-sharded."""
    out = []
    cap = jout.capacity // n
    for i in range(n):
        out.append((np.asarray(jout.row_mask)[i * cap:(i + 1) * cap],
                    [(np.asarray(c.data)[i * cap:(i + 1) * cap],
                      np.asarray(c.validity)[i * cap:(i + 1) * cap],
                      c.dictionary) for c in jout.columns]))
    return out


def _assert_shards_equal(jout: JBatch, touts):
    want = _jax_shards(jout)
    assert len(touts) == len(want)
    for i, (tb, (mask, cols)) in enumerate(zip(touts, want)):
        np.testing.assert_array_equal(tb.row_mask.numpy(), mask,
                                      err_msg=f"shard {i} mask")
        for ci, (tc, (d, v, vocab)) in enumerate(zip(tb.columns, cols)):
            np.testing.assert_array_equal(tc.validity.numpy(), v,
                                          err_msg=f"shard {i} col {ci}")
            td = tc.data.numpy()
            if d.dtype.kind == "f":
                td, d = td.view(np.int64), d.view(np.int64)
            np.testing.assert_array_equal(td, d,
                                          err_msg=f"shard {i} col {ci}")
            assert tc.dictionary == vocab


def _smap(fn, n_in=1, n_out=1):
    spec = P("dp")
    outs = spec if n_out == 1 else tuple([spec] * n_out)
    return jax.jit(shard_map(fn, mesh=_jax_mesh(),
                             in_specs=tuple([spec] * n_in),
                             out_specs=outs, **_CHECK))


def _pids(seed: int = 7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, 1024).astype(np.int32)


def test_all_to_all_delivers_row_i_of_every_sender():
    sends = [torch.arange(N * 3).reshape(N, 3) + 100 * j for j in range(N)]
    got = tx.all_to_all(sends, [torch.device("cpu")] * N)
    for i in range(N):
        for j in range(N):
            assert torch.equal(got[i][j], sends[j][i])


def test_repartition_by_hash():
    jb = _seeded()
    want = _smap(lambda b: jx.repartition_by_hash(b, KEYS, "dp", N))(jb)
    _assert_shards_equal(want, tx.repartition_by_hash(_slots(jb), KEYS, N))


def test_repartition_by_ids():
    jb = _seeded()
    pid = _pids()
    want = _smap(lambda b, p: jx.repartition_by_ids(b, p, "dp", N),
                 n_in=2)(jb, jax.numpy.asarray(pid))
    tp = [torch.from_numpy(pid[i * 128:(i + 1) * 128]) for i in range(N)]
    _assert_shards_equal(want, tx.repartition_by_ids(_slots(jb), tp, N))


@pytest.mark.parametrize("keys", [[0], [2], [4], [0, 2, 3]],
                         ids=["bigint", "varchar", "long_decimal",
                              "mixed"])
def test_partition_counts(keys):
    jb = _seeded()
    want = np.asarray(_smap(
        lambda b: jx.partition_counts(b, keys, N))(jb)).reshape(N, N)
    got = [tx.partition_counts(s, keys, N).numpy() for s in _slots(jb)]
    np.testing.assert_array_equal(np.stack(got), want)


def _quota(jb, keys):
    counts = np.asarray(_smap(
        lambda b: jx.partition_counts(b, keys, N))(jb)).reshape(N, N)
    return int(counts.max())


def test_repartition_by_hash_compact():
    jb = _seeded()
    q = _quota(jb, KEYS)
    want = _smap(lambda b: jx.repartition_by_hash_compact(
        b, KEYS, "dp", N, q))(jb)
    _assert_shards_equal(want, tx.repartition_by_hash_compact(
        _slots(jb), KEYS, N, q))


ASSIGN = tuple((b * 3 + 1) % N for b in range(N * 4))


def test_repartition_by_buckets_compact():
    jb = _seeded()
    want = _smap(lambda b: jx.repartition_by_buckets_compact(
        b, KEYS, "dp", N, ASSIGN, 128))(jb)
    _assert_shards_equal(want, tx.repartition_by_buckets_compact(
        _slots(jb), KEYS, N, ASSIGN, 128))


def test_repartition_by_pids_compact():
    jb = _seeded()
    pid = _pids(11)
    want = _smap(lambda b, p: jx.repartition_by_pids_compact(
        b, p, "dp", N, 64), n_in=2)(jb, jax.numpy.asarray(pid))
    tp = [torch.from_numpy(pid[i * 128:(i + 1) * 128]) for i in range(N)]
    _assert_shards_equal(want, tx.repartition_by_pids_compact(
        _slots(jb), tp, N, 64))


def test_repartition_fused():
    jb = _seeded()
    want_b, want_c = _smap(lambda b: jx.repartition_fused(
        b, KEYS, "dp", N, ASSIGN, 128), n_out=2)(jb)
    got_b, got_c = tx.repartition_fused(_slots(jb), KEYS, N, ASSIGN, 128)
    _assert_shards_equal(want_b, got_b)
    np.testing.assert_array_equal(
        np.concatenate([c.numpy() for c in got_c]), np.asarray(want_c))


def test_broadcast_batch():
    jb = _seeded()
    want = _smap(lambda b: jx.broadcast_batch(b, "dp"))(jb)
    _assert_shards_equal(want, tx.broadcast_batch(_slots(jb)))


def test_local_shard_and_shard_batch():
    jb = _seeded()
    tb = to_port(jb)
    for i in range(N):
        w = jx.local_shard(jb, i, N)
        g = tx.local_shard(tb, i, N)
        np.testing.assert_array_equal(g.row_mask.numpy(),
                                      np.asarray(w.row_mask))
        for gc, wc in zip(g.columns, w.columns):
            np.testing.assert_array_equal(gc.data.numpy(),
                                          np.asarray(wc.data))
    shards = tx.shard_batch(tb, Mesh("dp", (torch.device("cpu"),) * N))
    assert [s.capacity for s in shards] == [128] * N


def test_make_mesh_slots(monkeypatch):
    """One CPU is one slot unless PRESTO_TPU_TORCH_MESH_SLOTS repeats it;
    asking for more slots than are visible raises, as make_mesh does in
    presto_tpu past its devices."""
    monkeypatch.delenv("PRESTO_TPU_TORCH_MESH_SLOTS", raising=False)
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "8")
    m = make_mesh(device="cpu")
    assert m.size == 8 and m.axis == "dp"
    assert make_mesh(4, device="cpu").devices == (torch.device("cpu"),) * 4


def test_vocabularies_merge_across_senders():
    """Senders whose string column carries different vocabularies: every
    receiver gets one merged vocabulary, and the rows keep their
    strings."""
    a = JBatch.from_pydict({"s": (JT.VARCHAR, ["x", "y", None, "z"])})
    b = JBatch.from_pydict({"s": (JT.VARCHAR, ["z", "w", "x", "y"])})
    slots = [to_port(a), to_port(b)]
    assert slots[0].columns[0].dictionary != slots[1].columns[0].dictionary
    out = tx.repartition_by_hash(slots, [0], 2)
    assert out[0].columns[0].dictionary == out[1].columns[0].dictionary
    rows = sorted(map(repr, [r for o in out for r in o.to_pylist()]))
    want = sorted(map(repr, a.to_pylist() + b.to_pylist()))
    assert rows == want


def test_vectorized_vocabulary_hash_equals_the_scalar_one():
    vocab = ("", "a", "ALGERIA", "Supplier#000000001", "ñandú", "x" * 300,
             "special requests")
    got = tx._fnv1a64_np(vocab)
    assert [int(v) for v in got] == [tx._fnv1a64(s) for s in vocab]
    table = tx._vocab_hash_table(vocab, torch.device("cpu"))
    assert table is not tx._vocab_hash_table(vocab, torch.device("cpu"))
    assert table[-1].item() == 0 and table.shape == (len(vocab) + 1,)
