"""presto_tpu_torch/ops/sketch.py against presto_tpu/ops/sketch.py on the
same seeded inputs: splitmix64, the HLL buckets, ranks, registers and
estimates, the string and numeric column hashes, and the quantile
histogram's bins, counts and estimates (NaN in the top bin). Both
sketches are deterministic given the hash, so every comparison is exact
(bit for bit); nothing here has a tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.ops import sketch as J
from presto_tpu_torch.ops import sketch as P

import torch_parity  # noqa: F401  (one torch thread)

SEED = 20261017


def _rng(k=0):
    return np.random.default_rng(SEED + k)


def _int64(n, k=0):
    x = _rng(k).integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    x[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    return x


def _ref_bits(a) -> np.ndarray:
    """A JAX result's bits as a writable int64 copy (torch wants one)."""
    return np.array(a).view(np.int64)


def test_splitmix64_bit_exact():
    x = _int64(50_000)
    assert np.array_equal(_ref_bits(J.splitmix64(jnp.asarray(x))),
                          P.splitmix64(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("m", [16, 512, 2048, 65536])
def test_bucket_and_rank_bit_exact(m):
    h = _ref_bits(J.splitmix64(jnp.asarray(_int64(50_000, 1))))
    bj, rj = J.bucket_and_rank(jnp.asarray(h.view(np.uint64)), m)
    bp, rp = P.bucket_and_rank(torch.from_numpy(h), m)
    assert np.array_equal(np.asarray(bj), bp.numpy())
    assert np.array_equal(np.asarray(rj), rp.numpy())


@pytest.mark.parametrize("error", [None, 0.0040625, 0.05, 0.26])
def test_hll_m_matches(error):
    assert P.hll_m(error) == J.hll_m(error)


@pytest.mark.parametrize("error", [0.001, 0.3])
def test_hll_m_range(error):
    with pytest.raises(ValueError):
        P.hll_m(error)


@pytest.mark.parametrize("groups,m", [(1, 2048), (7, 512), (64, 16)])
def test_hll_update_and_estimate_exact(groups, m):
    n = 40_000
    rng = _rng(groups)
    h = _ref_bits(J.splitmix64(jnp.asarray(
        rng.integers(0, n // 3, n, dtype=np.int64))))
    gid = rng.integers(0, groups, n)
    valid = rng.random(n) < 0.9
    rj = J.hll_update(jnp.asarray(gid), jnp.asarray(valid),
                      jnp.asarray(h), groups, m)
    rp = P.hll_update(torch.from_numpy(gid), torch.from_numpy(valid),
                      torch.from_numpy(h), groups, m)
    assert np.array_equal(np.asarray(rj), rp.numpy())
    assert np.array_equal(np.asarray(J.hll_estimate(rj)),
                          P.hll_estimate(rp).numpy())


def test_hll_estimate_small_and_empty_registers():
    regs = np.zeros((3, 64), dtype=np.int32)
    regs[1, :5] = 3
    regs[2] = _rng(3).integers(1, 20, 64)
    assert np.array_equal(np.asarray(J.hll_estimate(jnp.asarray(regs))),
                          P.hll_estimate(torch.from_numpy(regs)).numpy())


def test_string_column_hash_exact():
    vocab = tuple(f"value-{i}-{'x' * (i % 7)}" for i in range(300)) + (
        "", "ünïcode", "a" * 500)
    codes = _rng(4).integers(0, len(vocab), 20_000).astype(np.int32)
    want = _ref_bits(J.hashed_column(jnp.asarray(codes), vocab))
    got = P.hashed_column(torch.from_numpy(codes), vocab).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(_ref_bits(J.hash_dictionary(vocab)),
                          P.hash_dictionary(vocab))


@pytest.mark.parametrize("kind", ["int32", "int64", "float64", "bool",
                                  "limbs"])
def test_numeric_column_hash_exact(kind):
    rng = _rng(5)
    if kind == "int32":
        x = rng.integers(-2**31, 2**31 - 1, 10_000).astype(np.int32)
    elif kind == "int64":
        x = _int64(10_000, 6)
    elif kind == "float64":
        x = rng.normal(size=10_000) * 1e6
        x[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    elif kind == "bool":
        x = rng.random(10_000) < 0.5
    else:
        x = np.stack([_int64(10_000, 7), _int64(10_000, 8)], axis=1)
    want = _ref_bits(J.hashed_column(jnp.asarray(x), None))
    assert np.array_equal(want, P.hashed_column(torch.from_numpy(x),
                                                None).numpy())


def _qd_values(n, k):
    rng = _rng(k)
    v = np.concatenate([rng.normal(size=n // 2) * 1e4,
                        rng.lognormal(0, 8, n - n // 2)])
    v[:8] = [0.0, -0.0, np.nan, 1e-300, 1024.0, -1024.0, 3.0e38, np.nan]
    return v


def test_qd_bin_exact():
    v = _qd_values(30_000, 9)
    assert np.array_equal(np.asarray(J.qd_bin(jnp.asarray(v))),
                          P.qd_bin(torch.from_numpy(v)).numpy())
    assert np.array_equal(J.qd_rep_values(), P.qd_rep_values())


@pytest.mark.parametrize("p", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_qd_update_and_estimate_exact(p):
    v = _qd_values(30_000, 10)
    valid = _rng(11).random(v.shape[0]) < 0.95
    cj = J.qd_update(jnp.asarray(valid), jnp.asarray(v))
    cp = P.qd_update(torch.from_numpy(valid), torch.from_numpy(v))
    assert np.array_equal(np.asarray(cj), cp.numpy())
    vj, okj = J.qd_estimate(cj, p)
    vp, okp = P.qd_estimate(cp, p)
    assert np.array_equal(np.asarray(vj), vp.numpy(), equal_nan=True)
    assert bool(okj) == bool(okp)


def test_qd_nan_sorts_last():
    """NaN lands in the top bin, as the exact drain sorts it last."""
    v = np.array([1.0, 2.0, np.nan, np.nan])
    counts = P.qd_update(torch.ones(4, dtype=torch.bool),
                         torch.from_numpy(v))
    assert int(counts[-1]) == 2 and int(counts.sum()) == 4
    ref = J.qd_update(jnp.ones(4, dtype=bool), jnp.asarray(v))
    for p in (0.25, 0.5, 1.0):
        assert float(P.qd_estimate(counts, p)[0]) == float(
            np.asarray(J.qd_estimate(ref, p)[0]))


def test_qd_empty_is_invalid():
    counts = P.qd_update(torch.zeros(3, dtype=torch.bool),
                         torch.ones(3, dtype=torch.float64))
    _, ok = P.qd_estimate(counts, 0.5)
    assert not bool(ok)
