"""Helpers shared by the tests that hold presto_tpu_torch against
presto_tpu: carrying a JAX batch into the port, and comparing rows and
batches.

Importing this module sets torch's CPU thread pool to one thread. The
suite runs in several worker processes at once, and the port's tests
call torch on small tensors: a full OpenMP pool in every worker spins
between those calls and takes the cores the JAX side compiles on
(measured on an 8-core host, five workers: the parity files took 149 s
with the default pool and 83 s with one thread)."""
import math

import numpy as np
import torch

from presto_tpu_torch import types as PT
from presto_tpu_torch.batch import Batch as TBatch, Schema as TSchema

torch.set_num_threads(1)


def port_type(t):
    """The port's type object for a presto_tpu type."""
    return PT.parse_type(t.display())


def _host(data):
    """A JAX column's data as numpy: one array, or the tuple of an ARRAY
    or MAP column; long decimals stay [cap, 2] limb pairs."""
    if isinstance(data, tuple):
        return tuple(np.asarray(a) for a in data)
    return np.asarray(data)


def to_port(jbatch, device="cpu") -> TBatch:
    """The same batch (capacity, padding lanes, vocabularies) in the port,
    long-decimal limb pairs and ARRAY / MAP tuple columns included."""
    schema = TSchema([(f.name, port_type(f.type))
                      for f in jbatch.schema.fields])
    return TBatch.from_numpy(
        schema, [_host(c.data) for c in jbatch.columns],
        [np.asarray(c.validity) for c in jbatch.columns],
        np.asarray(jbatch.row_mask),
        [c.dictionary for c in jbatch.columns], device=device)


def assert_rows_match(a, b, rel: float):
    """Same rows in the same order; doubles within ``rel``, everything
    else exactly."""
    assert len(a) == len(b), (len(a), len(b))
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb)
        for u, v in zip(ra, rb):
            if isinstance(u, float) and u is not None:
                assert v is not None and (
                    math.isclose(u, v, rel_tol=rel, abs_tol=0.0)
                    or (math.isnan(u) and math.isnan(v))), (i, u, v)
            else:
                assert u == v, (i, u, v)


def sorted_rows(batch):
    def key(t):
        return tuple((v is None, str(type(v)), v) for v in t)
    return sorted([tuple(r) for r in batch.to_pylist()], key=key)


def assert_results_match(got, want, rel: float = 1e-12, retyped=None):
    """Two QueryResults agree: the same column names and type displays,
    and the same rows in the same order (``assert_rows_match``).

    ``retyped`` names the columns whose types differ by design: column
    index -> (the reference's display, the port's display). The port
    types an integer literal as Presto does (INTEGER where it fits in
    32 bits) and the reference types every one BIGINT, so a column of
    literals is ``("bigint", "integer")``. Both displays are asserted;
    every other column's display must be equal."""
    assert got.names == want.names
    want_types = [t.display() for t in want.types]
    for i, (ref_type, port_type) in (retyped or {}).items():
        assert want_types[i] == ref_type, (i, want_types[i])
        want_types[i] = port_type
    assert [t.display() for t in got.types] == want_types
    assert_rows_match(got.rows, want.rows, rel)


def _live(data, valid, mask):
    """(live values with NULL lanes zeroed, validity) of one column as
    exact bit patterns."""
    data = np.asarray(data)
    valid = np.asarray(valid)[mask]
    live = data[mask].copy()
    live[~valid] = 0
    if live.dtype.kind == "f":
        live = live.view(np.int64 if live.itemsize == 8 else np.int32)
    return live, valid


def assert_batches_equal(jbatch, tbatch, skip=()):
    """The port's batch holds the reference's live rows exactly:
    schema, validity, data bits, vocabularies and codes."""
    assert [f.name for f in tbatch.schema.fields] == \
        [f.name for f in jbatch.schema.fields]
    assert [f.type.display() for f in tbatch.schema.fields] == \
        [f.type.display() for f in jbatch.schema.fields]
    jm = np.asarray(jbatch.row_mask)
    tm = tbatch.row_mask.numpy()
    assert np.array_equal(jm, tm)
    for f, jc, tc in zip(tbatch.schema.fields, jbatch.columns,
                         tbatch.columns):
        if f.name in skip:
            continue
        jd, jv = _live(jc.data, jc.validity, jm)
        td, tv = _live(tc.data.numpy(), tc.validity.numpy(), tm)
        assert np.array_equal(jv, tv), f.name
        assert np.array_equal(jd, td), f.name
        assert tc.dictionary == jc.dictionary, f.name
