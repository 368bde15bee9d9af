"""Helpers shared by the tests that hold presto_tpu_torch against
presto_tpu: carrying a JAX batch into the port, and comparing rows."""
import math

import numpy as np

from presto_tpu_torch import types as PT
from presto_tpu_torch.batch import Batch as TBatch, Schema as TSchema


def port_type(t):
    """The port's type object for a presto_tpu type."""
    return PT.parse_type(t.display())


def to_port(jbatch, device="cpu") -> TBatch:
    """The same batch (capacity, padding lanes, vocabularies) in the port."""
    schema = TSchema([(f.name, port_type(f.type))
                      for f in jbatch.schema.fields])
    return TBatch.from_numpy(
        schema, [np.asarray(c.data) for c in jbatch.columns],
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


def assert_results_match(got, want, rel: float = 1e-12):
    """Two QueryResults agree: the same column names and type displays,
    and the same rows in the same order (``assert_rows_match``)."""
    assert got.names == want.names
    assert [t.display() for t in got.types] == \
        [t.display() for t in want.types]
    assert_rows_match(got.rows, want.rows, rel)
