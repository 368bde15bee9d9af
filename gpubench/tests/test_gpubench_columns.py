"""The reference's regenerated columns equal the engine's generators bit
for bit (on the CPU), and the card computes them as the CPU does."""
import numpy as np
import pytest
import torch

from gpubench.reference.tpch import tables as h

SF = 0.05      # 300 k lineitem rows


def _engine_lineitem():
    from presto_tpu_torch.connectors import tpch
    gen = tpch._Gen(SF)
    okeys = np.arange(1, tpch._rows("orders", SF) + 1, dtype=np.int64)
    counts = tpch._lines_per_order(okeys)
    ok = np.repeat(okeys, counts)
    ln = np.arange(len(ok)) - np.repeat(np.cumsum(counts) - counts, counts)
    cols = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate")
    return {c: v for c, (v, _) in gen.lineitem(ok, ln, cols).items()}


def _same(a: torch.Tensor, b) -> None:
    a = a.cpu().numpy()
    b = np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.int64), b.astype(np.float64)
                              .view(np.int64))
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def test_lineitem_equals_the_engines_generator():
    ref = h.Data(SF, "cpu").lineitem()
    eng = _engine_lineitem()
    for r, e in (("quantity", "l_quantity"),
                 ("extendedprice", "l_extendedprice"),
                 ("discount", "l_discount"), ("tax", "l_tax"),
                 ("returnflag", "l_returnflag"),
                 ("linestatus", "l_linestatus"), ("shipdate", "l_shipdate")):
        _same(ref[r], eng[e])


@pytest.mark.cuda
def test_the_card_regenerates_the_cpus_columns(cuda_device):
    cpu = h.Data(SF, "cpu").lineitem()
    card = h.Data(SF, cuda_device).lineitem()
    for name in cpu:
        _same(card[name], cpu[name].numpy())
