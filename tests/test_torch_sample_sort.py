"""``repro_torch.core.sample_sort`` against ``repro.core.sample_sort``: the
exchange cost model, the host sample sort, ``imbalance`` and the schedule
comparison, each with ``==``."""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import sample_sort as J
from repro.core.ohhc_sort import LinkModel as JLinkModel
from repro.core.topology import OHHCTopology as JTopology
from repro_torch.core import sample_sort as T
from repro_torch.core.ohhc_sort import LinkModel
from repro_torch.core.topology import OHHCTopology
from repro_torch.data import make_array

LINKS = [(50.0, 25.0, 1.0), (100.0, 12.5, 3.0)]


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("devices,pods", [(1, 1), (8, 1), (36, 6), (144, 2), (512, 2)])
@pytest.mark.parametrize("itemsize", [1, 4, 8])
def test_exchange_model(link, devices, pods, itemsize):
    got = T.ExchangeModel(LinkModel(*link)).all_to_all_time_s(15_728_640, itemsize, devices, pods)
    want = J.ExchangeModel(JLinkModel(*link)).all_to_all_time_s(15_728_640, itemsize, devices, pods)
    assert got == want


@pytest.mark.parametrize("dist", ["random", "sorted", "dupes", "local"])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "int64"])
@pytest.mark.parametrize("shards", [1, 4, 36])
def test_sample_sort_host(dist, dtype, shards):
    x = make_array(dist, 5_000, seed=11, dtype=np.dtype(dtype))
    got, got_split = T.sample_sort_host(x, shards, oversample=16)
    want, want_split = J.sample_sort_host(x, shards, oversample=16)
    assert np.array_equal(got_split, want_split)
    assert len(got) == len(want) == shards
    assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    assert np.array_equal(np.concatenate(got), np.sort(x))


@pytest.mark.parametrize("sizes", [[5, 5, 5], [1, 9, 2], [0, 0, 4], [0, 0, 0], [7]])
def test_imbalance(sizes):
    got, want = T.imbalance(np.array(sizes)), J.imbalance(np.array(sizes))
    assert got == want or (np.isinf(got) and np.isinf(want))


@pytest.mark.parametrize("d_h,variant", [(1, "full"), (2, "full"), (3, "full"), (1, "half")])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_compare_schedules(d_h, variant, itemsize):
    got = T.compare_schedules(OHHCTopology(d_h, variant), 15_728_640, itemsize, LinkModel(40.0, 10.0, 2.0))
    want = J.compare_schedules(JTopology(d_h, variant), 15_728_640, itemsize, JLinkModel(40.0, 10.0, 2.0))
    assert got == want
