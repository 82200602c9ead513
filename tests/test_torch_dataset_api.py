"""The DSL's result emitter and the plain datasets' record surface, through
dampr_tpu_torch against the JAX package.

``ValueEmitter`` iterates like the JAX package's; the base ``Dataset``
iterates and groups consecutive equal keys (``grouped_read``), and a
``BlockDataset`` concatenates its blocks (``concat``).  The same seeded
records go through both packages.  Tolerance: exact.
"""

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import dataset as ref_dataset
from dampr_tpu.blocks import Block as RefBlock
from dampr_tpu_torch import dataset as port_dataset
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.blocks import Block as PortBlock


@pytest.fixture(autouse=True)
def knobs():
    old = port_settings.device
    port_settings.device = "cpu"
    yield
    port_settings.device = old


def _records(seed=21, n=40):
    rng = np.random.RandomState(seed)
    keys = sorted(rng.randint(0, 9, n).tolist())
    return list(zip(keys, rng.randint(0, 1000, n).tolist()))


def test_value_emitter_iterates_like_the_jax_package():
    want = list(dampr_tpu.Dampr.memory([3, 1, 2]).run())
    assert want == [3, 1, 2]
    assert list(dampr_tpu_torch.Dampr.memory([3, 1, 2]).run()) == want
    items = np.random.RandomState(3).randint(0, 100, 50).tolist()
    assert (list(dampr_tpu_torch.Dampr.memory(items).map(lambda x: x * 2)
                 .run())
            == list(dampr_tpu.Dampr.memory(items).map(lambda x: x * 2)
                    .run()))


def test_dataset_iter_is_its_read():
    recs = _records()
    assert (list(port_dataset.MemoryDataset(recs))
            == list(ref_dataset.MemoryDataset(recs)) == recs)
    em = dampr_tpu_torch.Dampr.memory([5, 4]).run()
    assert list(em.dataset) == list(
        dampr_tpu.Dampr.memory([5, 4]).run().dataset)


def test_grouped_read_groups_consecutive_keys():
    recs = _records(seed=22)

    def groups(ds):
        return [(k, list(vs)) for k, vs in ds.grouped_read()]

    got = groups(port_dataset.MemoryDataset(recs))
    assert got == groups(ref_dataset.MemoryDataset(recs))
    assert [k for k, _ in got] == sorted(set(k for k, _ in recs))


@pytest.mark.parametrize("n_blocks", [0, 1, 3])
def test_block_dataset_concat(n_blocks):
    rng = np.random.RandomState(23)
    parts = [rng.randint(0, 50, 5 + i).tolist() for i in range(n_blocks)]
    got = port_dataset.BlockDataset(
        [PortBlock.from_lists(p, p[::-1]) for p in parts]).concat()
    want = ref_dataset.BlockDataset(
        [RefBlock.from_lists(p, p[::-1]) for p in parts]).concat()
    assert isinstance(got, PortBlock)
    assert len(got) == len(want)
    assert list(got.iter_pairs()) == list(want.iter_pairs())
