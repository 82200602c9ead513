"""The tiny-stage collapse of dampr_tpu_torch against the JAX package.

A small materialized input (within ``runner.SMALL_STAGE_BYTES``) to a
pure record map, a broadcast join or a sink runs as one job over all its
refs, and a small associative fold reduces every partition in one pass
(``runner._tiny_assoc_reduce``), then re-splits by the same hash % P.
Only job granularity changes: the port version of
``tests/test_runner_semantics.py::TestTinyStageCollapse`` holds results
equal with the collapse on and off, a chunk-semantic ``partition_map``
keeps its per-chunk calls, and every case reads back the JAX package's
records at its default ``small_stage_bytes``, order included (a small
fold's output is in hash order within a partition on both sides).
Records are made from a seed with numpy.  Tolerance: exact.
"""

import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import runner as R
from dampr_tpu_torch import settings


@pytest.fixture(autouse=True)
def knobs():
    old = (settings.partitions, settings.device, R.SMALL_STAGE_BYTES,
           ref_settings.partitions)
    settings.partitions = ref_settings.partitions = 8
    settings.device = "cpu"
    yield
    (settings.partitions, settings.device, R.SMALL_STAGE_BYTES,
     ref_settings.partitions) = old


def _counts_per_chunk(pkg):
    def per_chunk(it):
        yield 1, sum(1 for _ in it)

    return (pkg.Dampr.memory(list(range(2000)), partitions=8)
            .checkpoint(force=True)
            .partition_map(per_chunk)
            .map(lambda x: x))


def _assoc_fold(pkg):
    items = np.random.RandomState(61).randint(0, 300, 1500).tolist()
    return pkg.Dampr.memory(items, partitions=16).count(lambda x: x % 97)


def _ties_after_fold(pkg):
    """``word_stats``' ``top_words`` shape: a small count, then a sort
    whose records tie on the count."""
    words = ["w%d" % i for i in
             np.random.RandomState(62).randint(0, 400, 3000)]
    return (pkg.Dampr.memory(words, partitions=6).count(lambda w: w)
            .sort_by(lambda wc: -wc[1]))


def _rekey_over_small_input(pkg):
    words = ["w%d" % i for i in
             np.random.RandomState(63).randint(0, 50, 800)]
    counts = pkg.Dampr.memory(words, partitions=6).count(lambda w: w)
    return counts.fold_by(lambda wc: len(wc[0]), value=lambda wc: wc[1],
                          binop=operator.add)


def _broadcast_join(pkg):
    rng = np.random.RandomState(64)
    left = pkg.Dampr.memory(rng.randint(0, 40, 300).tolist(),
                            partitions=5).count(lambda x: x)
    right = pkg.Dampr.memory(rng.randint(0, 9, 20).tolist())
    return left.cross_right(right, lambda a, b: (a[0], a[1] * b),
                            memory=True)


CASES = [_counts_per_chunk, _assoc_fold, _ties_after_fold,
         _rekey_over_small_input, _broadcast_join]


def _name(case):
    return case.__name__.strip("_")


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_collapse_keeps_the_jax_package_records(case):
    want = case(dampr_tpu).read()
    got = case(dampr_tpu_torch).read()
    assert got == want
    R.SMALL_STAGE_BYTES = 0  # the collapse off: one job per ref
    off = case(dampr_tpu_torch).read()
    assert sorted(off) == sorted(got)
    if case is _counts_per_chunk:
        assert len(got) > 1  # per chunk, not one merged call


def test_collapsed_stages_run_one_job():
    em = _rekey_over_small_input(dampr_tpu_torch).run()
    stats = em.stats()
    reduces = [s for s in stats["stages"] if s["kind"] == "reduce"]
    assert reduces and all(s["jobs"] == 1 for s in reduces)
    assert stats["tiny_folds"] == len(reduces)
    maps_after = [s for s in stats["stages"] if s["kind"] == "map"][1:]
    assert maps_after and all(s["jobs"] == 1 for s in maps_after)
    R.SMALL_STAGE_BYTES = 0
    stats = _rekey_over_small_input(dampr_tpu_torch).run().stats()
    assert stats["tiny_folds"] == 0
    assert all(s["jobs"] == settings.partitions for s in stats["stages"]
               if s["kind"] == "reduce")


def test_partition_map_keeps_its_chunks():
    stats = _counts_per_chunk(dampr_tpu_torch).run().stats()
    [pm] = [s for s in stats["stages"] if s["op"].startswith("StreamMapper")]
    assert pm["jobs"] == 8
    # the plain map after it is a pure record stream: one job
    assert stats["stages"][-1]["jobs"] == 1


def _parts(d):
    out = {}
    for p in os.listdir(d):
        with open(os.path.join(d, p), "rb") as f:
            out[p] = f.read()
    return out


@pytest.mark.parametrize("tsv,n_parts", [(False, 1), (True, 8)])
def test_small_sink_writes_the_jax_package_parts(tmp_path, tsv, n_parts):
    """A sink whose sinker is the plain identity ``Map`` collapses to one
    part file; ``sink_tsv``'s record op keeps one per chunk, in both
    packages."""
    def pipe(pkg, out):
        fold = _assoc_fold(pkg)
        return fold.sink_tsv(out) if tsv else fold.sink(out)

    ref_out, out = str(tmp_path / "ref"), str(tmp_path / "port")
    pipe(dampr_tpu, ref_out).run()
    pipe(dampr_tpu_torch, out).run()
    got = _parts(out)
    assert got == _parts(ref_out)
    assert len(got) == n_parts
