"""The record ops, the batched record path and the DSL calls built on them,
through dampr_tpu_torch against the JAX package.

Every parity case builds one pipeline against ``dampr_tpu`` and once
against ``dampr_tpu_torch`` (device="cpu"), from the same records made
from a seed with numpy, with the same ``partitions``; both must read back
the same list.  The cases are ``tests/test_conformance.py``'s
``TestMapping``, the grouping cases ``test_torch_joins.py`` does not
hold (``sum``/``first``, ``count``, ``mean``, ``sort_by``, ``topk``,
``None`` and mixed-type keys), ``TestPersistence``, ``TestEmptyInputs``,
``test_json_input`` and ``TestUtils``.  Tolerance: exact, except float means (relative 1e-12:
each side sums in its own order).  ``sort_by`` records that tie on the
sort key come in the same order on both sides: each package registers
one key-sorted run per job (sorted-run mode) and reads them back stably.

Then each record op's ``apply_batch`` against its own ``stream`` (``Sample``
on one random sequence, a stateful filter), the batched path against the
streamed one, and ``read_lists`` against ``read()``.
"""

import json
import math
import os
import random

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.utils import filter_by_count as ref_filter_by_count
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.base import (Filter, FlatMap, Inspect, Map, MapKeys,
                                  MapValues, Prefix, Rekey, Sample, Suffix,
                                  ValueMap, fuse, record_op_chain)
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.dataset import (BlockDataset, MemoryDataset,
                                     TextLineDataset)
from dampr_tpu_torch.utils import filter_by_count as port_filter_by_count

P = 8


@pytest.fixture(autouse=True)
def knobs():
    old = (ref_settings.partitions, port_settings.partitions,
           port_settings.device)
    ref_settings.partitions = port_settings.partitions = P
    port_settings.device = "cpu"
    yield
    (ref_settings.partitions, port_settings.partitions,
     port_settings.device) = old


def _data(seed=7):
    rng = np.random.RandomState(seed)
    names = ["Andrew", "Alice", "Bob", "Becky", "Carl"]
    return {
        "items": rng.randint(10, 100, 12).tolist(),
        "pairs": [(names[a], int(b)) for a, b in
                  zip(rng.randint(0, 5, 14), rng.randint(0, 60, 14))],
        "floats": [(names[a], float(b) / 7.0) for a, b in
                   zip(rng.randint(0, 5, 30), rng.randint(0, 999, 30))],
        "words": [names[a] for a in rng.randint(0, 5, 25)],
        "mixed": [(k, int(v)) for k, v in
                  zip([1, 1.0, True, "1", 2, "b", None, 2.5],
                      rng.randint(0, 9, 8))],
        "many": rng.randint(0, 40, 300).tolist(),
    }


DATA = _data()


def _items(pkg, part=2):
    return pkg.Dampr.memory(DATA["items"], partitions=part)


# Each case: pkg -> one handle (or a tuple of handles run together).
CASES = {
    "identity": lambda pkg: _items(pkg),
    "map_filter_flat_map": lambda pkg: (
        _items(pkg).map(lambda x: x + 1).filter(lambda x: x % 2 == 0)
        .flat_map(lambda x: [x, x])),
    "map_values": lambda pkg: pkg.Dampr.memory(DATA["pairs"]).map_values(
        lambda x: x + 1),
    "map_keys": lambda pkg: pkg.Dampr.memory(DATA["pairs"]).map_keys(len),
    "prefix": lambda pkg: pkg.Dampr.memory(DATA["words"]).prefix(len),
    "suffix": lambda pkg: pkg.Dampr.memory(DATA["words"]).suffix(len),
    "sample_all": lambda pkg: _items(pkg).sample(1.0),
    "sample_none": lambda pkg: _items(pkg).sample(0.0),
    "flat_map_generator": lambda pkg: pkg.Dampr.memory(
        DATA["many"], partitions=3).flat_map(lambda x: (y for y in
                                                         range(x % 4))),
    "sum": lambda pkg: _items(pkg).a_group_by(lambda x: x % 3).sum(),
    "first": lambda pkg: _items(pkg).a_group_by(lambda x: x % 2).first(),
    "first_objects": lambda pkg: pkg.Dampr.memory(
        DATA["pairs"], partitions=3).a_group_by(lambda x: x[0]).first(),
    "count": lambda pkg: _items(pkg).count(lambda x: x % 4),
    "count_many": lambda pkg: pkg.Dampr.memory(
        DATA["many"], partitions=4).count(),
    "count_none_keys": lambda pkg: _items(pkg).count(lambda x: None),
    "mean_int": lambda pkg: pkg.Dampr.memory(DATA["pairs"]).mean(
        lambda x: x[0], lambda v: v[1]),
    "mean_default_key": lambda pkg: _items(pkg).mean(),
    "sort_by": lambda pkg: _items(pkg).filter(lambda x: x % 2 == 1).sort_by(
        lambda x: -x),
    "topk": lambda pkg: pkg.Dampr.memory(DATA["many"] + [2.2]).topk(5),
    "topk_value": lambda pkg: pkg.Dampr.memory(DATA["many"]).topk(
        4, lambda x: -x),
    "topk_objects": lambda pkg: pkg.Dampr.memory(DATA["words"]).topk(3),
    "mixed_keys": lambda pkg: pkg.Dampr.memory(DATA["mixed"]).fold_by(
        lambda kv: kv[0], lambda x, y: x + y, lambda kv: kv[1]),
    "checkpoint_shared_prefix": lambda pkg: _checkpoint(pkg),
    "cached": lambda pkg: pkg.Dampr.memory([1, 2, 3, 4, 5, 6]).mean(
        lambda x: x % 2).cached(),
    "multi_output": lambda pkg: (pkg.Dampr.memory([1, 2, 3, 4, 5]),
                                 pkg.Dampr.memory(DATA["items"]).map(str)),
    "empty_map": lambda pkg: pkg.Dampr.memory([]).map(lambda x: x + 1),
    "empty_group": lambda pkg: pkg.Dampr.memory([]).group_by(
        lambda x: x).reduce(lambda k, it: sum(it)),
    "filter_all_then_group": lambda pkg: _items(pkg).filter(
        lambda x: x > 1000).group_by(lambda x: x).reduce(
            lambda k, it: sum(it)),
    "empty_count": lambda pkg: pkg.Dampr.memory([]).count(),
    "mean_device_fold": lambda pkg: pkg.Dampr.memory(
        DATA["many"] * 20, partitions=1).mean(lambda x: x % 7),
    "stateful_filter_per_job": lambda pkg: pkg.Dampr.memory(
        DATA["many"], partitions=4).filter(_Dedupe()),
    "filter_by_count": lambda pkg: (
        ref_filter_by_count if pkg is dampr_tpu else port_filter_by_count)(
            pkg.Dampr.memory(DATA["words"]), lambda x: x,
            lambda c: c >= 5),
}


class _Dedupe(object):
    """A stateful callable object: each job gets its own copy, so it
    drops repeats within a chunk only."""

    def __init__(self):
        self.seen = set()

    def __call__(self, v):
        if v in self.seen:
            return False
        self.seen.add(v)
        return True


def _checkpoint(pkg):
    evens = _items(pkg).filter(lambda x: x % 2 == 0).checkpoint()
    return (evens.a_group_by(lambda x: 1).sum(),
            evens.a_group_by(lambda x: 1).reduce(lambda x, y: x * y))


def _read(handles):
    if isinstance(handles, tuple):
        pkg = (dampr_tpu_torch if isinstance(handles[0],
                                             dampr_tpu_torch.PBase)
               else dampr_tpu)
        return [em.read() for em in pkg.Dampr.run(*handles)]
    return handles.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_back_what_the_jax_package_does(case):
    want = _read(CASES[case](dampr_tpu))
    got = _read(CASES[case](dampr_tpu_torch))
    assert got == want


def test_pair_sum_folds_2d_lanes_on_the_device_branch():
    """A 6,000-record block of (sum, count) int pairs folds on the device
    branch (the CPU floor is 4,096) with one index_add_ over the rows."""
    want = CASES["mean_device_fold"](dampr_tpu).read()
    em = CASES["mean_device_fold"](dampr_tpu_torch).run()
    assert em.read() == want
    assert em.stats()["device"]["keyed"]["segment_fold"]["calls"] > 0


def test_pinned_blocks_never_spill(tmp_path):
    from dampr_tpu_torch import storage

    port_settings_root = port_settings.scratch_root
    port_settings.scratch_root = str(tmp_path)
    try:
        store = storage.RunStore("pin-test", budget=1)
        blk = Block.from_lists(list(range(100)), list(range(100)))
        pinned = [store.register(blk, pin=True) for _ in range(3)]
        loose = [store.register(blk) for _ in range(3)]
        store.drain_writes()  # spills land in the background writer pool
        assert all(r.resident for r in pinned)
        assert not any(r.resident for r in loose)
        assert store.spill_count == 3
        assert [r.get().to_lists() for r in loose + pinned] == [
            blk.to_lists()] * 6
    finally:
        port_settings.scratch_root = port_settings_root


def test_cached_stage_stays_in_ram_over_budget():
    """Over budget, a ``cached()`` stage's blocks stay in RAM where the
    same stage as a ``checkpoint()`` spills them."""
    def build(pkg, barrier):
        mid = pkg.Dampr.memory(DATA["many"], partitions=3).map(
            lambda x: x * 2)
        mid = mid.cached() if barrier == "cached" else mid.checkpoint()
        return mid.map(lambda x: x + 1)

    want = build(dampr_tpu, "cached").read()
    spills, barrier_spills = {}, {}
    for barrier in ("cached", "checkpoint"):
        em = build(dampr_tpu_torch, barrier).run(memory_budget=1)
        assert em.read() == want
        spills[barrier] = em.stats()["spill"]["count"]
        # the barrier stage's own registrations: spills are charged to the
        # stage whose blocks pushed the store over budget
        first_map = [s for s in em.stats()["stages"] if s["kind"] == "map"][0]
        barrier_spills[barrier] = first_map["spill_count"]
    assert spills["cached"] > 0  # the last map's blocks still spill
    assert barrier_spills["cached"] == 0 < barrier_spills["checkpoint"]


def test_spill_counts_when_decided_not_when_written(tmp_path,
                                                   monkeypatch):
    """A spill counts when the store decides it.  A queued write that
    finds its ref dropped (a merge generation drops runs while their
    writes wait) still counted, so the counts do not depend on how fast
    the writer threads run."""
    import threading

    from dampr_tpu_torch import storage
    from dampr_tpu_torch.io import writer

    gate = threading.Event()
    real = writer.frames.write_block_frames

    def held(*args, **kwargs):
        gate.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(writer.frames, "write_block_frames", held)
    monkeypatch.setattr(port_settings, "scratch_root", str(tmp_path))
    monkeypatch.setattr(port_settings, "spill_write_threads", 1)
    store = storage.RunStore("decided-spills", budget=1)
    blk = Block.from_lists(list(range(100)), list(range(100)))
    first, second = store.register(blk), store.register(blk)
    assert store.spill_count == 2
    assert store.spilled_bytes == first.nbytes + second.nbytes
    store.drop_ref(second)  # dropped while its write waits
    gate.set()
    store.drain_writes()
    assert store.spill_count == 2
    assert not first.resident and first.get().to_lists() == blk.to_lists()
    # only the live ref's file: the dropped one's write never ran
    assert len(os.listdir(os.path.join(str(tmp_path), "decided-spills",
                                       "stage_0"))) == 1
    store.cleanup()


def test_float_mean_within_1e_12():
    """Float sums fold in another order on each side (numpy ``reduceat``
    against XLA's segment sum), so means agree to a relative 1e-12."""
    def build(pkg):
        return pkg.Dampr.memory(DATA["floats"], partitions=3).mean(
            lambda x: x[0], lambda v: v[1])

    want = build(dampr_tpu).read()
    got = build(dampr_tpu_torch).read()
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert math.isclose(g, w, rel_tol=1e-12)


def test_sort_by_ties_in_the_jax_package_order():
    def build(pkg):
        return pkg.Dampr.memory(DATA["pairs"], partitions=3).sort_by(
            lambda x: x[1] % 5)

    got = build(dampr_tpu_torch).read()
    assert got == build(dampr_tpu).read()
    keys = [x[1] % 5 for x in got]
    assert keys == sorted(keys) and len(set(keys)) < len(keys)  # ties


def test_inspect_passes_through_and_prints(capsys):
    want = _items(dampr_tpu).inspect("dbg").read()
    ref_out = capsys.readouterr().out
    got = _items(dampr_tpu_torch).inspect("dbg").read()
    port_out = capsys.readouterr().out
    assert got == want
    assert sorted(port_out.splitlines()) == sorted(ref_out.splitlines())
    assert "dbg: {}".format(DATA["items"][0]) in port_out


def _part_lines(d):
    out = []
    for part in sorted(os.listdir(d)):
        with open(os.path.join(d, part)) as f:
            out.extend(f.read().splitlines())
    return sorted(out)


@pytest.mark.parametrize("kind", ["sink", "tsv", "json"])
def test_sinks_write_what_the_jax_package_writes(tmp_path, kind):
    def build(pkg, path):
        if kind == "sink":
            return _items(pkg).map(str).sink(path)
        if kind == "tsv":
            return pkg.Dampr.memory(DATA["pairs"]).sink_tsv(path)
        return pkg.Dampr.memory(
            [{"name": n, "hr": v} for n, v in DATA["pairs"]]).sink_json(path)

    results = []
    for pkg, d in ((dampr_tpu, "ref"), (dampr_tpu_torch, "port")):
        path = str(tmp_path / d)
        emitted = build(pkg, path).run().read()
        results.append((sorted(map(repr, emitted)), _part_lines(path)))
    assert results[1] == results[0]
    assert results[1][1]


def test_json_input(tmp_path):
    p = str(tmp_path / "data.json")
    with open(p, "w") as f:
        for i, n in enumerate(DATA["items"]):
            f.write(json.dumps({"i": i, "n": n}) + "\n")

    def build(pkg):
        return pkg.Dampr.json(p, chunk_size=40).map(lambda d: d["i"] * d["n"])

    assert build(dampr_tpu_torch).read() == build(dampr_tpu).read()


def test_indexer(tmp_path):
    """The Indexer builds, unions and intersects the same lines."""
    from dampr_tpu.utils import Indexer as RefIndexer
    from dampr_tpu_torch.utils import Indexer as PortIndexer

    out = []
    for cls, name in ((RefIndexer, "ref"), (PortIndexer, "port")):
        d = tmp_path / name
        d.mkdir()
        (d / "doc1.txt").write_text("apple banana\nbanana cherry\n")
        (d / "doc2.txt").write_text("apple date\napple apple\n")
        idx = cls(str(d / "*.txt"))
        total = idx.build(lambda line: line.split())
        union = sorted(l.strip() for l in idx.union(["banana"]).read())
        inter = sorted(l.strip() for l in idx.intersect(
            ["apple", "banana"]).read())
        two = sorted(l.strip() for l in idx.intersect(
            ["apple", "date"], min_match=0.5).read())
        out.append((total, union, inter, two))
    assert out[1] == out[0]
    assert out[1][0][0][1] == 8


# -- apply_batch against stream, op by op ------------------------------------

RECORDS = [(i, (i % 5, i * 2)) for i in range(200)]
FLAT = [(i, i) for i in range(200)]


def _both(op, records):
    streamed = list(op.stream(iter(records)))
    ks, vs = op.apply_batch([k for k, _ in records], [v for _, v in records])
    return streamed, list(zip(ks, vs))


@pytest.mark.parametrize("op,records", [
    (ValueMap(lambda v: (v[0], v[1] + 1)), RECORDS),
    (MapValues(lambda b: b * 10), RECORDS),
    (MapKeys(lambda a: a - 1), RECORDS),
    (Prefix(lambda v: v[0]), RECORDS),
    (Suffix(lambda v: v[1]), RECORDS),
    (Filter(lambda v: v[1] % 3 == 0), RECORDS),
    (Filter(lambda v: False), RECORDS),
    (Filter(lambda v: True), RECORDS),
    (FlatMap(lambda v: [v, v, v]), FLAT),
    (FlatMap(lambda v: []), FLAT),
    (FlatMap(lambda v: (x for x in range(v % 4))), FLAT),
    (Rekey(lambda v: v[0]), RECORDS),
    (Rekey(lambda v: v[0], lambda v: v[1]), RECORDS),
    (Inspect("t"), FLAT[:3]),
], ids=lambda x: type(x).__name__ if not isinstance(x, list) else "")
def test_batch_equals_stream(op, records):
    streamed, batched = _both(op, records)
    assert batched == streamed


def test_sample_draws_one_sequence_both_ways():
    op = Sample(0.4, lambda: random.Random(1234))
    streamed, batched = _both(op, FLAT)
    assert batched == streamed
    assert 30 < len(streamed) < 130


def test_stateful_filter_sees_stream_order():
    def run(lowering):
        seen = set()

        def dedupe(v):
            if v in seen:
                return False
            seen.add(v)
            return True

        records = [(i, i % 7) for i in range(50)]
        if lowering == "stream":
            return list(Filter(dedupe).stream(iter(records)))
        ks, vs = Filter(dedupe).apply_batch([k for k, _ in records],
                                            [v for _, v in records])
        return list(zip(ks, vs))

    assert run("batch") == run("stream")
    assert [v for _, v in run("stream")] == list(range(7))


def test_record_op_chain_flattens_and_refuses_opaque_links():
    ops = [ValueMap(lambda v: v + 1), Filter(lambda v: v % 2 == 0),
           FlatMap(lambda v: [v, -v])]
    assert record_op_chain(fuse(ops)) == ops
    assert record_op_chain(fuse([ops[0], Map(lambda k, v: [(k, v)])])) is None


@pytest.mark.parametrize("pipe", ["chain", "fold", "fanout", "selective"])
def test_batched_path_equals_streamed_path(pipe, monkeypatch):
    """The runner's batched branch against the per-record branch (taken
    when ``record_op_chain`` finds no chain): the same records in the same
    order (FlatMap's adaptive slices included)."""
    def build():
        d = dampr_tpu_torch.Dampr
        if pipe == "chain":
            return (d.memory(list(range(3000)), partitions=3)
                    .map(lambda x: x * 3).filter(lambda x: x % 2 == 0)
                    .flat_map(lambda x: [x, x + 1]).map(lambda x: x - 1))
        if pipe == "fold":
            return (d.memory(list(range(3000)))
                    .map(lambda x: x + 1)
                    .fold_by(lambda x: x % 10, binop=lambda a, b: a + b))
        if pipe == "fanout":
            return (d.memory(list(range(3000)), partitions=1)
                    .flat_map(lambda x: [x] * 40))
        return (d.memory(list(range(100000)), partitions=2)
                .filter(lambda x: x % 250 == 0))

    out = {True: build().read()}
    with monkeypatch.context() as m:
        m.setattr(dampr_tpu_torch.base, "record_op_chain", lambda op: None)
        out[False] = build().read()
    assert out[True] == out[False]
    assert out[True]


def test_batched_path_is_taken(monkeypatch):
    calls = []
    orig = ValueMap.apply_batch

    def spy(self, ks, vs):
        calls.append(len(ks))
        return orig(self, ks, vs)

    monkeypatch.setattr(ValueMap, "apply_batch", spy)
    out = dampr_tpu_torch.Dampr.memory(list(range(100))).map(
        lambda x: x + 1).read()
    assert out == list(range(1, 101))
    assert sum(calls) == 100


# -- read_lists against read() -----------------------------------------------

def _lists(ds, batch):
    return [kv for ks, vs in ds.read_lists(batch) for kv in zip(ks, vs)]


@pytest.mark.parametrize("trailing", [True, False])
def test_read_lists_equals_read_across_boundaries(tmp_path, trailing):
    p = tmp_path / "t.txt"
    lines = ["line %d %s" % (i, "x" * (i % 13)) for i in range(500)]
    p.write_text("\n".join(lines) + ("\n" if trailing else ""))
    size = p.stat().st_size
    for cut in (0, 1, 7, size // 3, size // 2, size - 2, size - 1, size):
        a = TextLineDataset(str(p), 0, cut)
        b = TextLineDataset(str(p), cut, None)
        want = list(a.read()) + list(b.read())
        assert _lists(a, 64) + _lists(b, 64) == want, cut
        if cut:  # (a chunk never starts at 0 but the first)
            assert [v for _, v in want] == lines


def test_read_lists_windows_and_edge_files(tmp_path):
    p = tmp_path / "t.txt"
    p.write_bytes(b"alpha\nbeta\ngamma")
    ds = TextLineDataset(str(p))
    assert _lists(ds, 2) == list(ds.read())
    # lines across the 4 MB byte blocks read_lists splits
    big = tmp_path / "big.txt"
    big.write_bytes(b"".join(b"%d %s\n" % (i, b"y" * (i % 97))
                             for i in range(90000)))
    for start, end in ((0, None), (1234567, 4200000), (4194300, None)):
        ds = TextLineDataset(str(big), start, end)
        assert _lists(ds, 5000) == list(ds.read())
    empty = tmp_path / "e.txt"
    empty.write_bytes(b"")
    assert list(TextLineDataset(str(empty)).read_lists(8)) == []


def test_memory_and_block_read_lists():
    kvs = [(i, ("v", i)) for i in range(37)]
    assert _lists(MemoryDataset(kvs), 5) == kvs
    blocks = [Block.from_lists([k for k, _ in kvs[:20]],
                               [v for _, v in kvs[:20]]),
              Block.from_lists([], []),
              Block.from_lists([k for k, _ in kvs[20:]],
                               [v for _, v in kvs[20:]])]
    ds = BlockDataset(blocks)
    assert _lists(ds, 6) == list(ds.read()) == kvs
