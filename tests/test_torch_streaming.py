"""The out-of-core reduces and joins of dampr_tpu_torch, each held against
the JAX package on the same records.

Over ``settings.streaming_reduce_threshold`` a reduce partition streams:
an associative fold folds window by window into an accumulator of
distinct keys, an order-insensitive reducer reads a
``StreamingGroupedView`` (a k-way merge over hash-sorted runs, groups in
hash order, records that share a 64-bit hash sub-grouped by their real
key), and a keyed join merges both sides by hash.  The cases are
``tests/test_streaming_reduce.py``'s and ``tests/test_streaming_join.py``'s,
forced hash collisions included, on records made from a seed with numpy;
every comparison is exact, order included.

The JAX side runs with ``mesh_fold`` and ``mesh_exchange`` "off": its
test rig has 8 virtual CPU devices (``tests/conftest.py``), on which it
would take its mesh reduce and exchange instead of the single-device
out-of-core branches the port has.
"""

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import base as ref_base
from dampr_tpu import settings as ref_settings
from dampr_tpu import storage as ref_storage
from dampr_tpu.blocks import Block as RefBlock
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import base, settings
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.runner import MTRunner, OutputDataset
from dampr_tpu_torch.storage import SPILL_WINDOW, PartitionSet, RunStore

_NAMES = ("partitions", "max_memory_per_stage", "scratch_root",
          "streaming_reduce_threshold")


@pytest.fixture(autouse=True)
def tight_memory(tmp_path):
    old_ref = {n: getattr(ref_settings, n)
               for n in _NAMES + ("mesh_fold", "mesh_exchange")}
    old_port = {n: getattr(settings, n) for n in _NAMES + ("device",)}
    for s in (ref_settings, settings):
        s.partitions = 4
        s.max_memory_per_stage = 32 * 1024
        s.streaming_reduce_threshold = 16 * 1024
    ref_settings.scratch_root = str(tmp_path / "ref")
    settings.scratch_root = str(tmp_path / "port")
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    settings.device = "cpu"
    yield
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old_port.items():
        setattr(settings, n, v)


class TestWindowedSpill:
    def test_iter_windows_bounded(self):
        store = RunStore("wintest", budget=1)  # everything spills
        n = SPILL_WINDOW + 123
        keys = np.random.RandomState(0).randint(0, 1 << 30, size=n)
        ref = store.register(Block(keys, keys * 2))
        store.drain_writes()
        assert not ref.resident
        windows = list(ref.iter_windows())
        assert [len(w) for w in windows] == [SPILL_WINDOW, 123]
        got = Block.concat(windows)
        assert np.array_equal(got.keys, keys)
        assert np.array_equal(got.values, keys * 2)
        store.cleanup()


def _views(blocks_of, spill):
    """A StreamingGroupedView in each package over the same runs (each
    block hash-sorted, as map outputs are); ``spill`` puts every run on
    disk first."""
    budget = 1 if spill else 1 << 30
    out = []
    for Blk, Store, View in ((Block, RunStore, base.StreamingGroupedView),
                             (RefBlock, ref_storage.RunStore,
                              ref_base.StreamingGroupedView)):
        store = Store("sgv", budget=budget)
        refs = [store.register(Blk(*b).sort_by_hash()) for b in blocks_of]
        store.drain_writes()
        out.append((View(refs), store))
    return out


def _grouped(view):
    return [(k, list(vs)) for k, vs in view.grouped_read()]


class TestStreamingGroupedView:
    @pytest.mark.parametrize("spill", [False, True])
    def test_matches_materialized_grouping_and_the_jax_package(self, spill):
        rng = np.random.RandomState(0)
        runs = []
        for _run in range(5):
            keys = rng.randint(0, 50, size=2000).astype(np.int64)
            runs.append((keys, keys * 10 + 1))
        (port, pstore), (ref, rstore) = _views(runs, spill)
        got = _grouped(port)
        assert got == _grouped(ref)  # same hash order, same value order
        want = {}
        for keys, vals in runs:
            for k, v in zip(keys.tolist(), vals.tolist()):
                want.setdefault(k, []).append(v)
        assert {k: sorted(vs) for k, vs in got} == {
            k: sorted(vs) for k, vs in want.items()}
        assert list(port.read()) == list(ref.read())
        pstore.cleanup()
        rstore.cleanup()

    def test_forced_hash_collision_subgroups_exactly(self):
        h = np.full(6, 9, dtype=np.uint32)
        keys = np.array(["a", "b", "a", "b", "a", "b"], dtype=object)
        got = []
        for Blk, Store, View in (
                (Block, RunStore, base.StreamingGroupedView),
                (RefBlock, ref_storage.RunStore,
                 ref_base.StreamingGroupedView)):
            store = Store("sgvc", budget=1 << 30)
            view = View([store.register(Blk(keys, np.arange(6), h.copy(),
                                            h.copy()))])
            got.append(_grouped(view))
        assert got[0] == got[1] == [("a", [0, 2, 4]), ("b", [1, 3, 5])]


def _run(pkg, pipe, name):
    """Run through each package's MTRunner; (records, runner)."""
    Runner = MTRunner if pkg is dampr_tpu_torch else RefRunner
    runner = Runner(name, pipe.pmer.graph)
    out = runner.run([pipe.source])
    return list(out[0].read()), runner


PIPES = {
    "group_by": lambda pkg: (
        pkg.Dampr.memory(_rng_ints(40000, 1 << 20, 1), partitions=16)
        .group_by(lambda x: x % 9).reduce(lambda k, it: sum(it))),
    "count": lambda pkg: (
        pkg.Dampr.memory(_rng_ints(50000, 1 << 20, 2), partitions=16)
        .count(lambda x: x % 1100)),
    "unique_order_within_runs": lambda pkg: (
        pkg.Dampr.memory([("k", i) for i in _rng_ints(30000, 1000, 3)],
                         partitions=4)
        .group_by(lambda x: x[0], lambda x: x[1])
        .reduce(lambda k, it: list(it))),
    "hot_key": lambda pkg: (
        pkg.Dampr.memory([("hot", 1)] * 100000 + [("cold", 2)] * 5,
                         partitions=8)
        .group_by(lambda x: x[0], lambda x: x[1])
        .reduce(lambda k, it: sum(it))),
    "string_keys_opaque_binop": lambda pkg: (
        pkg.Dampr.memory(["w%d" % i for i in _rng_ints(20000, 3000, 4)],
                         partitions=8)
        .fold_by(lambda w: w, binop=lambda x, y: x + y, value=lambda w: 1)),
}


def _rng_ints(n, high, seed):
    return np.random.RandomState(seed).randint(0, high, size=n).tolist()


@pytest.mark.parametrize("name", sorted(PIPES))
def test_over_budget_reduce_equals_the_jax_package(name):
    got, runner = _run(dampr_tpu_torch, PIPES[name](dampr_tpu_torch), name)
    want, _ = _run(dampr_tpu, PIPES[name](dampr_tpu), name)
    assert got == want
    s = runner.run_summary
    assert s["streamed_views"] + s["streamed_assoc_folds"] > 0, s
    if name == "unique_order_within_runs":
        # arrival order: sequential chunks, a stable hash sort, the merge
        # stable by run
        (_k, (_k2, vals)), = got
        assert vals == _rng_ints(30000, 1000, 3)
    if name == "hot_key":
        assert dict(v for _k, v in got) == {"hot": 100000, "cold": 10}


def test_over_budget_assoc_fold_uses_vectorized_accumulator():
    """Many chunks over a modest key set: per-chunk partials stack past
    the threshold in every partition, while the accumulator of distinct
    keys stays under it."""
    n_keys, repeats = 2000, 40

    def build(pkg):
        return (pkg.Dampr.memory(list(range(n_keys)) * repeats,
                                 partitions=repeats)
                .count(lambda x: x).checkpoint())

    got, runner = _run(dampr_tpu_torch, build(dampr_tpu_torch), "acc")
    want, ref_runner = _run(dampr_tpu, build(dampr_tpu), "acc")
    assert got == want
    assert dict(v for _k, v in got) == {i: repeats for i in range(n_keys)}
    assert runner.streamed_assoc_folds >= 1
    assert ref_runner.streamed_assoc_folds >= 1


def test_accumulator_over_the_threshold_falls_back_to_the_record_stream():
    """Distinct keys everywhere: the accumulator outgrows the threshold,
    so the fold bails out to the streaming view, exact all the same."""
    keys = _rng_ints(60000, 1 << 40, 5)

    def build(pkg):
        return pkg.Dampr.memory(keys, partitions=8).count(lambda x: x)

    got, runner = _run(dampr_tpu_torch, build(dampr_tpu_torch), "bail")
    want, _ = _run(dampr_tpu, build(dampr_tpu), "bail")
    assert got == want
    assert runner.streamed_assoc_folds == 0 and runner.streamed_views > 0


class TestVectorMerge:
    @pytest.fixture(autouse=True)
    def tiny_budget(self):
        for s in (ref_settings, settings):
            s.streaming_reduce_threshold = None
            s.max_memory_per_stage = 1  # every read takes a merge path

    @pytest.mark.parametrize("case", ["ties", "descending", "object_keys",
                                      "hot_key"])
    def test_final_read_equals_the_jax_package(self, case):
        rng = np.random.RandomState(3)

        def build(pkg):
            if case == "ties":
                data = rng.randint(0, 500, size=20000).tolist()
                return (pkg.Dampr.memory([(k, i) for i, k in enumerate(data)],
                                         partitions=8)
                        .map_keys(lambda k: k).checkpoint(True))
            if case == "descending":
                return (pkg.Dampr.memory(list(range(30000, 0, -1)),
                                         partitions=8).checkpoint(True))
            if case == "object_keys":
                return (pkg.Dampr.memory(["b", "a", "c"] * 100, partitions=4)
                        .checkpoint(True))
            return (pkg.Dampr.memory([(7, i) for i in range(50000)]
                                     + [(j, -j) for j in range(50)],
                                     partitions=8).checkpoint(True))

        state = rng.get_state()
        got, runner = _run(dampr_tpu_torch, build(dampr_tpu_torch), case)
        rng.set_state(state)
        want, _ = _run(dampr_tpu, build(dampr_tpu), case)
        assert got == want
        keys = [k for k, _v in got]
        assert keys == sorted(keys)

    def test_vector_merge_matches_the_record_merge(self):
        rng = np.random.RandomState(4)
        data = rng.randint(0, 500, size=20000)
        # hash-partitioned numeric keys (a map output a reduce reads): the
        # vector merge, over every partition spilled
        store = RunStore("vmerge", budget=1)
        blk = Block(data.astype(np.int64), np.arange(len(data)))
        pset = PartitionSet(8)
        for pid, sub in blk.split_by_partition(8).items():
            pset.add(pid, store.register(sub))
        store.drain_writes()
        out = OutputDataset(pset, store)
        vec = list(out.read())
        assert vec == sorted(zip(data.tolist(), range(len(data))))
        assert vec == list(out._merge_partitions(sorted(out.pset.parts)))
        blocks = list(out.sorted_blocks())
        assert max(len(b) for b in blocks) <= (1 << 16) * 9
        assert [k for b in blocks for k in b.keys.tolist()] == [
            k for k, _v in vec]
        store.cleanup()


# -- joins --------------------------------------------------------------------

def _join_cases():
    def inner(pkg):
        rng = np.random.RandomState(0)
        lk = rng.randint(0, 200, size=3000).tolist()
        rk = rng.randint(100, 300, size=3000).tolist()
        left = pkg.Dampr.memory([(k, "l%d" % i) for i, k in enumerate(lk)]) \
            .group_by(lambda x: x[0], lambda x: x[1])
        right = pkg.Dampr.memory([(k, "r%d" % i) for i, k in enumerate(rk)]) \
            .group_by(lambda x: x[0], lambda x: x[1])
        return left.join(right).reduce(lambda l, r: (list(l), list(r)))

    def inner_many(pkg):
        left = pkg.Dampr.memory([("a", 1), ("a", 2), ("b", 3)]).group_by(
            lambda x: x[0], lambda x: x[1])
        right = pkg.Dampr.memory([("a", 9), ("c", 4)]).group_by(
            lambda x: x[0], lambda x: x[1])
        return left.join(right).reduce(lambda l, r: list(l) + list(r),
                                       many=True)

    def left(pkg):
        rng = np.random.RandomState(1)
        lk = rng.randint(0, 100, size=2000).tolist()
        rk = rng.randint(50, 150, size=500).tolist()
        return (pkg.Dampr.memory(lk).group_by(lambda x: x)
                .join(pkg.Dampr.memory(rk).group_by(lambda x: x))
                .left_reduce(lambda l, r: (len(list(l)), len(list(r)))))

    def outer(pkg):
        left = pkg.Dampr.memory(list(range(0, 60))).group_by(lambda x: x % 17)
        right = pkg.Dampr.memory(list(range(40, 120))).group_by(
            lambda x: x % 23)
        return left.join(right).outer_reduce(lambda l, r: (list(l), list(r)))

    def strings(pkg):
        rng = np.random.RandomState(2)
        lk = ["k%d" % k for k in rng.randint(0, 400, size=4000)]
        rk = ["k%d" % k for k in rng.randint(200, 600, size=4000)]
        return (pkg.Dampr.memory(lk).group_by(lambda x: x)
                .join(pkg.Dampr.memory(rk).group_by(lambda x: x))
                .outer_reduce(lambda l, r: (len(list(l)), len(list(r)))))

    return {"inner": inner, "inner_many": inner_many, "left": left,
            "outer": outer, "strings": strings}


JOINS = _join_cases()


@pytest.mark.parametrize("name", sorted(JOINS))
def test_streaming_join_equals_the_jax_package_and_the_materialized_join(
        name):
    for s in (ref_settings, settings):
        s.streaming_reduce_threshold = None
        s.max_memory_per_stage = 512 * 1024 ** 2
    materialized = JOINS[name](dampr_tpu_torch).run()
    want_in_memory = materialized.read()
    assert materialized.stats()["streamed_joins"] == 0
    for s in (ref_settings, settings):
        s.streaming_reduce_threshold = 1  # every partition streams
    em = JOINS[name](dampr_tpu_torch).run()
    got = em.read()
    assert em.stats()["streamed_joins"] > 0
    assert got == JOINS[name](dampr_tpu).read()
    # the values inside a joined group come in hash-merge order
    assert sorted(got, key=repr) == sorted(want_in_memory, key=repr)


def test_forced_hash_collision_joins_exactly():
    h = np.full(4, 5, dtype=np.uint32)
    lkeys = np.array(["a", "b", "a", "b"], dtype=object)
    rkeys = np.array(["b", "c"], dtype=object)
    outs = []
    for Blk, Store, mod in ((Block, RunStore, base),
                            (RefBlock, ref_storage.RunStore, ref_base)):
        store = Store("collide-join", budget=1 << 30)
        lv = mod.StreamingGroupedView([store.register(
            Blk(lkeys, np.arange(4), h.copy(), h.copy()))])
        rv = mod.StreamingGroupedView([store.register(
            Blk(rkeys, np.array([10, 20]), h[:2].copy(), h[:2].copy()))])
        for red in (mod.KeyedInnerJoin(lambda k, l, r: (list(l), list(r))),
                    mod.KeyedOuterJoin(lambda k, l, r: (list(l), list(r)))):
            outs.append(list(mod.streaming_merge_join(lv, rv, red)))
    assert outs[:2] == outs[2:]
    assert dict(v for _k, v in outs[0]) == {"b": ([1, 3], [10])}
    assert dict(v for _k, v in outs[1]) == {
        "a": ([0, 2], []), "b": ([1, 3], [10]), "c": ([], [20])}
