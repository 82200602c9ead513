"""The two-input stages (joins, crosses), ``len()`` and the partition
operators through dampr_tpu_torch against the JAX package.

Every case builds one pipeline against ``dampr_tpu`` and once against
``dampr_tpu_torch`` (device="cpu"), from the same records made from a
seed with numpy and with the same ``partitions``; both must read back
equal lists, order included (records that share a key keep the order the
reference gives them).  The cases are ``tests/test_conformance.py``'s
``TestJoins`` and ``TestCrosses`` and its partition-operator and
``len()`` cases, over seeded records, plus joins whose side is a fold
output and joins over mixed ``1``/``1.0``/``True``/``"1"`` keys.
Tolerance: exact.
"""

import operator

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import settings as port_settings

P = 8


@pytest.fixture(autouse=True)
def knobs():
    old = (ref_settings.partitions, port_settings.partitions,
           port_settings.device, port_settings.lower)
    ref_settings.partitions = port_settings.partitions = P
    port_settings.device = "cpu"
    yield
    (ref_settings.partitions, port_settings.partitions,
     port_settings.device, port_settings.lower) = old


WORDS = ["w%d" % i for i in range(18)]
MIXED = [1, 1.0, True, "1", 2, "b"]


def _data(seed):
    """Every case's records, from one seed."""
    rng = np.random.RandomState(seed)

    def pairs(n, lo, hi):
        return [(WORDS[k], int(v)) for k, v in zip(rng.randint(lo, hi, n),
                                                   rng.randint(0, 1000, n))]

    ints = rng.randint(0, 50, 40).tolist()
    return {
        "items": rng.randint(10, 100, 10).tolist(),
        "left": pairs(30, 0, 12),
        "right": pairs(25, 6, 18),
        "one_each": [(WORDS[k], int(v)) for k, v in
                     zip(rng.permutation(6), rng.randint(0, 9, 6))],
        "ints": ints,
        "floats": [float(x) for x in rng.randint(0, 50, 20)],
        "far_ints": (rng.randint(0, 50, 20) + 100).tolist(),
        "strs": [WORDS[k] for k in rng.randint(0, 8, 12)],
        "mixed_l": [(MIXED[k], int(v)) for k, v in
                    zip(rng.randint(0, 6, 24), rng.randint(0, 99, 24))],
        "mixed_r": [(MIXED[k], int(v)) for k, v in
                    zip(rng.randint(0, 6, 16), rng.randint(0, 99, 16))],
    }


def _pair_lists(left, right):
    return list(left), list(right)


def _by_first(pkg, recs, partitions=3):
    return pkg.Dampr.memory(recs, partitions=partitions).group_by(
        lambda x: x[0])


def _folded(pkg, recs):
    """A fold_values output keyed by each record's first element."""
    return (pkg.Dampr.memory(recs, partitions=4)
            .custom_mapper(pkg.Map(lambda k, v: [(v[0], v[1])]))
            .fold_values(operator.add))


# -- joins -----------------------------------------------------------------

def _inner_join(pkg, d):
    return (_by_first(pkg, d["left"]).join(_by_first(pkg, d["right"]))
            .reduce(_pair_lists).read())


def _disjoint_join_is_empty(pkg, d):
    left = pkg.Dampr.memory(d["ints"]).group_by(lambda x: x)
    right = pkg.Dampr.memory(d["far_ints"]).group_by(lambda x: x)
    return left.join(right).reduce(_pair_lists).read()


def _left_join(pkg, d):
    return (_by_first(pkg, d["left"]).join(_by_first(pkg, d["right"]))
            .left_reduce(_pair_lists).read())


def _outer_join(pkg, d):
    return (_by_first(pkg, d["left"]).join(_by_first(pkg, d["right"]))
            .outer_reduce(_pair_lists).read())


def _join_many_flattens(pkg, d):
    return (_by_first(pkg, d["left"]).join(_by_first(pkg, d["right"]))
            .reduce(lambda lit, rit: list(lit) + list(rit), many=True)
            .read())


def _join_numeric_keys_int_float_equal(pkg, d):
    left = pkg.Dampr.memory(d["ints"], partitions=4).group_by(lambda x: x)
    right = pkg.Dampr.memory(d["floats"], partitions=2).group_by(
        lambda x: x)
    return left.join(right).reduce(_pair_lists).read()


def _pjoin_run_directly(pkg, d):
    left = _by_first(pkg, d["one_each"])
    right = _by_first(pkg, d["left"])
    return left.join(right).run().read()


def _join_mixed_keys(pkg, d):
    left = _by_first(pkg, d["mixed_l"], partitions=5)
    right = _by_first(pkg, d["mixed_r"], partitions=2)
    return left.join(right).outer_reduce(_pair_lists).read()


def _join_fold_output_side(pkg, d):
    right = _by_first(pkg, d["right"])
    return _folded(pkg, d["left"]).join(right).outer_reduce(
        _pair_lists).read()


def _join_two_fold_outputs(pkg, d):
    return (_folded(pkg, d["left"]).join(_folded(pkg, d["right"]))
            .left_reduce(_pair_lists).read())


def _repartition_disjoint_join_empty(pkg, d):
    items = pkg.Dampr.memory(d["items"], partitions=2)
    items2 = (pkg.Dampr.memory(d["ints"])
              .group_by(lambda x: -x - 1).reduce(lambda k, vs: sum(vs)))
    return items.group_by(lambda x: x).join(items2).run().read()


def _preduce_unique_then_join(pkg, d):
    left = (pkg.Dampr.memory(d["left"]).group_by(lambda x: x[0],
                                                 lambda x: x[1] % 3)
            .unique())
    return left.join(_by_first(pkg, d["right"])).reduce(_pair_lists).read()


JOINS = [_inner_join, _disjoint_join_is_empty, _left_join, _outer_join,
         _join_many_flattens, _join_numeric_keys_int_float_equal,
         _pjoin_run_directly, _join_mixed_keys, _join_fold_output_side,
         _join_two_fold_outputs, _repartition_disjoint_join_empty,
         _preduce_unique_then_join]


# -- crosses ---------------------------------------------------------------

def _cross_left(pkg, d):
    left = pkg.Dampr.memory(d["ints"][:5])
    right = pkg.Dampr.memory(d["strs"][:3])
    return left.cross_left(right, lambda x, y: (x, y)).read()


def _cross_right(pkg, d):
    left = pkg.Dampr.memory(d["ints"][:5])
    right = pkg.Dampr.memory(d["strs"][:3])
    return left.cross_right(right, lambda x, y: (x, y)).read()


def _cross_left_memory_cached(pkg, d):
    left = pkg.Dampr.memory(d["ints"][:7], partitions=3)
    right = pkg.Dampr.memory(d["strs"][:2])
    return left.cross_left(right, lambda x, y: (x, y), memory=True).read()


def _cross_set(pkg, d):
    left = pkg.Dampr.memory(d["ints"])
    right = pkg.Dampr.memory(d["far_ints"][:4] + d["ints"][:3])
    return left.cross_set(right, lambda x, y: x in y, agg=set).read()


def _cross_with_computed_total(pkg, d):
    # test_conformance's count() and sum() spelled as the folds they are
    items = pkg.Dampr.memory(d["items"], partitions=2)
    item_counts = items.fold_by(lambda x: x, operator.add, lambda x: 1)
    total = (items.a_group_by(lambda x: 1, lambda x: 1)
             .reduce(operator.add).map(lambda x: float(x[1])))
    return item_counts.cross_right(
        total, lambda ic, t: (ic[0], ic[1] / t)).read()


def _cross_join_self(pkg, d):
    items = pkg.Dampr.memory(d["items"], partitions=2)
    return items.cross_left(items, lambda v1, v2: v1 * v2).run().read()


def _cross_of_reduce_outputs(pkg, d):
    # The broadcast side is a small associative fold: both packages fold
    # it in one pass (the tiny fold), which leaves it in hash order within
    # a partition, and the records the cross ties under one left key come
    # in that order.
    sums = _folded(pkg, d["right"])
    return _folded(pkg, d["left"]).cross_right(
        sums, lambda a, b: (a[0], b[0], a[1] - b[1]), memory=True).read()


CROSSES = [_cross_left, _cross_right, _cross_left_memory_cached,
           _cross_set, _cross_with_computed_total, _cross_join_self,
           _cross_of_reduce_outputs]


# -- len() and the partition operators ------------------------------------

def _len(pkg, d):
    return pkg.Dampr.memory(d["items"], partitions=2).len().read()


def _len_empty(pkg, d):
    return pkg.Dampr.memory([]).len().read()


def _len_of_fold_output(pkg, d):
    return _folded(pkg, d["left"]).len().read()


def _custom_reducer(pkg, d):
    items = pkg.Dampr.memory(d["items"], partitions=2)
    return items.custom_reducer(pkg.Reduce(lambda k, it: sum(it))).read()


def _partition_map(pkg, d):
    def plus_one(vals):
        for num in vals:
            yield num, num + 1

    return pkg.Dampr.memory(d["ints"][:9], partitions=3).partition_map(
        plus_one).read()


def _partition_reduce(pkg, d):
    def largest_number(it):
        largest = float("-inf")
        found = False
        for _gk, its in it:
            for value in its:
                found = True
                largest = max(largest, value)
        if found:
            yield "Largest", largest

    return pkg.Dampr.memory(d["ints"]).partition_reduce(
        largest_number).read()


def _block_mapper(pkg, d):
    class Summer(pkg.BlockMapper):
        def start(self):
            self.total = 0

        def add(self, k, v):
            self.total += v
            return ()

        def finish(self):
            yield 1, self.total

    return pkg.Dampr.memory(d["ints"], partitions=6).custom_mapper(
        Summer()).read()


def _block_reducer(pkg, d):
    class SumGroups(pkg.BlockReducer):
        def start(self):
            self.total = 0

        def add(self, k, it):
            self.total += sum(it)
            return ()

        def finish(self):
            if self.total:
                yield "total", self.total

    return pkg.Dampr.memory(d["ints"], partitions=4).custom_reducer(
        SumGroups()).read()


def _stream_reducer_runs_on_empty_partition(pkg, d):
    def observe(groups):
        yield "ran", sum(1 for _ in groups)

    return pkg.Dampr.memory(d["items"][:1]).partition_reduce(observe).read()


def _bare_streamable_mapper(pkg, d):
    class Doubler(pkg.Streamable):
        def stream(self, kvs):
            for k, v in kvs:
                yield k, v * 2

    return pkg.Dampr.memory(d["ints"][:6]).custom_mapper(Doubler()).read()


def _read_input_many_datasets(pkg, d):
    ds = [pkg.MemoryDataset(list(enumerate(d["ints"][i:i + 5])))
          for i in (0, 5, 10)]
    return pkg.Dampr.read_input(*ds).map(lambda x: x + 1).read()


def _multi_output_run(pkg, d):
    base = pkg.Dampr.memory(d["left"]).group_by(lambda x: x[0])
    counts = base.reduce(lambda k, vs: len(list(vs)))
    joined = base.join(_by_first(pkg, d["right"]))
    return [em.read() for em in pkg.Dampr.run(counts, joined)]


OPERATORS = [_len, _len_empty, _len_of_fold_output, _custom_reducer,
             _partition_map, _partition_reduce, _block_mapper,
             _block_reducer, _stream_reducer_runs_on_empty_partition,
             _bare_streamable_mapper, _read_input_many_datasets,
             _multi_output_run]


def _parity(case, seed):
    d = _data(seed)
    want = case(dampr_tpu, d)
    got = case(dampr_tpu_torch, d)
    assert got == want
    return want


def _name(case):
    return case.__name__.lstrip("_")


@pytest.mark.parametrize("case", JOINS, ids=_name)
def test_join_matches_reference(case):
    _parity(case, 11)


@pytest.mark.parametrize("case", CROSSES, ids=_name)
def test_cross_matches_reference(case):
    _parity(case, 12)


@pytest.mark.parametrize("case", OPERATORS, ids=_name)
def test_operator_matches_reference(case):
    _parity(case, 13)


def test_per_job_clone_shares_only_stateless_operators():
    from dampr_tpu_torch import base
    from dampr_tpu_torch.runner import _clone_op

    class Counter(object):
        def __init__(self):
            self.n = 0

        def __call__(self, k, v):
            self.n += 1
            yield k, v

    plain = base.Map(lambda k, v: [(k, v)])
    assert _clone_op(plain) is plain
    stateful = base.Map(Counter())
    clone = _clone_op(stateful)
    assert clone is not stateful and clone.mapper is not stateful.mapper
    cross = base.MapCrossJoin(lambda *a: ())
    assert _clone_op(cross) is cross
    lifecycle = dampr_tpu_torch.BlockReducer()
    assert _clone_op(lifecycle) is not lifecycle


def test_block_reducer_state_is_per_job_under_thread_stress():
    """More job threads than cores, a short switch interval, and every job
    held at a barrier until all are inside the reducer: a lifecycle
    reducer shared across jobs would lose or mix partition totals."""
    import sys
    import threading
    import time

    jobs = 16

    class SumGroups(dampr_tpu_torch.BlockReducer):
        # class attributes: shared by every copy
        gate = threading.Barrier(jobs)
        seen = set()

        def start(self):
            self.gate.wait(timeout=30)  # every job is inside the reducer
            self.seen.add(id(self))
            self.total = 0

        def add(self, k, it):
            total = self.total
            time.sleep(0)  # hand the lock to another job mid-update
            self.total = total + sum(it)
            return ()

        def finish(self):
            yield "total", self.total

    rng = np.random.RandomState(5)
    data = rng.randint(0, 100000, 20000).tolist()
    old = (port_settings.max_processes, sys.getswitchinterval())
    port_settings.max_processes = jobs
    sys.setswitchinterval(1e-6)
    try:
        out = (dampr_tpu_torch.Dampr.memory(data, partitions=24)
               .custom_mapper(dampr_tpu_torch.Map(lambda k, v: [(v % 997, v)]))
               .custom_reducer(SumGroups()).run(n_partitions=jobs).read())
    finally:
        port_settings.max_processes = old[0]
        sys.setswitchinterval(old[1])
    assert len(SumGroups.seen) == jobs  # one instance per job
    assert len(out) == jobs
    assert sum(out) == sum(data)


def test_reference_shapes_hold():
    """The conformance suite's own expectations, on the port's output."""
    d = _data(13)
    assert _len(dampr_tpu_torch, d) == [10]
    assert _len_empty(dampr_tpu_torch, d) == [0]
    ran = _stream_reducer_runs_on_empty_partition(dampr_tpu_torch, d)
    assert len(ran) == P and sum(v[1] for v in ran) == 1
    assert sum(_block_mapper(dampr_tpu_torch, d)) == sum(d["ints"])
    mixed = dict(_join_mixed_keys(dampr_tpu_torch, _data(11)))
    assert set(mixed) == {1, 2, "1", "b"}  # 1, 1.0 and True meet
