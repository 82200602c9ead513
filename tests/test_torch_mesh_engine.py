"""The engine's mesh keyed fold of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_mesh_engine.py``'s 11 cases: associative
sum/min/max reduces route through the mesh keyed fold
(``runner._mesh_reduce``) on the JAX package's 8-device CPU rig and on a
port mesh of 8 CPU shards, with the host path taking over exactly where
the JAX package's does (an opaque binop, object values).  Records must
equal the JAX package's and the mesh-off runs', exactly.  The port's
integer lanes are int64 (ROADMAP §C): values past 32 bits that send the
JAX package to the host fold on the mesh in the port, with the same
records.  Added: the streamed-edge bar of a mesh that could engage
(``plan.pipeline._mesh_possible``), against the JAX package's decisions.
"""

import operator
import uuid

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.plan import pipeline as ref_pipeline
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import settings
from dampr_tpu_torch.plan import pipeline as port_pipeline
from dampr_tpu_torch.runner import MTRunner

_REF = ("partitions", "mesh_fold", "mesh_exchange", "pipeline")
_PORT = _REF + ("device", "mesh_devices", "scratch_root")


@pytest.fixture(autouse=True)
def small_partitions(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old = {n: getattr(settings, n) for n in _PORT}
    settings.device = "cpu"
    settings.mesh_devices = ["cpu"] * 8
    settings.scratch_root = str(tmp_path / "port-scratch")
    settings.partitions = ref_settings.partitions = 8
    settings.mesh_fold = ref_settings.mesh_fold = "auto"
    try:
        yield
    finally:
        for n, v in old_ref.items():
            setattr(ref_settings, n, v)
        for n, v in old.items():
            setattr(settings, n, v)


def _runs(build, budget=None, checkpoint=True):
    """``build(Dampr)`` through both packages' runners (checkpointed, as
    the JAX tests run an aggregate): ``[(records, runner)]`` JAX first."""
    out = []
    for D, R in ((dampr_tpu.Dampr, RefRunner),
                 (dampr_tpu_torch.Dampr, MTRunner)):
        pipe = build(D)
        if checkpoint:
            pipe = pipe.checkpoint()
        kw = {} if budget is None else {"memory_budget": budget}
        runner = R("mesh-engine-%s" % uuid.uuid4().hex[:8],
                   pipe.pmer.graph, **kw)
        out.append((list(runner.run([pipe.source])[0].read()), runner))
    return out


def _read(build):
    return [list(build(D).read()) for D in (dampr_tpu.Dampr,
                                           dampr_tpu_torch.Dampr)]


class TestMeshFoldEngagement:
    def test_count_routes_through_mesh(self):
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(list(range(5000)), partitions=8).count(
                lambda x: x % 7))
        assert pr.mesh_folds >= 1 and rr.mesh_folds >= 1
        assert pr.run_summary["mesh"]["folds"] == pr.mesh_folds
        assert pr.run_summary["mesh"]["devices"] == 8
        want = {i: len(range(i, 5000, 7)) for i in range(7)}
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == want

    def test_sum_matches_host_path(self):
        data = list(range(3000))

        def build(D):
            return D.memory(data, partitions=8).a_group_by(
                lambda x: x % 5).sum()

        ref, mesh_out = _read(build)
        settings.mesh_fold = "off"
        host_out = list(build(dampr_tpu_torch.Dampr).read())
        assert mesh_out == host_out == ref

    def test_min_max_via_mesh(self):
        data = [(i % 4, i) for i in range(2000)]
        for fn, want in ((min, {0: 0, 1: 1, 2: 2, 3: 3}),
                         (max, {0: 1996, 1: 1997, 2: 1998, 3: 1999})):
            ref, port = _read(lambda D: D.memory(data, partitions=8)
                              .a_group_by(lambda x: x[0], lambda x: x[1])
                              .reduce(fn))
            assert dict(port) == dict(ref) == want

    def test_opaque_binop_stays_on_host(self):
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(list(range(100)), partitions=4).a_group_by(
                lambda x: x % 3).reduce(lambda a, b: a + b))
        assert pr.mesh_folds == rr.mesh_folds == 0
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            i: sum(range(i, 100, 3)) for i in range(3)}

    def test_object_values_stay_on_host(self):
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(["a", "bb", "a"], partitions=2).a_group_by(
                lambda s: s).sum())
        assert pr.mesh_folds == rr.mesh_folds == 0
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            "a": "aa", "bb": "bb"}

    def test_large_values_fall_back_exactly(self):
        # past 32 bits: the JAX package's int32 lanes refuse and it folds
        # on the host; the port's int64 lanes fold on the mesh; the same
        # records either way
        data = [("k", 2 ** 40)] * 50
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(data, partitions=4).a_group_by(
                lambda x: x[0], lambda x: x[1]).sum())
        assert rr.mesh_folds == 0 and pr.mesh_folds == 1
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            "k": 50 * 2 ** 40}

    def test_string_keys_via_mesh(self):
        words = ["alpha", "beta", "gamma"] * 500
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(words, partitions=8).count())
        assert pr.mesh_folds >= 1 and rr.mesh_folds >= 1
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            "alpha": 500, "beta": 500, "gamma": 500}


class TestMeshFoldOverBudget:
    def test_spilled_count_stays_on_mesh(self):
        data = [i % 5000 for i in range(60000)]
        (ref, rr), (port, pr) = _runs(
            lambda D: D.memory(data, partitions=8).count(), budget=1 << 16)
        assert pr.mesh_folds >= 1, "over-budget input left the mesh path"
        assert pr.store.spill_count > 0, "input never spilled"
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            k: 12 for k in range(5000)}

    def test_spilled_string_fold_windows_exact(self):
        words = ["w%d" % (i % 499) for i in range(40000)]
        (ref, _), (port, pr) = _runs(
            lambda D: D.memory(words, partitions=8).count(), budget=1 << 16)
        assert pr.mesh_folds >= 1
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == {
            "w%d" % k: len(range(k, 40000, 499)) for k in range(499)}

    def test_cross_window_overflow_falls_back_exact(self):
        # each window fits 32-bit lanes, the total does not: the JAX
        # package's running bound sends it to the host; the port's int64
        # bound keeps it on the mesh; the records are equal
        n, k, val = 120000, 7000, 30000
        data = [(i % k, val) for i in range(n)]
        (ref, _), (port, pr) = _runs(
            lambda D: D.memory(data, partitions=8).a_group_by(
                lambda x: x[0], lambda x: x[1]).sum(), budget=1 << 16)
        want = {i: (n // k + (1 if i < n % k else 0)) * val
                for i in range(k)}
        assert dict(v for _k, v in port) == dict(v for _k, v in ref) == want

    def test_min_over_budget_matches_host(self):
        data = [(i % 97, (i * 7919) % 100003) for i in range(30000)]

        def build(D):
            return D.memory(data, partitions=8).a_group_by(
                lambda x: x[0], lambda x: x[1]).reduce(min)

        (ref, _), (port, pr) = _runs(build, budget=1 << 16)
        assert pr.mesh_folds >= 1
        settings.mesh_fold = "off"
        pipe = build(dampr_tpu_torch.Dampr).checkpoint()
        hr = MTRunner("host-ob-min-%s" % uuid.uuid4().hex[:8],
                      pipe.pmer.graph, memory_budget=1 << 16)
        host = sorted(v for _k, v in hr.run([pipe.source])[0].read())
        assert hr.mesh_folds == 0
        assert sorted(v for _k, v in port) == host == sorted(
            v for _k, v in ref)


class TestMeshBarsStreaming:
    def test_mesh_possible_bars_streaming(self):
        """A mesh fold that could engage keeps every edge a barrier, as
        in the JAX package; mesh knobs off, the fold edge streams."""
        def decisions(D, P):
            pipe = (D.memory(list(range(100)), partitions=4)
                    .map(lambda x: x + 1)
                    .fold_by(lambda x: x % 5, operator.add))
            d = P.analyze(pipe.pmer.graph, [pipe.source])
            return [(e["decision"], e["reason"]) for e in d
                    if e["dst"] is not None]

        settings.pipeline = ref_settings.pipeline = "auto"
        settings.mesh_fold = ref_settings.mesh_fold = "on"
        port = decisions(dampr_tpu_torch.Dampr, port_pipeline)
        ref = decisions(dampr_tpu.Dampr, ref_pipeline)
        assert port == ref
        assert not any(dec == "streamed" for dec, _r in port)
        assert any("mesh" in r for _d, r in port)
        settings.mesh_fold = settings.mesh_exchange = "off"
        port_off = decisions(dampr_tpu_torch.Dampr, port_pipeline)
        assert any(dec == "streamed" for dec, _r in port_off)
