"""Streamed stage edges of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_pipeline.py``'s ``TestPlanDecisions``,
``TestPipelinedExecution`` (its ``test_publish_fault_fails_clean`` and the
frame-read timing class are in ``test_torch_faults.py``) and
``TestPipelinedProperty``; the exchange codec class stays with the slice
that ports the exchange.  ``test_mesh_possible_bars_streaming`` becomes
``test_decisions_equal_the_jax_packages``: the port runs on one card with
no mesh fold or exchange, so nothing a mesh would bar exists, and the
JAX side runs its single-device branches (``mesh_fold`` and
``mesh_exchange`` off) throughout this file.

Every edge decision must equal the JAX package's (but for an edge's
``output``, its Source's process-wide serial number), and every record
read back must equal the JAX package's and the port's own staged run
(``settings.pipeline = "off"``).  The port's optimizer has no switch:
where the JAX tests turn ``optimize`` off, these patch
``plan.passes.optimize`` to leave the graph as built.  Added: the early
folder's dtype gate, its partials in the HBM tier, the tiny fold's
staged-bytes gate and a failing fold keeping the original blocks.
"""

import operator
import random
import types
import uuid

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.plan import pipeline as ref_pipeline
from dampr_tpu_torch import runner as port_runner
from dampr_tpu_torch import settings, storage
from dampr_tpu_torch.plan import passes
from dampr_tpu_torch.plan import pipeline as plan_pipeline

_REF = ("pipeline", "pipeline_queue_bytes", "mesh_fold", "mesh_exchange",
        "sort_runs", "optimize")
_PORT = ("pipeline", "pipeline_queue_bytes", "sort_runs", "device",
         "hbm_budget", "partitions")


@pytest.fixture(autouse=True)
def pipelined_host():
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old = {n: getattr(settings, n) for n in _PORT}
    settings.device = "cpu"
    settings.pipeline = ref_settings.pipeline = "auto"
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    ref_settings.optimize = True
    yield
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old.items():
        setattr(settings, n, v)


@pytest.fixture
def unoptimized(monkeypatch):
    """The port's plan without its rewrite passes (the JAX package's
    ``optimize = False``)."""
    monkeypatch.setattr(passes, "optimize",
                        lambda graph, outputs: (graph,
                                                passes.empty_report(graph)))
    ref_settings.optimize = False


def _strip(decisions):
    return [{k: v for k, v in d.items() if k != "output"}
            for d in decisions]


def _decisions(build, runner=None):
    """The port's decisions for ``build``'s pipeline, held against the JAX
    package's on the same pipeline and runner."""
    pipe, ref = build(dampr_tpu_torch), build(dampr_tpu)
    got = plan_pipeline.analyze(pipe.pmer.graph, [pipe.source],
                                runner=runner)
    want = ref_pipeline.analyze(ref.pmer.graph, [ref.source], runner=runner)
    assert _strip(got) == _strip(want)
    return got


def _run_both(build):
    """(pipelined read, staged read, pipelined stats) of the port, each
    read equal to the JAX package's."""
    want = build(dampr_tpu).read()
    settings.pipeline = "auto"
    em = build(dampr_tpu_torch).run(name="pipe-on-%s" % uuid.uuid4().hex[:8])
    on, stats = em.read(), em.stats()
    em.delete()
    settings.pipeline = "0"
    em = build(dampr_tpu_torch).run(name="pipe-off-%s"
                                    % uuid.uuid4().hex[:8])
    off = em.read()
    em.delete()
    settings.pipeline = "auto"
    assert on == want
    return on, off, stats


def _fold(mod=5, n=100, partitions=4, binop=operator.add):
    def build(pkg):
        return (pkg.Dampr.memory(list(range(n)), partitions=partitions)
                .map(lambda x: x + 1)
                .fold_by(lambda x: x % mod, binop))
    return build


class TestPlanDecisions:
    def test_assoc_fold_streams_early_fold(self):
        d = _decisions(_fold())
        assert any(e["decision"] == "streamed" and e["mode"] == "early_fold"
                   for e in d), d

    def test_lambda_binop_keeps_barrier(self):
        d = _decisions(_fold(binop=lambda a, b: a + b))
        assert not any(e["mode"] == "early_fold" for e in d)
        assert any("order-sensitive" in e["reason"] for e in d), d

    def test_checkpoint_keeps_barrier(self):
        def build(pkg):
            return (pkg.Dampr.memory(list(range(100)), partitions=4)
                    .map(lambda x: x + 1).checkpoint()
                    .fold_by(lambda x: x % 5, operator.add))
        d = _decisions(build)
        ck = [e for e in d if "checkpoint" in e["reason"]]
        assert len(ck) >= 2, d
        assert all(e["decision"] == "barrier" for e in ck)

    def test_multi_consumer_keeps_barrier(self):
        def both(pkg):
            base = pkg.Dampr.memory(list(range(100)), partitions=4).map(
                lambda x: x + 1)
            a = base.map(lambda x: x * 2)
            b = base.filter(lambda x: x % 2 == 0)
            return a.pmer.graph.union(b.pmer.graph), [a.source, b.source]

        graph, outs = both(dampr_tpu_torch)
        ref_graph, ref_outs = both(dampr_tpu)
        d = plan_pipeline.analyze(graph, outs)
        assert _strip(d) == _strip(ref_pipeline.analyze(ref_graph,
                                                        ref_outs))
        assert any(e["reason"] == "multi-consumer output" for e in d), d

    def test_decisions_equal_the_jax_packages(self):
        builds = [_fold(), _fold(binop=min), _fold(binop=max),
                  lambda pkg: pkg.Dampr.memory(list(range(50))).sort_by(
                      lambda x: -x),
                  lambda pkg: pkg.Dampr.memory(list(range(50))).group_by(
                      lambda x: x % 3).reduce(lambda k, vs: sum(vs)),
                  lambda pkg: pkg.Dampr.memory(list(range(50))).map(
                      lambda x: (x, 1)).cached().count(lambda kv: kv[0])]
        for sort_runs in ("auto", "off"):
            settings.sort_runs = ref_settings.sort_runs = sort_runs
            for build in builds:
                _decisions(build)

    def test_resume_bars_streaming(self):
        fake = types.SimpleNamespace(resume=True, _handoff_sids=set(),
                                     _shuffle_targets={})
        d = _decisions(_fold(), runner=fake)
        assert not any(e["decision"] == "streamed" and e["dst"] is not None
                       for e in d)
        assert any("resume" in e["reason"] for e in d), d

    def test_host_shuffle_does_not_bar_mesh_does(self):
        edge = next(e for e in _decisions(_fold())
                    if e["decision"] == "streamed" and e["dst"] is not None)
        host = types.SimpleNamespace(
            resume=False, _handoff_sids=set(),
            _shuffle_targets={edge["dst"]: "host"})
        assert any(e["decision"] == "streamed" and e["dst"] is not None
                   for e in _decisions(_fold(), runner=host))
        mesh = types.SimpleNamespace(
            resume=False, _handoff_sids=set(),
            _shuffle_targets={edge["dst"]: "mesh"})
        d = _decisions(_fold(), runner=mesh)
        assert not any(e["decision"] == "streamed" and e["dst"] is not None
                       for e in d)

    def test_map_chain_streams_without_sorted_runs(self):
        settings.sort_runs = ref_settings.sort_runs = "off"

        def build(pkg):
            return (pkg.Dampr.memory(list(range(100)), partitions=4)
                    .map(lambda x: x + 1).map(lambda x: x * 2))
        d = _decisions(build)
        assert any(e["decision"] == "streamed" and e["mode"] == "chain"
                   for e in d), d

    def test_sorted_runs_bar_map_chain(self):
        settings.sort_runs = ref_settings.sort_runs = "on"

        def build(pkg):
            return (pkg.Dampr.memory(list(range(100)), partitions=4)
                    .map(lambda x: x + 1).map(lambda x: x * 2))
        d = _decisions(build)
        assert not any(e["mode"] == "chain" for e in d)
        assert any("sorted-run" in e["reason"] for e in d), d

    def test_explain_renders_decision_table(self):
        text = _fold()(dampr_tpu_torch).explain()
        assert "pipeline:" in text
        assert "streamed" in text

    def test_kill_switch_recorded_in_report(self):
        settings.pipeline = ref_settings.pipeline = "0"
        build = _fold(mod=3, n=50, partitions=2)
        text = build(dampr_tpu_torch).explain()
        assert "OFF" in text
        assert any(e["decision"] == "streamed" for e in _decisions(build))


class TestPipelinedExecution:
    def test_early_fold_byte_identity_and_stats(self):
        rng = random.Random(41)
        data = [rng.randrange(0, 10000) for _ in range(20000)]

        def build(pkg):
            return (pkg.Dampr.memory(data, partitions=8)
                    .map(lambda x: x * 3 + 1)
                    .fold_by(lambda x: x % 101, operator.add))
        on, off, stats = _run_both(build)
        assert on == off
        ps = stats["pipeline"]
        assert ps["enabled"] is True
        assert ps["edges_streamed"] >= 1
        assert ps["executed"] >= 1
        assert ps["published"] >= 1
        assert ps["early_folded_blocks"] >= 1
        assert 0.0 <= ps["overlap_fraction"] <= 1.0
        assert stats["plan"]["pipeline"]["streamed"] >= 1
        assert stats["plan"]["pipeline"]["active"] is True

    def test_chain_byte_identity(self, unoptimized):
        settings.sort_runs = ref_settings.sort_runs = "off"
        data = list(range(5000))

        def build(pkg):
            return (pkg.Dampr.memory(data, partitions=8)
                    .map(lambda x: x * 2)
                    .filter(lambda x: x % 3 != 0))
        on, off, stats = _run_both(build)
        assert on == off
        assert stats["pipeline"]["executed"] >= 1
        kinds = [s["kind"] for s in stats["stages"]]
        assert "map-chained" in kinds, kinds

    def test_backpressure_bound_respected(self):
        settings.pipeline_queue_bytes = 1
        rng = random.Random(7)
        data = [rng.randrange(0, 10000) for _ in range(20000)]

        def build(pkg):
            return (pkg.Dampr.memory(data, partitions=8)
                    .map(lambda x: x + 7)
                    .fold_by(lambda x: x % 53, operator.add))
        on, off, stats = _run_both(build)
        assert on == off
        ps = stats["pipeline"]
        assert ps["queue_peak_bytes"] <= ps["bytes_in"]
        if ps["published"] > 1:
            assert ps["queue_peak_bytes"] < ps["bytes_in"]


class TestEarlyFolder:
    def test_float_sums_never_fold_early(self):
        def build(pkg):
            return (pkg.Dampr.memory([i * 0.1 for i in range(6000)],
                                     partitions=6)
                    .map(lambda x: x * 3.0)
                    .fold_by(lambda x: int(x) % 7, operator.add))
        on, off, stats = _run_both(build)
        assert on == off
        ps = stats["pipeline"]
        assert ps["executed"] == 1
        assert ps["early_folded_blocks"] == 0

    def test_float_min_folds_early(self):
        def build(pkg):
            return (pkg.Dampr.memory([i * 0.37 for i in range(6000)],
                                     partitions=6)
                    .map(lambda x: x - 5.0)
                    .fold_by(lambda x: int(x) % 7, min))
        on, off, stats = _run_both(build)
        assert on == off
        assert stats["pipeline"]["early_folded_blocks"] >= 1

    def test_partials_of_a_device_fold_stay_in_the_hbm_tier(
            self, monkeypatch):
        """A device-fed fold's early partials register in the HBM tier the
        map's blocks went to, and the fold reads them there."""
        settings.hbm_budget = 64 * 1024 * 1024
        settings.partitions = 8
        monkeypatch.setattr(storage, "HBM_MIN_RECORDS", 1)
        devs = []
        real = storage.RunStore.register

        def spy(store, block, pin=False, device=False, handoff=False):
            ref = real(store, block, pin=pin, device=device,
                       handoff=handoff)
            devs.append(ref.is_device)
            return ref
        monkeypatch.setattr(storage.RunStore, "register", spy)

        def build(pkg):
            return (pkg.Dampr.memory(list(range(20000)), partitions=8)
                    .count(lambda x: x % 13))
        want = build(dampr_tpu).read()
        runner = port_runner.MTRunner("hbm-early", build(
            dampr_tpu_torch).pmer.graph)
        out = runner.run([runner.graph.stages[-1].output])
        assert [v for _k, v in out[0].read()] == want
        summary = runner.run_summary
        assert summary["pipeline"]["early_folded_blocks"] >= 1
        assert runner.mesh_folds == 1
        assert any(devs), "nothing entered the HBM tier"

    def test_tiny_fold_gates_on_staged_bytes(self, monkeypatch):
        """Early folds shrink a stage's output; the tiny fold decides on
        the bytes the staged run had, so both runs take the same path.
        The fold reads the re-key map's raw blocks (no map-side combine),
        so the early folds have duplicates to fold."""
        data = list(range(30000))

        def build(pkg):
            g = pkg.Dampr.memory(data, partitions=8).a_group_by(
                lambda x: x % 97)
            source, pmer = g.pmap.pmer._add_reducer(
                [g.pmap.source], pkg.base.AssocFoldReducer(operator.add))
            return pkg.dampr.PMap(source, pmer)
        stats = {}
        for mode in ("auto", "off"):
            settings.pipeline = mode
            em = build(dampr_tpu_torch).run()
            stats[mode] = (em.read(), em.stats())
            em.delete()
        staged = sum(s["bytes_in"] for s in stats["off"][1]["stages"]
                     if s["kind"] == "reduce")
        # the gate this test is about: staged bytes over it, folded under
        monkeypatch.setattr(port_runner, "SMALL_STAGE_BYTES", staged - 1)
        for mode in ("auto", "off"):
            settings.pipeline = mode
            em = build(dampr_tpu_torch).run()
            stats[mode] = (em.read(), em.stats())
            em.delete()
        on, off = stats["auto"], stats["off"]
        assert on[0] == off[0] == build(dampr_tpu).read()
        assert on[1]["pipeline"]["early_folded_blocks"] >= 1
        assert sum(s["bytes_in"] for s in on[1]["stages"]
                   if s["kind"] == "reduce") < staged
        assert on[1]["tiny_folds"] == off[1]["tiny_folds"] == 0

    def test_failing_fold_keeps_the_original_blocks(self, monkeypatch):
        calls = {"n": 0}
        real = port_runner._StreamFolder._fold_one

        def flaky(self, mapping):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("fold refused")
            return real(self, mapping)
        monkeypatch.setattr(port_runner._StreamFolder, "_fold_one", flaky)
        rng = random.Random(5)
        data = [rng.randrange(0, 5000) for _ in range(12000)]

        def build(pkg):
            return (pkg.Dampr.memory(data, partitions=8)
                    .map(lambda x: x + 3)
                    .fold_by(lambda x: x % 31, operator.add))
        on, off, stats = _run_both(build)
        assert on == off
        assert calls["n"] >= 2
        assert stats["pipeline"]["executed"] == 1


class TestPipelinedProperty:
    """Randomized pipelines: pipelined and staged runs read back the same
    records, and the JAX package's, on every optimizer and sorted-run
    leg."""

    def _unary(self, rng, pipe):
        roll = rng.randrange(5)
        if roll == 0:
            k = rng.randrange(1, 50)
            return pipe.map(lambda x, k=k: x + k)
        if roll == 1:
            m = rng.randrange(2, 7)
            return pipe.filter(lambda x, m=m: x % m != 0)
        if roll == 2:
            return pipe.flat_map(lambda x: (x, x + 1000000))
        if roll == 3:
            return pipe.sort_by(lambda x: -x)
        return pipe.checkpoint()

    def _build(self, seed, data, partitions):
        def build(pkg):
            rng = random.Random(seed)
            pipe = pkg.Dampr.memory(data, partitions=partitions)
            for _ in range(rng.randrange(1, 4)):
                pipe = self._unary(rng, pipe)
            if rng.randrange(2):
                m = rng.randrange(2, 9)
                pipe = (pipe.fold_by(lambda x, m=m: x % m, operator.add)
                        .map_values(lambda v: v * 3))
            return pipe
        return build

    @pytest.mark.parametrize("case", range(8))
    def test_pipelined_equals_staged(self, case, monkeypatch):
        rng = random.Random(18000 + case)
        if not case % 2:
            monkeypatch.setattr(
                passes, "optimize",
                lambda graph, outputs: (graph, passes.empty_report(graph)))
            ref_settings.optimize = False
        sort_runs = "off" if case % 4 < 2 else "auto"
        settings.sort_runs = ref_settings.sort_runs = sort_runs
        partitions = rng.choice([4, 8, 13])
        data = [rng.randrange(0, 5000)
                for _ in range(rng.randrange(200, 2000))]
        on, off, _ = _run_both(self._build(case, data, partitions))
        assert on == off, (
            "case {} diverged: pipelined {} records vs staged {}".format(
                case, len(on), len(off)))
