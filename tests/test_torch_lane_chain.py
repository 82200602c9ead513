"""The analyzer's engine wiring in the port against the JAX package's
(``tests/test_analyze.py::TestEngineWiring``), on the CPU device.

- Fusion declines across an impure UDF: equal ``fuse_maps`` counts in
  both packages, analysis on and off.
- Analysis off gives the same graph signature for pure pipelines, and
  equal results around an impure one.
- A certified numeric chain (``map``/``filter``, and with a trailing
  re-key: ``fold_by``, ``count()``) lowers to the device target and runs
  through the lane program, verified per batch on the CPU device; its
  records equal the JAX package's, the analyze-off run's and a Python
  oracle's.
- A stale ``exec_target="device"`` annotation cannot dispatch an opaque
  op, and a zero divisor raises ``ZeroDivisionError`` with analysis on
  and off.

About 20,000 records in 2 partitions (each batch above the CPU device's
4,096-record dispatch floor); tolerance: exact.
"""

import operator

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.plan import lower as ref_plan_lower
from dampr_tpu.plan import passes as ref_passes
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.analyze import torchtrace
from dampr_tpu_torch.plan import ir, passes
from dampr_tpu_torch.plan import lower as port_plan_lower

N = 20000


@pytest.fixture(autouse=True)
def knobs():
    old_ref = (ref_settings.analyze, ref_settings.lower,
               ref_settings.device_min_batch)
    old_port = (port_settings.analyze, port_settings.device,
                port_settings.lower)
    ref_settings.analyze = port_settings.analyze = True
    port_settings.device = "cpu"
    yield
    (ref_settings.analyze, ref_settings.lower,
     ref_settings.device_min_batch) = old_ref
    (port_settings.analyze, port_settings.device,
     port_settings.lower) = old_port


def _fused_counts(pkg, opt, settings, build):
    pipe = build(pkg)
    out = []
    for on in (True, False):
        settings.analyze = on
        out.append(opt.optimize(pipe.pmer.graph,
                                [pipe.source])[1]["rules"]["fuse_maps"])
    settings.analyze = True
    return out


def _program(pipe):
    g, _ = passes.optimize(pipe.pmer.graph, [pipe.source])
    return torchtrace.stage_program(
        [s for s in g.stages if hasattr(s, "mapper")
         and len(s.inputs) == 1][-1])


def _read(pipe, name):
    em = pipe.run(name=name)
    out = em.read()
    stats = em.stats()
    em.delete()
    return out, stats


def _lower_on():
    port_settings.lower = "on"
    ref_settings.lower = "1"
    ref_settings.device_min_batch = 4096


def _lower_off():
    port_settings.lower = "off"
    ref_settings.lower = "0"


class TestFusion:
    @pytest.mark.parametrize("sink", [False, True])
    def test_fusion_declines_across_impure_udf(self, tmp_path, sink):
        acc = []

        def build(pkg):
            p = (pkg.Dampr.memory(list(range(100)))
                 .map(lambda x: (acc.append(x), x)[1])
                 .map(lambda x: x + 1))
            return p.sink_tsv(str(tmp_path / pkg.__name__)) if sink else p

        got = _fused_counts(dampr_tpu_torch, passes, port_settings, build)
        assert got == _fused_counts(dampr_tpu, ref_passes, ref_settings,
                                    build)
        assert got[1] > got[0]

    def test_pure_chains_still_fuse(self):
        def build(pkg):
            return (pkg.Dampr.memory(list(range(100)))
                    .map(lambda x: x * 2).map(lambda x: x + 1))

        got = _fused_counts(dampr_tpu_torch, passes, port_settings, build)
        assert got == [1, 1]
        assert got == _fused_counts(dampr_tpu, ref_passes, ref_settings,
                                    build)

    def test_analysis_off_plans_identical_for_pure_pipelines(self):
        pipe = (dampr_tpu_torch.Dampr.memory(list(range(100)))
                .map(lambda x: x * 2).map(lambda x: x + 1)
                .fold_by(lambda x: x % 5, operator.add))
        g_on, _ = passes.optimize(pipe.pmer.graph, [pipe.source])
        port_settings.analyze = False
        g_off, _ = passes.optimize(pipe.pmer.graph, [pipe.source])
        assert ir.graph_signature(g_on) == ir.graph_signature(g_off)

    def test_analysis_off_results_equal_around_impure_udf(self):
        def build(pkg, acc):
            return (pkg.Dampr.memory([(i % 7, i) for i in range(2000)],
                                     partitions=4)
                    .map(lambda kv: (acc.append(kv), kv)[1])
                    .map(lambda kv: (kv[0], kv[1] * 2))
                    .fold_by(lambda kv: kv[0], operator.add,
                             value=lambda kv: kv[1]))

        on, stats = _read(build(dampr_tpu_torch, []), "analyze-on")
        sec = stats["plan"]["analysis"]
        assert sec["enabled"] and sec["stages"]
        assert "DTA201" in [d["code"] for d in sec["diagnostics"]]
        port_settings.analyze = False
        off, stats = _read(build(dampr_tpu_torch, []), "analyze-off")
        assert not stats["plan"]["analysis"]["enabled"]
        assert on == off
        assert on == _read(build(dampr_tpu, []), "analyze-ref")[0]


def _chain(pkg):
    return (pkg.Dampr.memory(list(range(N)), partitions=2)
            .map(lambda x: x * 3 + 1)
            .filter(lambda x: x % 2 == 0))


def _fold_by(pkg):
    return (pkg.Dampr.memory(list(range(-N // 2, N // 2)), partitions=2)
            .map(lambda x: x * 3 + 1)
            .filter(lambda x: x % 2 == 0)
            .fold_by(lambda x: x % 64, operator.add))


def _count(pkg):
    return (pkg.Dampr.memory([float(i % 97) for i in range(N)],
                             partitions=2)
            .map(lambda v: v * 0.5 + 3.0)
            .count(lambda v: v // 4))


def _oracle(build):
    vals = [x * 3 + 1 for x in range(N)]
    if build is _chain:
        return [v for v in vals if v % 2 == 0]
    if build is _fold_by:
        out = {}
        for x in range(-N // 2, N // 2):
            v = x * 3 + 1
            if v % 2 == 0:
                out[v % 64] = out.get(v % 64, 0) + v
        return sorted(out.items())
    out = {}
    for i in range(N):
        k = (float(i % 97) * 0.5 + 3.0) // 4
        out[k] = out.get(k, 0) + 1
    return sorted(out.items())


class TestCertifiedChain:
    @pytest.mark.parametrize("build", [_chain, _fold_by, _count],
                             ids=["map_filter", "fold_by", "count"])
    def test_certified_chain_runs_the_lane_program(self, build):
        _lower_on()
        pipe = build(dampr_tpu_torch)
        prog = _program(pipe)
        assert prog is not None
        before = dict(prog.counters)
        got, stats = _read(pipe, "lane-dev")
        c = {k: v - before[k] for k, v in prog.counters.items()}
        assert got == _oracle(build)
        maps = [s for s in stats["stages"] if s["kind"] == "map"]
        assert maps[0]["target"] == "device"
        assert stats["device"]["device_stages"] >= 1
        assert c["batches"] == 2
        assert c["device_dispatched"] == 2 == c["device_verified"]
        assert c["device_mismatch"] == 0 and c["fallback"] == 0
        assert c["diff_checked"] == 2 and c["diff_diverged"] == 0
        # the JAX package plans the same targets and reads the same
        ref = build(dampr_tpu)
        ref_graph, _ = ref_passes.optimize(ref.pmer.graph, [ref.source])
        port_graph, _ = passes.optimize(pipe.pmer.graph, [pipe.source])
        want = [(d["kind"], d["target"])
                for d in ref_plan_lower.analyze(ref_graph,
                                                outputs=[ref.source])]
        assert [(d["kind"], d["target"])
                for d in port_plan_lower.analyze(
                    port_graph, outputs=[pipe.source])] == want
        assert got == _read(ref, "lane-ref")[0]
        # analyze off takes the per-record path to the same records
        _lower_off()
        port_settings.analyze = False
        before = dict(prog.counters)
        off, stats = _read(build(dampr_tpu_torch), "lane-host")
        assert off == got
        assert prog.counters == before
        assert {s["target"] for s in stats["stages"]} == {"host"}

    def test_stale_device_annotation_cannot_dispatch_opaque_op(self):
        pipe = dampr_tpu_torch.Dampr.memory(list(range(10))).flat_map(
            lambda x: [x, x])
        stage = pipe.pmer.graph.stages[-1]
        stage.options["exec_target"] = "device"
        assert torchtrace.stage_program(stage) is None
        got, _ = _read(pipe, "stale-annot")
        assert sorted(got) == sorted(x for x in range(10) for _ in (0, 1))

    @pytest.mark.parametrize("analyze", [True, False])
    def test_zero_divide_raises(self, analyze):
        """A zero divisor past the first diff-tested batch raises the
        genuine ZeroDivisionError, never a silent inf."""
        _lower_on()
        port_settings.analyze = analyze
        data = [float(i) for i in range(1, N)] + [0.0]
        with pytest.raises(ZeroDivisionError):
            (dampr_tpu_torch.Dampr.memory(data, partitions=2)
             .map(lambda v: 1.0 / v)).run(name="zero-div")
