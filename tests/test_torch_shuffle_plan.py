"""The plan's host-or-mesh shuffle routing of dampr_tpu_torch against
dampr_tpu's.

The port versions of ``tests/test_shuffle_plan.py``'s 15 cases:
``cost.shuffle_choice``, the runner's exchange gate under the plan's
targets, the plan report's ``shuffle`` section with the runner's routing
map, history pinning a second run to the host, ``stats()["mesh"]
["exchange"]``, a device-lowered reduce recorded but not routed,
``explain()``'s shuffle lines and a sort stage's range read.  The JAX
package runs on its 8-device CPU rig, the port on a mesh of 8 CPU shards;
decisions and reasons must be the JAX package's, records equal.
"""

import uuid

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.plan import cost as ref_cost
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu.runner import _exchange_mesh_gate as ref_gate
from dampr_tpu_torch import settings
from dampr_tpu_torch.plan import cost
from dampr_tpu_torch.runner import MTRunner, _exchange_mesh_gate

_REF = ("partitions", "mesh_fold", "mesh_exchange", "exchange_min_bytes",
        "lower")
_PORT = _REF + ("device", "mesh_devices", "scratch_root")


@pytest.fixture(autouse=True)
def shuffle_env(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old = {n: getattr(settings, n) for n in _PORT}
    settings.device = "cpu"
    settings.mesh_devices = ["cpu"] * 8
    settings.scratch_root = str(tmp_path / "port-scratch")
    settings.partitions = ref_settings.partitions = 8
    settings.mesh_fold = ref_settings.mesh_fold = "off"
    settings.mesh_exchange = ref_settings.mesh_exchange = "auto"
    try:
        yield
    finally:
        for n, v in old_ref.items():
            setattr(ref_settings, n, v)
        for n, v in old.items():
            setattr(settings, n, v)


def _salt(prefix):
    return "%s-%s" % (prefix, uuid.uuid4().hex[:8])


def _both_choices(*args, **kw):
    got = cost.shuffle_choice(*args, **kw)
    assert got == ref_cost.shuffle_choice(*args, **kw)
    return got


class TestShuffleChoice:
    def test_explicit_modes_win(self):
        t, r = _both_choices(None, 8, 8, mode="off")
        assert t == "host" and "mesh_exchange" in r
        t, r = _both_choices({"bytes_in": 10}, 8, 8, mode="on")
        assert t == "mesh" and "forces" in r

    def test_single_device_stays_host(self):
        t, r = _both_choices(None, 1, 8, mode="auto")
        assert t == "host" and "single" in r

    def test_no_history_defaults_mesh(self):
        t, r = _both_choices(None, 8, 8, mode="auto")
        assert t == "mesh" and "no shuffle history" in r

    def test_tiny_history_pins_host(self):
        st = {"bytes_in": settings.exchange_min_bytes - 1}
        t, r = _both_choices(st, 8, 8, mode="auto")
        assert t == "host" and "exchange_min_bytes" in r

    def test_large_history_rides_mesh_with_evidence(self):
        st = {"bytes_in": 64 * 1024 ** 2, "records_in": 1 << 20}
        t, r = _both_choices(st, 8, 32, mode="auto")
        assert t == "mesh"
        assert "B/record" in r and "32 partitions" in r
        assert str(settings.exchange_hbm_budget) in r


class TestGateTargets:
    def test_host_target_declines_in_auto(self):
        assert _exchange_mesh_gate(1 << 20, target="host") is None
        assert ref_gate(1 << 20, target="host") is None

    def test_mesh_target_engages(self):
        gate = _exchange_mesh_gate(1 << 20, target="mesh")
        ref = ref_gate(1 << 20, target="mesh")
        assert gate is not None and ref is not None
        assert gate[1:] == ref[1:] == (8, 1 << 18)

    def test_explicit_off_beats_mesh_target(self):
        settings.mesh_exchange = ref_settings.mesh_exchange = "off"
        assert _exchange_mesh_gate(1 << 20, target="mesh") is None
        assert ref_gate(1 << 20, target="mesh") is None


def _pipe(D, n=3000):
    return (D.memory([(i % 7, i) for i in range(n)], partitions=8)
            .group_by(lambda x: x[0])
            .reduce(lambda k, vs: len(list(vs))))


def _rows(runner, kind):
    return [d for d in runner.plan_report["shuffle"]["targets"]
            if d["kind"] == kind]


class TestPlanReportAndDispatch:
    def test_report_carries_decisions_and_runner_map(self):
        reports = []
        for D, R in ((dampr_tpu.Dampr, RefRunner),
                     (dampr_tpu_torch.Dampr, MTRunner)):
            pipe = _pipe(D)
            runner = R(_salt("shufplan"), pipe.pmer.graph)
            runner.run([pipe.source])
            rep = runner.plan_report["shuffle"]
            assert rep["enabled"] is True
            rows = _rows(runner, "reduce")
            assert rows and all(d["reason"] for d in rows)
            assert rep["mesh_stages"] >= 1
            assert set(runner._shuffle_targets.values()) <= {"mesh", "host"}
            reports.append(rep)
        assert reports[1] == reports[0]

    def test_history_pins_second_run_to_host(self):
        name = _salt("shufpin")
        pipe = _pipe(dampr_tpu_torch.Dampr)
        r1 = MTRunner(name, pipe.pmer.graph)
        out1 = sorted(r1.run([pipe.source])[0].read())
        assert r1.mesh_exchanges >= 1
        pipe2 = _pipe(dampr_tpu_torch.Dampr)
        r2 = MTRunner(name, pipe2.pmer.graph)
        out2 = sorted(r2.run([pipe2.source])[0].read())
        assert out2 == out1
        rows = _rows(r2, "reduce")
        assert rows and rows[0]["target"] == "host"
        assert "exchange_min_bytes" in rows[0]["reason"]
        assert r2.mesh_exchanges == 0
        ref = _pipe(dampr_tpu.Dampr)
        assert sorted(RefRunner(_salt("shufpin"), ref.pmer.graph).run(
            [ref.source])[0].read()) == out1

    def test_forced_on_ignores_tiny_history(self):
        settings.mesh_exchange = "on"
        name = _salt("shufforce")
        for _ in range(2):
            pipe = _pipe(dampr_tpu_torch.Dampr)
            r = MTRunner(name, pipe.pmer.graph)
            r.run([pipe.source])
            assert r.mesh_exchanges >= 1

    def test_stats_exchange_section_and_stage_field(self):
        pipe = _pipe(dampr_tpu_torch.Dampr)
        runner = MTRunner(_salt("shufstats"), pipe.pmer.graph)
        runner.run([pipe.source])
        mesh = runner.run_summary["mesh"]
        ex = mesh["exchange"]
        assert ex["bytes"] == mesh["exchange_bytes"] > 0
        assert ex["steps"] >= 1
        assert 0 < ex["peak_inflight_bytes"] <= ex["hbm_budget"]
        assert ex["mesh_stages"] >= 1
        assert mesh["devices"] == 8 and mesh["exchanges"] == 1
        stages = [st.as_dict() for st in runner.stats]
        assert any(st["shuffle_target"] == "mesh" for st in stages
                   if st["kind"] == "reduce")

    def test_device_lowered_reduce_recorded_not_routed(self):
        settings.lower = ref_settings.lower = "1"
        rows = []
        for D, R in ((dampr_tpu.Dampr, RefRunner),
                     (dampr_tpu_torch.Dampr, MTRunner)):
            pipe = D.memory(list(range(5000)), partitions=8).count(
                lambda x: x % 5)
            runner = R(_salt("shufdev"), pipe.pmer.graph)
            runner.run([pipe.source])
            dev = [d for d in runner.plan_report["shuffle"]["targets"]
                   if d["target"] == "device"]
            assert dev and "collective fold" in dev[0]["reason"]
            assert all(d["sid"] not in runner._shuffle_targets
                       for d in dev)
            rows.append(dev)
        assert rows[1] == rows[0]

    def test_explain_renders_shuffle_lines(self):
        text = _pipe(dampr_tpu_torch.Dampr).explain()
        ref = _pipe(dampr_tpu.Dampr).explain()
        assert "shuffle:" in text
        assert "reduce shuffle -> mesh" in text
        lines = [ln for ln in text.splitlines() if "shuffle" in ln]
        assert lines == [ln for ln in ref.splitlines() if "shuffle" in ln]
        settings.mesh_exchange = "off"
        assert "mesh exchange off" in _pipe(dampr_tpu_torch.Dampr).explain()

    def test_sort_stage_classified_and_hinted(self):
        nums = [((i * 7919) % 10007) for i in range(20000)]
        pipe = dampr_tpu_torch.Dampr.memory(nums, partitions=8).sort_by(
            lambda x: x)
        runner = MTRunner(_salt("shufsort"), pipe.pmer.graph,
                          memory_budget=1 << 16)
        out = runner.run([pipe.source])[0]
        rows = _rows(runner, "sort")
        assert rows and rows[0]["target"] == "mesh"
        assert out.pset.shuffle_target == "mesh"
        assert [v for _k, v in out.read()] == sorted(nums)
