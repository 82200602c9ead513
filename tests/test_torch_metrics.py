"""The port's live metrics plane (``dampr_tpu_torch.obs.metrics``,
``sampler``, ``flightrec``, ``progress``): the port version of
``tests/test_metrics.py``.

Left out, with their queue item (ROADMAP A6, service and tooling):
``TestStatsSurface::test_promtext_render`` (``obs/promtext.py``),
``TestStatsCli`` (the ``dampr-tpu-stats`` CLI and its ``--series``/
``--prom`` flags) and ``TestCheckBench`` (``tools/check_bench.py``'s
trend checks); ``test_counter_tracks_in_trace_and_validator`` reads the
counter events from the trace itself where the JAX test goes through
the CLI's ``load_series``/``format_series``.  The series cap, the flight
recorder's ring and the progress cadence are module constants of the
port (``metrics.SERIES_CAP``, ``flightrec.RING_EVENTS``,
``progress.INTERVAL_MS``), patched where the JAX tests set settings.
"""

import importlib.util
import io
import json
import operator
import os
import threading
import time

import pytest

from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import flightrec, metrics, progress, trace
from dampr_tpu_torch.obs.flightrec import FlightRecorder
from dampr_tpu_torch.obs.metrics import Metrics
from dampr_tpu_torch.obs.progress import ProgressReporter
from dampr_tpu_torch.obs.sampler import Sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "validate_trace", os.path.join(ROOT, "tools", "validate_trace.py"))
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

with open(os.path.join(ROOT, "docs", "trace_schema.json")) as _f:
    TRACE_SCHEMA = json.load(_f)


@pytest.fixture(autouse=True)
def cpu(tmp_path):
    old = (settings.device, settings.scratch_root)
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    yield
    settings.device, settings.scratch_root = old


@pytest.fixture
def metered(tmp_path):
    """Metrics plane and tracing on for one test, artifacts under
    tmp_path."""
    old = (settings.trace, settings.trace_dir, settings.metrics_interval_ms)
    settings.trace = True
    settings.trace_dir = str(tmp_path)
    settings.metrics_interval_ms = 10
    yield tmp_path
    (settings.trace, settings.trace_dir,
     settings.metrics_interval_ms) = old


def _obs_threads():
    return [t.name for t in threading.enumerate()
            if t.name in ("dampr-tpu-sampler", "dampr-tpu-progress")]


class TestDisabledPath:
    def test_no_registry_no_sampler_no_cost(self):
        assert settings.effective_metrics_interval_ms() == 0
        assert not metrics.enabled()
        assert metrics.active() is None
        metrics.counter_add("x", 5)
        metrics.gauge_set("y", 1.0)
        metrics.observe("z", 2.0)
        metrics.register_gauge("w", lambda: 1)
        em = Dampr.memory(list(range(2000))).map(lambda x: (x, 1)).run()
        assert "metrics" not in em.stats()
        assert not _obs_threads()
        em.delete()

    def test_sampler_thread_scoped_to_run(self, metered):
        em = Dampr.memory(list(range(2000))).map(lambda x: (x, 1)).run(
            name="scoped")
        assert not _obs_threads()
        assert em.stats()["metrics"]["sampler"]["samples"] >= 1
        em.delete()

    def test_sampler_thread_scoped_to_a_failed_run(self, metered):
        def boom(x):
            if x == 1500:
                raise RuntimeError("mid-map")
            return (x, 1)

        with pytest.raises(RuntimeError, match="mid-map"):
            Dampr.memory(list(range(2000))).map(boom).run(name="dies")
        assert not _obs_threads()
        assert not metrics.enabled() and not trace.enabled()
        assert flightrec.active() is None


class TestSampler:
    def test_cadence_and_monotonic_timestamps(self):
        m = Metrics("cadence")
        state = {"v": 0}
        m.register_gauge("g", lambda: state["v"])
        s = Sampler(m, interval_ms=10)
        s.start()
        for i in range(10):
            state["v"] = i
            time.sleep(0.02)
        s.stop()
        assert not s.alive
        assert m.sample_count >= 5
        series = m.series["g"]
        ts = [t for t, _v in series]
        assert ts == sorted(ts), "sampler timestamps must be monotonic"
        assert all(t >= 0 for t in ts)
        assert ts[-1] - ts[0] > 0.05
        vals = [v for _t, v in series]
        assert vals[-1] >= vals[0]
        assert m.sample_seconds >= 0
        assert 0 <= m.overhead() < 1

    def test_series_cap_and_drop_count(self, monkeypatch):
        monkeypatch.setattr(metrics, "SERIES_CAP", 8)
        m = Metrics("cap")
        for i in range(50):
            m.record_sample(float(i), {"g": i}, 0.0)
        assert len(m.series["g"]) == 8
        assert m.series_drops == 42
        assert [v for _t, v in m.series["g"]] == list(range(42, 50))

    def test_broken_gauge_dropped_not_fatal(self):
        m = Metrics("broken")

        def bad():
            raise RuntimeError("gauge exploded")

        m.register_gauge("bad", bad)
        m.register_gauge("good", lambda: 7)
        snap = m.snapshot()
        assert snap["good"] == 7 and "bad" not in snap
        assert "bad" not in m.gauge_fns
        assert m.snapshot()["good"] == 7


class TestFlightRecorder:
    def test_ring_bound_under_span_flood(self):
        rec = FlightRecorder("flood", capacity=64)
        for i in range(10000):
            rec.record_span("fold", "s{}".format(i), float(i), 0.001,
                            1, "lane", None)
        assert len(rec) <= 64
        assert rec.drops > 0

    def test_flush_is_schema_valid(self, tmp_path, monkeypatch):
        monkeypatch.setattr(settings, "trace_dir", str(tmp_path))
        rec = FlightRecorder("flush-unit", capacity=32)
        rec.record_span("spill", "w", time.perf_counter(), 0.01, 3,
                        "writer-0", {"bytes": 10})
        rec.record_sample(time.perf_counter(),
                          {"writer.queue_depth": 4, "skip": "str"})
        path = rec.flush("unit-test", ValueError("boom"))
        assert path and os.path.isfile(path)
        with open(path) as f:
            doc = json.load(f)
        assert not validate_trace.validate(doc, TRACE_SCHEMA)
        crash = doc["otherData"]["crash"]
        assert crash["reason"] == "unit-test"
        assert crash["exception"] == "ValueError"
        cvals = [ev for ev in doc["traceEvents"] if ev["ph"] == "C"]
        assert cvals and all(isinstance(ev["args"]["value"], (int, float))
                             for ev in cvals)
        assert not any(ev["name"] == "skip" for ev in cvals)

    def test_injected_stage_failure_leaves_crashdump(self, metered):
        def boom(x):
            if x == 333:
                raise RuntimeError("injected")
            return (x, x)

        with pytest.raises(RuntimeError, match="injected"):
            Dampr.memory(list(range(2000))).map(boom).run(name="inj")
        dump = flightrec.locate_crashdump("inj")
        assert dump and os.path.isfile(dump)
        with open(dump) as f:
            doc = json.load(f)
        assert not validate_trace.validate(doc, TRACE_SCHEMA), (
            validate_trace.validate(doc, TRACE_SCHEMA))
        crash = doc["otherData"]["crash"]
        assert crash["exception"] == "RuntimeError"
        cevents = [ev for ev in doc["traceEvents"] if ev["ph"] == "C"]
        cnames = {ev["name"] for ev in cevents}
        assert "writer.queue_depth" in cnames
        assert "writer.inflight_bytes" in cnames
        xts = [ev["ts"] for ev in doc["traceEvents"] if ev["ph"] == "X"]
        cts = [ev["ts"] for ev in cevents]
        if xts:
            assert max(cts) > 0
            assert max(cts) <= max(xts) + 10e6

    def test_kill_leaves_crashdump(self, metered):
        def kill(x):
            if x == 999:
                raise KeyboardInterrupt()
            return (x, x)

        with pytest.raises(KeyboardInterrupt):
            Dampr.memory(list(range(3000))).map(kill).run(name="killed")
        dump = flightrec.locate_crashdump("killed")
        assert dump and os.path.isfile(dump)
        with open(dump) as f:
            doc = json.load(f)
        assert not validate_trace.validate(doc, TRACE_SCHEMA)
        assert doc["otherData"]["crash"]["exception"] == (
            "KeyboardInterrupt")

    def test_failed_run_summary_names_the_crashdump(self, metered,
                                                    monkeypatch):
        """The summary is built on the failure path too, and names the
        dump the failure path flushed."""
        from dampr_tpu_torch import runner as port_runner

        seen = []
        real = port_runner.MTRunner._finalize_obs

        def finalize(self, *a):
            real(self, *a)
            seen.append(self.run_summary)

        monkeypatch.setattr(port_runner.MTRunner, "_finalize_obs",
                            finalize)

        def boom(x):
            if x == 10:
                raise RuntimeError("dies")
            return (x, x)

        with pytest.raises(RuntimeError):
            Dampr.memory(list(range(100))).map(boom).run(name="named")
        assert seen and seen[0]["crashdump_file"] == \
            flightrec.locate_crashdump("named")
        assert seen[0]["log"]["counts"].get("error") == 1

    def test_healthy_run_leaves_no_crashdump(self, metered):
        em = Dampr.memory(list(range(500))).map(lambda x: (x, 1)).run(
            name="healthy")
        em.delete()
        assert flightrec.locate_crashdump("healthy") is None

    def test_successful_rerun_clears_stale_crashdump(self, metered):
        def flaky(x):
            if x == 7:
                raise RuntimeError("first attempt dies")
            return (x, x)

        with pytest.raises(RuntimeError):
            Dampr.memory(list(range(100))).map(flaky).run(name="rerun")
        assert flightrec.locate_crashdump("rerun") is not None
        em = Dampr.memory(list(range(100))).map(
            lambda x: (x, x)).run(name="rerun")
        em.delete()
        assert flightrec.locate_crashdump("rerun") is None

    def test_zero_ring_builds_no_recorder(self, metered, monkeypatch):
        monkeypatch.setattr(flightrec, "RING_EVENTS", 0)

        def boom(x):
            raise RuntimeError("no ring")

        with pytest.raises(RuntimeError):
            Dampr.memory([1, 2, 3]).map(boom).run(name="noring")
        assert flightrec.locate_crashdump("noring") is None


class TestTraceCounterEvents:
    def test_counter_tracks_in_trace_and_validator(self, metered):
        em = (Dampr.memory(list(range(60000)))
              .map(lambda x: (x % 101, 1))
              .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
              .run(name="tracks"))
        summary = em.stats()
        with open(summary["trace_file"]) as f:
            doc = json.load(f)
        errors = validate_trace.validate(
            doc, TRACE_SCHEMA,
            require_counters=("store.resident_bytes",
                              "writer.queue_depth", "run.active_jobs"))
        assert not errors, errors
        cevents = [ev for ev in doc["traceEvents"] if ev["ph"] == "C"]
        assert cevents
        by_name = {}
        for ev in cevents:
            by_name.setdefault(ev["name"], []).append(ev["ts"])
        for name, ts in by_name.items():
            assert ts == sorted(ts), name
        assert "store.resident_bytes" in by_name
        em.delete()

    def test_missing_required_counter_fails_validation(self):
        doc = {"traceEvents": [
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "main"}},
            {"ph": "C", "pid": 1, "tid": 0, "name": "a", "ts": 1.0,
             "args": {"value": 2}},
        ]}
        errs = validate_trace.validate(doc, TRACE_SCHEMA,
                                       require_counters=("b",))
        assert any("required counter series" in e for e in errs)
        doc["traceEvents"].append(
            {"ph": "C", "pid": 1, "tid": 0, "name": "a", "ts": 0.5,
             "args": {"value": 3}})
        errs = validate_trace.validate(doc, TRACE_SCHEMA)
        assert any("go backwards" in e for e in errs)


class TestStatsSurface:
    def test_summary_metrics_section(self, metered):
        from dampr_tpu_torch.obs import export

        em = (Dampr.memory(list(range(50000)))
              .map(lambda x: (x % 13, 1))
              .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
              .run(name="surface"))
        s = em.stats()
        m = s["metrics"]
        assert m["counters"]["run.jobs_started"] >= 1
        assert m["counters"]["store.records"] > 0
        sm = m["sampler"]
        assert sm["samples"] >= 1
        assert "series_drops" in sm
        assert 0 <= sm["overhead"] < 0.5
        assert "writer_queue_peak" in s["io"]
        assert "sampler overhead" in export.format_summary(s)
        em.delete()

    def test_writer_queue_peak_under_spill_pressure(self, metered):
        from dampr_tpu_torch.ops.text import ParseNumbers
        from dampr_tpu_torch.runner import MTRunner

        path = metered / "nums.txt"
        with open(path, "w") as f:
            for i in range(60000):
                f.write("{}\n".format((i * 2654435761) % (1 << 40)))
        old_dev = settings.use_device
        settings.use_device = False
        try:
            pipe = (Dampr.text(str(path), chunk_size=64 * 1024)
                    .custom_mapper(ParseNumbers())
                    .checkpoint(force=True))
            runner = MTRunner("queue-peak", pipe.pmer.graph,
                              memory_budget=1 << 18)
            out = runner.run([pipe.source])
            n = sum(len(b) for b in out[0].sorted_blocks())
            assert n == 60000
        finally:
            settings.use_device = old_dev
        s = runner.run_summary
        if settings.spill_write_threads > 0:
            assert s["io"]["writer_queue_peak"] >= 1
        assert s["store"]["spilled_bytes"] > 0
        # merge fan-in histogram observed under forced merge pressure
        assert "merge.kway_streams" in s["metrics"]["histograms"]
        out[0].delete()


class TestProgress:
    def test_render_line_and_stream_ticks(self):
        m = Metrics("p")
        m.counter_add("store.records", 1000)
        m.counter_add("store.bytes", 4 * 1024 ** 2)
        buf = io.StringIO()
        rep = ProgressReporter(
            m, lambda: {"sid": 1, "n_stages": 3, "kind": "map",
                        "jobs_total": 8, "jobs_done": 2,
                        "stage_t0": time.time() - 1.0},
            interval_ms=50, stream=buf)
        line = rep.render_line()
        assert "[stage 1/3 map]" in line and "jobs 2/8" in line
        assert "eta" in line
        rep.start()
        time.sleep(0.3)
        rep.stop()
        assert rep.lines >= 2
        assert "[stage 1/3 map]" in buf.getvalue()

    def test_progress_run_end_to_end(self, metered, monkeypatch):
        monkeypatch.setattr(settings, "progress", True)
        monkeypatch.setattr(progress, "INTERVAL_MS", 50)
        em = Dampr.memory(list(range(50000))).map(
            lambda x: (x % 7, 1)).run(name="prog-e2e")
        assert not _obs_threads()
        em.delete()


class TestRecorderWiring:
    def test_tracer_mirrors_into_ring(self):
        t = trace.Tracer("mirror")
        rec = FlightRecorder("mirror", capacity=8)
        t.recorder = rec
        trace.start(t)
        try:
            for _ in range(20):
                with trace.span("fold", "x"):
                    pass
        finally:
            trace.stop(t)
        assert len(t.events) == 20
        assert len(rec) <= 8
        assert rec.drops >= 12
