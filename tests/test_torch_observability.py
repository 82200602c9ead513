"""Run-scoped tracing and stats in the port (``dampr_tpu_torch.obs``): the
port version of ``tests/test_observability.py``, and the traced
TF-IDF-shaped run through both packages.

``test_mesh_fold_emits_collective_spans`` runs on the port's 8-shard CPU
rig, the JAX test's 8 devices.  ``test_checkpoint_spans_on_resume`` is
in ``test_torch_resume.py``.

The TF-IDF run goes through the JAX package with ``settings.lower = "1"``
(its CPU jit leg, as ``tests/test_profile.py`` runs it) and through the
port on the kernels' plain versions (device "cpu", lowering on), traced
and profiled: both traces pass ``tools/validate_trace.py`` against
``docs/trace_schema.json``; their span categories are equal; the port's
summary carries every top-level key of the JAX summary but the sections
of later slices; per-stage ``kind``, ``records_in`` and ``records_out``
are equal.  ``bytes_*`` may differ (lane dtypes differ).
"""

import importlib.util
import json
import math
import operator
import os
import threading

import pytest

import dampr_tpu
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import export, trace
from dampr_tpu_torch.ops import text as port_text

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
def traced(tmp_path):
    """Tracing on for one test, artifacts under tmp_path."""
    old_trace, old_dir = settings.trace, settings.trace_dir
    settings.trace = True
    settings.trace_dir = str(tmp_path)
    yield tmp_path
    settings.trace = old_trace
    settings.trace_dir = old_dir


def _corpus(tmp_path, lines=4000):
    path = tmp_path / "corpus.txt"
    words = ["alpha", "beta", "gamma", "delta", "tok%d" % 7, "zz"]
    with open(path, "w") as f:
        for i in range(lines):
            f.write(" ".join(words[(i + j) % len(words)]
                             for j in range(8)) + "\n")
    return str(path)


def _load_trace(summary):
    assert summary["trace_file"] and os.path.isfile(summary["trace_file"])
    with open(summary["trace_file"]) as f:
        return json.load(f)


def _cats(doc):
    return {ev.get("cat") for ev in doc["traceEvents"]
            if ev.get("ph") in ("X", "i")}


def _obs_threads():
    return [t.name for t in threading.enumerate()
            if t.name in ("dampr-tpu-sampler", "dampr-tpu-progress")]


class TestTracedRuns:
    def test_mesh_fold_emits_collective_spans(self, traced):
        """On the 8-shard rig the associative fold rides the collective
        path and records collective spans."""
        old = settings.mesh_devices
        settings.mesh_devices = "cpu*8"
        try:
            em = (Dampr.memory(list(range(20000)))
                  .map(lambda x: (x % 31, 1))
                  .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
                  .run(name="obs-mesh"))
        finally:
            settings.mesh_devices = old
        out = dict(em.read())
        assert sum(out.values()) == 20000
        doc = _load_trace(em.stats())
        assert "collective" in _cats(doc), _cats(doc)
        em.delete()

    def test_tfidf_shape_kinds_and_schema(self, traced, tmp_path):
        """The block codec -> fold shape emits codec, fold, stage and job
        spans on per-slot lanes, and the trace validates."""
        corpus = _corpus(tmp_path)
        docs = Dampr.text(corpus, chunk_size=16 * 1024)
        em = (docs.custom_mapper(
                  port_text.DocFreq(mode="word", lower=True,
                                    pair_values=False))
              .fold_values(operator.add)
              .run(name="obs-tfidf"))
        counts = dict(em.read())
        assert counts and all(c > 0 for c in counts.values())
        summary = em.stats()
        doc = _load_trace(summary)
        errors = validate_trace.validate(doc, TRACE_SCHEMA)
        assert not errors, errors
        cats = _cats(doc)
        assert {"codec", "fold", "stage", "job"} <= cats, cats
        lanes = [ev for ev in doc["traceEvents"]
                 if ev.get("ph") == "M" and ev["name"] == "thread_name"]
        assert len(lanes) >= 2, lanes
        assert any("codec" in ev["args"]["name"] for ev in lanes), (
            "codec producer threads should appear as their own lanes")
        em.delete()

    def test_sort_spill_merge_kinds_and_attribution(self, traced, tmp_path):
        """A budget-squeezed external sort emits spill and merge spans,
        and the per-stage spill bytes sum to the store's spill volume."""
        from dampr_tpu_torch.ops.text import ParseNumbers
        from dampr_tpu_torch.runner import MTRunner

        path = tmp_path / "nums.txt"
        with open(path, "w") as f:
            for i in range(60000):
                f.write("{}\n".format((i * 2654435761) % (1 << 40)))
        old_fanin, old_dev = settings.merge_fanin, settings.use_device
        settings.merge_fanin = 2
        settings.use_device = False
        try:
            pipe = (Dampr.text(str(path), chunk_size=64 * 1024)
                    .custom_mapper(ParseNumbers())
                    .checkpoint(force=True))
            runner = MTRunner("obs-sort", pipe.pmer.graph,
                              memory_budget=1 << 18)
            out = runner.run([pipe.source])
            n = sum(len(b) for b in out[0].sorted_blocks())
            assert n == 60000
        finally:
            settings.merge_fanin = old_fanin
            settings.use_device = old_dev
        summary = runner.run_summary
        assert summary["store"]["spilled_bytes"] > 0
        assert summary["store"]["merge_gens"] > 0
        assert sum(s["spill_bytes"] for s in summary["stages"]) == \
            summary["store"]["spilled_bytes"]
        assert sum(s["merge_gens"] for s in summary["stages"]) == \
            summary["store"]["merge_gens"]
        doc = _load_trace(summary)
        errors = validate_trace.validate(doc, TRACE_SCHEMA)
        assert not errors, errors
        assert {"spill", "merge", "stage", "job"} <= _cats(doc)
        out[0].delete()


class TestStatsSurface:
    def test_accessor_and_backcompat(self):
        em = Dampr.memory([1, 2, 3]).map(lambda x: x * 2).run()
        assert em.stats and isinstance(em.stats[0], dict)
        assert {"jobs", "records_out", "seconds"} <= set(em.stats[0])
        assert {"bytes_in", "bytes_out", "spill_bytes",
                "records_in"} <= set(em.stats[0])
        summary = em.stats()
        assert summary["schema"] == export.STATS_SCHEMA
        assert summary["stages"] == list(em.stats)
        assert summary["wall_seconds"] >= 0
        assert "devtime" in summary and "store" in summary
        # untraced runs persist nothing
        assert summary["trace_file"] is None
        assert em.stats.trace_file is None and em.stats.stats_file is None
        em.delete()

    def test_stats_json_persisted_and_locatable(self, traced):
        em = Dampr.memory(list(range(100))).map(lambda x: x).run(
            name="obs-locate")
        summary = em.stats()
        spath = summary["stats_file"]
        assert spath and os.path.isfile(spath)
        assert em.stats.stats_file == spath
        assert em.stats.trace_file == summary["trace_file"]
        loaded, path = export.load_stats("obs-locate")
        assert path == spath
        assert loaded["run"] == "obs-locate"
        assert loaded["stages"]
        text = export.format_summary(loaded)
        assert "obs-locate" in text and "trace" in text
        em.delete()

    def test_stats_json_round_trips_to_the_summary(self, traced):
        em = (Dampr.memory(list(range(3000)))
              .map(lambda x: (x % 7, x))
              .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
              .run(name="obs-roundtrip"))
        summary = em.stats()
        loaded, _path = export.load_stats(summary["stats_file"])
        assert loaded == json.loads(json.dumps(summary, default=str))
        em.delete()

    def test_bytes_in_out_tracked_across_stages(self):
        em = (Dampr.memory(list(range(5000)))
              .map(lambda x: (x % 7, x))
              .checkpoint(force=True)
              .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
              .run())
        by_kind = {}
        for s in em.stats:
            by_kind.setdefault(s["kind"], []).append(s)
        assert "reduce" in by_kind
        red = by_kind["reduce"][0]
        assert red["records_in"] > 0 and red["bytes_in"] > 0
        assert red["bytes_out"] > 0
        em.delete()


class TestTracerCore:
    def test_disabled_span_is_shared_noop(self):
        assert not trace.enabled()
        s1 = trace.span("x", "a")
        s2 = trace.span("x", "b", arg=1)
        assert s1 is s2  # the shared no-op: no allocation when off
        with s1:
            pass
        assert trace.now() == 0.0
        it = iter([1, 2])
        assert trace.timed_iter(it, "x", "y") is it

    def test_span_collection_and_lanes(self):
        t = trace.Tracer("unit")
        trace.start(t)
        try:
            with trace.span("cat1", "outer", n=3):
                trace.instant("cat2", "mark")
            with trace.span("cat1", "lane-span", lane="custom lane"):
                pass
        finally:
            trace.stop(t)
        assert not trace.enabled()
        assert {e[0] for e in t.events} == {"cat1", "cat2"}
        assert "custom lane" in t.lane_names.values()
        assert t.span_summary()["cat1"]["count"] == 2
        before = len(t.events)
        with trace.span("cat1", "late"):
            pass
        assert len(t.events) == before

    def test_chrome_export_round_trip(self, tmp_path):
        t = trace.Tracer("unit2")
        trace.start(t)
        try:
            with trace.span("spill", "s", bytes=10):
                pass
            trace.instant("merge", "i")
        finally:
            trace.stop(t)
        path = export.write_trace(t, str(tmp_path / "t.json"))
        with open(path) as f:
            doc = json.load(f)
        errors = validate_trace.validate(doc, TRACE_SCHEMA)
        assert not errors, errors
        phs = [e["ph"] for e in doc["traceEvents"]]
        assert "X" in phs and "i" in phs and "M" in phs


class TestDisabledPath:
    def test_untraced_run_starts_no_thread_and_writes_no_file(
            self, tmp_path, monkeypatch):
        """Off, no piece of the obs layer is even built: no tracer,
        registry, sampler, progress line, recorder, event stream or
        profiler, and nothing lands under the trace directory."""
        from dampr_tpu_torch.obs import (flightrec, log, metrics, profile,
                                         progress, sampler)

        def refuse(*a, **kw):
            raise AssertionError("obs layer built on an untraced run")

        for cls in (trace.Tracer, metrics.Metrics, sampler.Sampler,
                    progress.ProgressReporter, flightrec.FlightRecorder,
                    log.LogStream, profile.Profiler):
            monkeypatch.setattr(cls, "__init__", refuse)
        old = settings.trace_dir
        settings.trace_dir = str(tmp_path / "traces")
        try:
            em = (Dampr.text(_corpus(tmp_path, 500), 4096)
                  .custom_mapper(port_text.DocFreq(mode="word",
                                                   lower=True))
                  .fold_by(lambda kv: kv[0], operator.add,
                           lambda kv: kv[1])
                  .run(name="untraced"))
            assert em.read()
            s = em.stats()
            for key in ("metrics", "profile", "log", "spans", "critpath",
                        "crashdump_file"):
                assert key not in s, key
            assert not _obs_threads()
            assert not os.path.exists(str(tmp_path / "traces"))
            em.delete()
        finally:
            settings.trace_dir = old


def _idf(df, total):
    return df[0], df[1], math.log(1 + float(total) / df[1])


def _tfidf(pkg, text, corpus, out_dir):
    docs = pkg.Dampr.text(corpus, os.path.getsize(corpus) // 3 + 1)
    doc_freq = (docs.custom_mapper(text.DocFreq(mode="word", lower=True,
                                                pair_values=False))
                .fold_values(operator.add))
    return doc_freq.cross_right(docs.len(), _idf,
                                memory=True).sink_tsv(out_dir)


def _sink_lines(d):
    out = []
    for part in sorted(os.listdir(d)):
        with open(os.path.join(d, part)) as f:
            out.extend(f.read().splitlines())
    return sorted(out)


@pytest.fixture
def both_traced(tmp_path):
    """Both packages traced and profiled, lowering forced on, artifacts
    and scratch under tmp_path."""
    names = ("trace", "trace_dir", "profile", "lower", "scratch_root")
    ref_old = {n: getattr(ref_settings, n) for n in names}
    port_old = {n: getattr(settings, n) for n in names}
    # the JAX package's single-device branch for the broadcast (its test
    # mesh has 8 CPU devices; one card has one)
    old_exchange = ref_settings.mesh_exchange
    ref_settings.mesh_exchange = "off"
    for mod, tag, lower in ((ref_settings, "ref", "1"),
                            (settings, "port", "on")):
        mod.trace = True
        mod.profile = True
        mod.lower = lower
        mod.trace_dir = str(tmp_path / (tag + "-traces"))
        mod.scratch_root = str(tmp_path / (tag + "-scratch"))
    yield tmp_path
    ref_settings.mesh_exchange = old_exchange
    for n in names:
        setattr(ref_settings, n, ref_old[n])
        setattr(settings, n, port_old[n])


class TestTracedTfidfAgainstTheJaxPackage:
    def test_traces_categories_keys_and_stages(self, both_traced):
        tmp_path = both_traced
        corpus = _corpus(tmp_path, lines=3000)
        ref_em = _tfidf(dampr_tpu, ref_text, corpus,
                        str(tmp_path / "ref-out")).run(name="obs-tfidf")
        port_em = _tfidf(__import__("dampr_tpu_torch"), port_text, corpus,
                         str(tmp_path / "port-out")).run(name="obs-tfidf")
        assert (_sink_lines(str(tmp_path / "port-out"))
                == _sink_lines(str(tmp_path / "ref-out")))
        ref_s, port_s = ref_em.stats(), port_em.stats()
        ref_doc, port_doc = _load_trace(ref_s), _load_trace(port_s)
        for doc in (ref_doc, port_doc):
            errors = validate_trace.validate(doc, TRACE_SCHEMA)
            assert not errors, errors
        assert port_doc["otherData"]["producer"] == "dampr_tpu_torch.obs"
        assert _cats(port_doc) == _cats(ref_doc), (
            _cats(port_doc) ^ _cats(ref_doc))
        missing = set(ref_s) - set(port_s)
        assert not missing, missing
        assert port_s["critpath"]["run"]["verdict"]
        assert port_s["profile"]["enabled"] is True
        dev = [st for st in port_s["profile"]["stages"] if st["device"]]
        assert dev, port_s["profile"]["stages"]

        def shape(s):
            return [(st["kind"], st["records_in"], st["records_out"])
                    for st in s["stages"]]

        assert shape(port_s) == shape(ref_s)
        assert port_s["device"]["device_stages"] >= 1
        assert port_s["device"]["device_fraction"] == pytest.approx(
            port_s["devtime"]["device"] / port_s["wall_seconds"], rel=1e-3)


class TestByteIdentity:
    def test_results_equal_with_obs_on_and_off(self, tmp_path):
        """Tracing, metrics, the event log and the profiler change no
        record and no sink byte."""
        corpus = _corpus(tmp_path, lines=2500)
        names = ("trace", "trace_dir", "profile", "metrics_interval_ms",
                 "log_level", "lower")
        old = {n: getattr(settings, n) for n in names}
        outs = []
        try:
            for on in (False, True):
                settings.lower = "on"
                settings.trace = on
                settings.profile = on
                settings.metrics_interval_ms = 5 if on else 0
                settings.log_level = "debug" if on else ""
                settings.trace_dir = str(tmp_path / "traces")
                out_dir = str(tmp_path / ("on" if on else "off"))
                em = _tfidf(__import__("dampr_tpu_torch"), port_text,
                            corpus, out_dir).run(name="ident")
                em2 = (Dampr.memory(list(range(3000)))
                       .map(lambda x: (x % 11, x))
                       .fold_by(lambda kv: kv[0], operator.add,
                                lambda kv: kv[1])
                       .run(name="ident2"))
                outs.append((_sink_lines(out_dir), em2.read(),
                             "metrics" in em.stats()))
                em2.delete()
        finally:
            for n in names:
                setattr(settings, n, old[n])
        assert outs[0][:2] == outs[1][:2]
        assert outs[0][2] is False and outs[1][2] is True
