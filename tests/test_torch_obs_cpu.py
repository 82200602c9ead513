"""Host time split into CPU work and waits: thread CPU on the tracer's
spans, self time, the lowered sink's phases and the keyed calls as
spans, the phase and keyed CPU counters, and the lane thread ids and
wall-clock anchor that join a trace to a profiler's.

The pipelines run on the CPU (``device="cpu"``, lowering forced, the
kernels' plain versions); their records are held against the JAX
package's on the same seeded input, exactly."""

import importlib.util
import json
import operator
import os
import threading
import time

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import settings
from dampr_tpu_torch.obs import trace
from dampr_tpu_torch.ops import handoff as port_handoff
from dampr_tpu_torch.ops import lower as port_lower
from dampr_tpu_torch.ops import text as port_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "validate_trace", os.path.join(ROOT, "tools", "validate_trace.py"))
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

with open(os.path.join(ROOT, "docs", "trace_schema.json")) as _f:
    TRACE_SCHEMA = json.load(_f)

_PORT = ("device", "lower", "handoff", "trace", "trace_dir", "profile",
         "scratch_root", "_MIN_BATCH_FLOOR")


@pytest.fixture
def port(tmp_path, monkeypatch):
    """The port on the CPU with lowering forced and the card's route
    (classic batches seed the vocabulary, then the table program), so one
    DocFreq job runs every sink phase; keyed blocks of a test-sized
    corpus reach the device path."""
    old = {n: getattr(settings, n) for n in _PORT}
    settings.device = "cpu"
    settings.lower = "on"
    settings.handoff = "auto"
    settings.scratch_root = str(tmp_path / "scratch")
    settings.trace_dir = str(tmp_path / "traces")
    settings._MIN_BATCH_FLOOR = 256
    monkeypatch.setattr(port_handoff, "_host_bootstrap", lambda: False)
    yield settings
    for n, v in old.items():
        setattr(settings, n, v)


def _corpus(tmp_path, seed=11, n_lines=3000, vocab=400):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(vocab)] + ["Tok_1", "UPPER", "a"]
    path = str(tmp_path / "corpus.txt")
    with open(path, "w") as f:
        for _ in range(n_lines):
            f.write(" ".join(rng.choice(words, size=rng.randint(1, 12)))
                    + "\n")
    return path


def _docfreq(pkg, text, corpus):
    return (pkg.Dampr.text(corpus, os.path.getsize(corpus) // 3 + 1)
            .custom_mapper(text.DocFreq(mode="word", lower=True,
                                        pair_values=False))
            .fold_values(operator.add))


def _wc(pkg, corpus):
    return (pkg.Dampr.text(corpus, os.path.getsize(corpus) // 3 + 1)
            .flat_map(lambda line: line.split())
            .fold_by(lambda w: w, binop=operator.add, value=lambda w: 1))


def _run(pipe, name):
    em = pipe.run(name=name)
    got = sorted(em.read())
    stats = em.stats()
    em.delete()
    return got, stats


def _ref(kind, corpus, tmp_path):
    old = ref_settings.scratch_root
    ref_settings.scratch_root = str(tmp_path / "ref-scratch")
    try:
        pipe = (_docfreq(dampr_tpu, ref_text, corpus) if kind == "docfreq"
                else _wc(dampr_tpu, corpus))
        return _run(pipe, "ref-" + kind)[0]
    finally:
        ref_settings.scratch_root = old


class TestSpanCpu:
    @pytest.mark.parametrize("work,lo,hi", [
        ("sleep", 0.0, 0.2), ("busy", 0.8, 1.0 + 1e-9)])
    def test_cpu_share_of_a_span(self, work, lo, hi):
        """A span's ``cpu`` is its thread's time on a core: next to none
        around a sleep, nearly all of it around a busy loop.  A loaded
        host may take the core from the loop, so it has a few tries."""
        for _ in range(5):
            t = trace.Tracer("cpu")
            trace.start(t)
            try:
                with trace.span("job", work):
                    if work == "sleep":
                        time.sleep(0.05)
                    else:
                        end = time.perf_counter() + 0.05
                        while time.perf_counter() < end:
                            pass
            finally:
                trace.stop(t)
            (ev,) = t.events
            dur, cpu = ev[3], ev[6]
            assert dur >= 0.05 and 0 <= cpu <= dur
            if lo * dur <= cpu <= hi * dur:
                break
        assert lo * dur <= cpu <= hi * dur, (cpu, dur)

    def test_complete_carries_cpu_from_its_own_threads_stamp(self):
        """``now()`` stamps the thread's CPU clock: ``complete`` on the
        same thread records ``cpu``; a stamp from another thread (a queue
        wait measured across threads) records none."""
        t = trace.Tracer("stamp")
        trace.start(t)
        try:
            t0 = trace.now()
            trace.complete("merge", "same", t0)
            box = []
            th = threading.Thread(target=lambda: box.append(trace.now()))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive() and box
            trace.complete("spill_queue", "across", box[0])
        finally:
            trace.stop(t)
        same, across = t.events
        assert same[6] is not None and 0 <= same[6] <= same[3] + 1e-6
        assert across[6] is None

    def test_off_no_clock_is_read(self, monkeypatch):
        """Off, a span, ``now``/``complete`` and ``timed_iter`` read no
        clock of any kind."""
        def refuse():
            raise AssertionError("a clock was read with tracing off")

        monkeypatch.setattr(time, "thread_time", refuse)
        monkeypatch.setattr(time, "perf_counter", refuse)
        assert not trace.enabled()
        with trace.span("job", "x"):
            pass
        trace.complete("job", "y", trace.now())
        assert list(trace.timed_iter(iter(range(3)), "codec", "w")) == [
            0, 1, 2]


class TestSelfTime:
    def test_children_partition_the_parent(self):
        """Nested spans on one thread: the parent's self time is its
        interval less its direct children's, and a grandchild counts
        against its own parent only."""
        t = trace.Tracer("self")
        trace.start(t)
        try:
            with trace.span("job", "parent"):
                time.sleep(0.005)
                with trace.span("fold", "a"):
                    time.sleep(0.005)
                    with trace.span("device", "inner"):
                        time.sleep(0.005)
                with trace.span("fold", "b"):
                    time.sleep(0.005)
        finally:
            trace.stop(t)
        dur = {ev[1]: ev[3] for ev in t.events}
        s = t.span_summary()
        assert s["job"]["self_seconds"] == pytest.approx(
            dur["parent"] - dur["a"] - dur["b"], abs=2e-6)
        assert s["fold"]["self_seconds"] == pytest.approx(
            dur["a"] + dur["b"] - dur["inner"], abs=2e-6)
        assert s["device"]["self_seconds"] == pytest.approx(
            dur["inner"], abs=2e-6)
        total_self = sum(v["self_seconds"] for v in s.values())
        assert total_self == pytest.approx(dur["parent"], abs=4e-6)
        for v in s.values():
            assert 0 <= v["self_cpu_seconds"] <= v["cpu_seconds"] + 1e-9

    def test_other_threads_span_on_the_lane_is_not_a_child(self):
        """Nesting follows the recording thread, not the display lane: a
        span another thread records on the same explicit lane inside the
        parent's interval leaves the parent's self time whole."""
        t = trace.Tracer("lanes")
        trace.start(t)

        def other():
            with trace.span("fold", "other", lane="shared"):
                time.sleep(0.01)

        try:
            with trace.span("job", "parent", lane="shared"):
                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=10)
                assert not th.is_alive()
        finally:
            trace.stop(t)
        parent = [ev for ev in t.events if ev[1] == "parent"][0]
        s = t.span_summary()
        assert s["job"]["self_seconds"] == pytest.approx(parent[3],
                                                         abs=2e-6)
        assert s["fold"]["self_seconds"] >= 0.01


class TestWallAnchor:
    def test_narrowest_bracket_wins(self, monkeypatch):
        """``wall_start`` is the wall read of the narrowest of three
        ``perf_counter`` brackets, ``epoch`` that bracket's middle, and
        the width in microseconds is ``wall_start_err_us``."""
        perf = iter([10.0, 10.000005, 20.0, 20.000002, 30.0, 30.000003])
        wall = iter([1.0e9, 2.0e9, 3.0e9])

        class Clock(object):
            def perf_counter(self):
                return next(perf)

            def time(self):
                return next(wall)

        monkeypatch.setattr(trace, "time", Clock())
        t = trace.Tracer("anchor")
        assert t.wall_start == 2.0e9
        assert t.epoch == pytest.approx(20.000001)
        assert t.wall_start_err_us == pytest.approx(2.0)


def _span_names(doc):
    return {(ev["cat"], ev["name"]) for ev in doc["traceEvents"]
            if ev.get("ph") == "X"}


class TestLoweredDocFreq:
    def test_off_never_reads_thread_cpu(self, port, tmp_path, monkeypatch):
        """With tracing and profiling off, a lowered DocFreq job and a
        keyed word count read no thread CPU clock."""
        def refuse():
            raise AssertionError("thread_time read with tracing off")

        corpus = _corpus(tmp_path, n_lines=800)
        monkeypatch.setattr(time, "thread_time", refuse)
        got, stats = _run(_docfreq(dampr_tpu_torch, port_text, corpus), "off-docfreq")
        assert got and stats["device"]["device_stages"] >= 1
        assert "host_phase_cpu_seconds" not in stats["device"]
        got, stats = _run(_wc(dampr_tpu_torch, corpus),
                          "off-wc")
        assert got and stats["device"]["keyed"]
        assert all("cpu_seconds" not in c
                   for c in stats["device"]["keyed"].values())

    def test_traced_phases_counters_lanes_schema_and_records(
            self, port, tmp_path):
        corpus = _corpus(tmp_path)
        want = _ref("docfreq", corpus, tmp_path)
        untraced, _ = _run(_docfreq(dampr_tpu_torch,
                                    port_text, corpus), "df-untraced")
        settings.trace = True
        got, stats = _run(_docfreq(dampr_tpu_torch,
                                   port_text, corpus), "df-traced")
        assert untraced == want
        assert got == want
        with open(stats["trace_file"]) as f:
            doc = json.load(f)
        names = _span_names(doc)
        for span in (("codec", "sink-scan"), ("codec", "sink-pad"),
                     ("fold", "sink-decode"), ("handoff", "absorb"),
                     ("device", "map-fold"), ("device", "drain"),
                     ("handoff", "table-probe"),
                     ("handoff", "table-drain")):
            assert span in names, (span, sorted(names))
        dev = stats["device"]
        assert set(dev["host_phase_cpu_seconds"]) == set(
            dev["host_phase_seconds"]) == set(port_lower.PHASES)
        for p, wall in dev["host_phase_seconds"].items():
            assert 0 <= dev["host_phase_cpu_seconds"][p] <= wall + 1e-6, p
        assert dev["host_phase_cpu_seconds"]["absorb"] > 0
        lanes = {ev["tid"] for ev in doc["traceEvents"]
                 if ev.get("ph") in ("X", "i", "M") and ev["tid"]}
        native = doc["otherData"]["lane_native_tid"]
        ident = doc["otherData"]["lane_thread_ident"]
        assert set(native) == set(ident) == {str(t) for t in lanes}
        assert all(isinstance(v, int) and v > 0 for v in native.values())
        assert all(isinstance(v, int) and v > 0 for v in ident.values())
        assert doc["otherData"]["wall_start_err_us"] >= 0
        assert validate_trace.validate(doc, TRACE_SCHEMA) == []
        jobs = [ev["args"] for ev in doc["traceEvents"]
                if ev.get("cat") == "job"]
        assert jobs and all({"job", "stage", "cpu"} <= set(a) for a in jobs)
        spans = stats["spans"]
        for v in spans.values():
            assert {"cpu_seconds", "self_seconds",
                    "self_cpu_seconds"} <= set(v)
            assert v["self_seconds"] <= v["seconds"] + 1e-6


    def test_codec_windows_carry_their_job(self, port, tmp_path):
        """Off the handoff the overlap producer yields each window's
        blocks: every ``codec-window`` span names the index of the job it
        feeds, one of the stage's ``job`` spans."""
        settings.handoff = "off"
        settings.trace = True
        corpus = _corpus(tmp_path, seed=3, n_lines=1500)
        got, stats = _run(_docfreq(dampr_tpu_torch, port_text, corpus),
                          "df-windows")
        assert got == _ref("docfreq", corpus, tmp_path)
        with open(stats["trace_file"]) as f:
            evs = json.load(f)["traceEvents"]
        jobs = {ev["args"]["job"] for ev in evs if ev.get("cat") == "job"}
        windows = [ev["args"] for ev in evs
                   if ev.get("name") == "codec-window"]
        assert windows and {a["job"] for a in windows} <= jobs


class TestKeyedWordCount:
    def test_traced_profiled_cells_carry_cpu(self, port, tmp_path):
        """A traced and profiled word count: every keyed op's cell and
        every profiler op cell has its thread CPU, never over its
        seconds; each keyed call is a ``device:keyed-<op>`` span; the
        records equal the JAX package's."""
        corpus = _corpus(tmp_path, seed=5)
        want = _ref("wc", corpus, tmp_path)
        settings.trace = settings.profile = True
        got, stats = _run(_wc(dampr_tpu_torch, corpus),
                          "wc-traced")
        assert got == want
        keyed = stats["device"]["keyed"]
        assert keyed
        for op, cell in keyed.items():
            assert 0 <= cell["cpu_seconds"] <= cell["seconds"] + 1e-6, op
        ops = [op for st in stats["profile"]["stages"] for op in st["ops"]]
        assert ops
        for op in ops:
            assert 0 <= op["cpu_seconds"] <= op["seconds"] + 1e-6, op
        with open(stats["trace_file"]) as f:
            names = _span_names(json.load(f))
        assert {("device", "keyed-" + op) for op in keyed} <= names
