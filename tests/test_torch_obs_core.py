"""The observability layer's pure functions, held against the JAX
package's on the same scripted input.

Each case feeds one seeded script through both packages' functions and
requires equal output.  Fields that name the producing package are
masked: ``otherData.producer``, the ``process_name`` metadata event's
name, and file paths.  Clocks are patched to the same script on both
sides, so timestamps are equal too.  Tolerance: exact.
"""

import copy
import json
import os
import random
import threading

import numpy as np
import pytest

from dampr_tpu import base as ref_base
from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import critpath as ref_critpath
from dampr_tpu.obs import export as ref_export
from dampr_tpu.obs import flightrec as ref_flightrec
from dampr_tpu.obs import log as ref_log
from dampr_tpu.obs import metrics as ref_metrics
from dampr_tpu.obs import profile as ref_profile
from dampr_tpu.obs import trace as ref_trace
from dampr_tpu.ops import devtime as ref_devtime
from dampr_tpu.ops import segment as ref_segment
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import base as port_base
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.obs import critpath as port_critpath
from dampr_tpu_torch.obs import export as port_export
from dampr_tpu_torch.obs import flightrec as port_flightrec
from dampr_tpu_torch.obs import log as port_log
from dampr_tpu_torch.obs import metrics as port_metrics
from dampr_tpu_torch.obs import profile as port_profile
from dampr_tpu_torch.obs import trace as port_trace
from dampr_tpu_torch.ops import devtime as port_devtime
from dampr_tpu_torch.ops import segment as port_segment
from dampr_tpu_torch.ops import text as port_text


class _Clock(object):
    """A scripted ``time`` module: ``perf_counter`` steps by a seeded
    pseudo-random increment each read, ``time`` is fixed."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self._t = 1000.0

    def perf_counter(self):
        self._t += self._rng.randint(1, 2000) / 1e6
        return self._t

    def time(self):
        return 1.7e9

    def strftime(self, *a):
        import time

        return time.strftime(*a)

    def localtime(self, *a):
        import time

        return time.localtime(*a)


def _masked(doc):
    doc = copy.deepcopy(doc)
    other = doc.get("otherData", {})
    other.pop("producer", None)
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            ev["args"]["name"] = "<masked>"
    return doc


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def clocks(monkeypatch):
    """Both packages' obs modules on one clock script each, equal seeds."""
    def patch(mods, seed):
        clock = _Clock(seed)
        for mod in mods:
            monkeypatch.setattr(mod, "time", clock)
        return clock

    return patch


def _script_spans(trace_mod):
    """One seeded span script through a package's module-level API."""
    rng = random.Random(7)
    t = trace_mod.Tracer("obs-core")
    trace_mod.start(t)
    try:
        for i in range(40):
            kind = rng.choice(["span", "instant", "complete", "lane"])
            cat = rng.choice(["codec", "fold", "stall", "spill", "merge",
                              "device", "handoff", "hbm", "job", "stage"])
            if kind == "span":
                with trace_mod.span(cat, "s{}".format(i), records=i):
                    pass
            elif kind == "instant":
                trace_mod.instant(cat, "i{}".format(i))
            elif kind == "complete":
                trace_mod.complete(cat, "c{}".format(i), trace_mod.now(),
                                   lane="stages", jobs=i % 3)
            else:
                with trace_mod.span(cat, "l{}".format(i),
                                    lane="merge gen {}".format(i % 2)):
                    pass
        items = list(trace_mod.timed_iter(iter(range(5)), "codec", "win"))
        assert items == list(range(5))
    finally:
        trace_mod.stop(t)
    return t


def _sample_script(metrics_mod):
    m = metrics_mod.Metrics("obs-core")
    rng = random.Random(11)
    for i in range(30):
        m.counter_add("store.records", rng.randint(0, 1000))
        m.counter_add("store.bytes", rng.randint(0, 1 << 20))
        m.gauge_set("run.stage", i % 4)
        m.observe("merge.fanin", rng.randint(2, 16))
        m.record_sample(i * 0.01, {"store.resident_bytes": rng.randint(
            0, 1 << 24), "writer.queue_depth": rng.randint(0, 5),
            "flag": True, "label": "text"}, 0.0001)
    return m


class TestTraceExport:
    def test_write_trace_equal(self, clocks, tmp_path):
        clocks([ref_trace], 3)
        ref = _script_spans(ref_trace)
        clocks([port_trace], 3)
        port = _script_spans(port_trace)
        a = ref_export.write_trace(ref, str(tmp_path / "ref.json"),
                                   metrics=_sample_script(ref_metrics))
        b = port_export.write_trace(port, str(tmp_path / "port.json"),
                                    metrics=_sample_script(port_metrics))
        ref_doc, port_doc = _load(a), _load(b)
        assert port_doc["otherData"]["producer"] == "dampr_tpu_torch.obs"
        assert _masked(port_doc) == _masked(ref_doc)
        assert port_doc["traceEvents"]

    def test_span_summary_equal(self, clocks):
        clocks([ref_trace], 5)
        ref = _script_spans(ref_trace)
        clocks([port_trace], 5)
        port = _script_spans(port_trace)
        assert port.span_summary() == ref.span_summary()


class TestMetricsSummary:
    def test_summary_equal(self, clocks):
        clocks([ref_metrics], 9)
        ref = _sample_script(ref_metrics)
        clocks([port_metrics], 9)
        port = _sample_script(port_metrics)
        assert port.summary() == ref.summary()

    def test_series_cap_equal(self, clocks, monkeypatch):
        monkeypatch.setattr(ref_settings, "metrics_series_cap", 8)
        monkeypatch.setattr(port_metrics, "SERIES_CAP", 8)
        clocks([ref_metrics], 1)
        ref = _sample_script(ref_metrics)
        clocks([port_metrics], 1)
        port = _sample_script(port_metrics)
        assert port.series == ref.series
        assert port.series_drops == ref.series_drops == 4 * 22
        assert port.summary() == ref.summary()


def _corrupt_events(path, seed):
    rng = random.Random(seed)
    good = {"ts": 1.0, "level": "warn", "rank": 0, "run": "r",
            "stage": None, "code": "codec-fallback", "msg": "m"}
    lines = []
    for i in range(60):
        roll = rng.random()
        if roll < 0.5:
            rec = dict(good, msg="ok {}".format(i),
                       level=rng.choice(["debug", "info", "warn", "error"]),
                       stage=rng.choice([None, 1, 2]),
                       ts=1.7e9 + i)
            lines.append(json.dumps(rec))
        elif roll < 0.6:
            lines.append("torn-li")
        elif roll < 0.7:
            lines.append(json.dumps({"level": "loud", "code": "x"}))
        elif roll < 0.8:
            lines.append('["a", "list"]')
        elif roll < 0.9:
            lines.append("")
        else:
            lines.append(json.dumps({"level": "info"}))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


class TestLogReads:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_valid_line_tail_and_format_equal(self, tmp_path, seed):
        path = str(tmp_path / "events.jsonl")
        lines = _corrupt_events(path, seed)
        for ln in lines:
            assert port_log.valid_line(ln) == ref_log.valid_line(ln)
        for n, floor in ((20, None), (5, "warn"), (0, None),
                         (100, "error")):
            got = port_log.tail(path, n=n, min_level=floor)
            want = ref_log.tail(path, n=n, min_level=floor)
            assert got == want
            assert port_log.format_tail(got) == ref_log.format_tail(want)
        assert "DAMPR_TPU_TORCH_LOG" in port_log.format_tail([])

    def test_event_codes_are_the_jax_packages(self):
        for code, meaning in port_log.EVENT_CODES.items():
            assert ref_log.EVENT_CODES[code] == meaning


class TestFlightRecorder:
    def _script(self, mod, run):
        rng = random.Random(21)
        rec = mod.FlightRecorder(run, capacity=48)
        base = 5000.0
        for i in range(80):
            if rng.random() < 0.7:
                rec.record_span(
                    rng.choice(["spill", "fold", "codec"]),
                    "s{}".format(i), base + i * 0.01,
                    rng.choice([None, 0.002]), rng.choice([1, 2, "lane x"]),
                    rng.choice(["writer-0", None, "codec"]),
                    rng.choice([None, {"bytes": i}]))
            else:
                rec.record_sample(base + i * 0.01, {
                    "writer.queue_depth": rng.randint(0, 4),
                    "skip": "str", "flag": False})
        rec.record_log({"ts": 1.0, "level": "warn", "rank": 0, "run": run,
                        "code": "writer-pool-stuck", "msg": "m"})
        return rec

    def test_flush_equal(self, clocks, tmp_path, monkeypatch):
        monkeypatch.setattr(ref_settings, "trace_dir", str(tmp_path / "r"))
        monkeypatch.setattr(port_settings, "trace_dir", str(tmp_path / "p"))
        clocks([ref_flightrec], 2)
        ref = self._script(ref_flightrec, "crash-eq")
        clocks([port_flightrec], 2)
        port = self._script(port_flightrec, "crash-eq")
        a = ref.flush("unit", ValueError("boom"))
        b = port.flush("unit", ValueError("boom"))
        assert a.startswith(str(tmp_path / "r"))
        assert b == os.path.join(str(tmp_path / "p"), "crash-eq", "trace",
                                 "crashdump.json")
        ref_doc, port_doc = _load(a), _load(b)
        assert port_doc["otherData"]["producer"] == \
            "dampr_tpu_torch.obs.flightrec"
        assert _masked(port_doc) == _masked(ref_doc)
        assert port.drops == ref.drops > 0
        assert port_flightrec.locate_crashdump("crash-eq") == b


class TestUnionSeconds:
    @pytest.mark.parametrize("seed", range(6))
    def test_equal_on_random_intervals(self, seed):
        rng = np.random.RandomState(seed)
        n = rng.randint(0, 200)
        t0 = rng.uniform(0, 10, size=n)
        dur = rng.exponential(0.5, size=n) * (rng.rand(n) > 0.1)
        ivs = [(float(a), float(a + d)) for a, d in zip(t0, dur)]
        got = port_devtime.union_seconds(ivs)
        assert got == ref_devtime.union_seconds(ivs)
        assert got <= (max(b for _a, b in ivs) - min(a for a, _b in ivs)
                       if ivs else 0.0) + 1e-12


def _critpath_events(seed):
    rng = random.Random(seed)
    events = []
    t = 0.0
    for sid in range(1, 4):
        s0 = t
        for _ in range(rng.randint(5, 30)):
            cat = rng.choice(["codec", "fold", "spill", "spill_queue",
                              "io_wait", "merge", "hbm", "handoff",
                              "stall", "device", "collective", "job"])
            name = rng.choice(["pipe-wait", "writer-backpressure",
                               "read-wait", "drain", "x"])
            a = s0 + rng.uniform(0, 2)
            events.append((cat, name, a, rng.uniform(0, 0.5), 1, None))
        t = s0 + 2.5
        events.append(("stage", "s{}:map".format(sid), s0, t - s0,
                       "stages", None))
        events.append(("retry", "job", s0, None, 1, None))
    return events


class TestCritpath:
    @pytest.mark.parametrize("seed", range(4))
    def test_analyze_equal(self, seed):
        events = _critpath_events(seed)
        summary = {"wall_seconds": 8.0}
        got = port_critpath.analyze(summary, events)
        assert got == ref_critpath.analyze(summary, events)
        assert got["source"] == "spans" and got["stages"]
        chrome = [{"ph": "X" if d is not None else "i", "cat": c,
                   "name": n, "ts": t0 * 1e6,
                   "dur": (d or 0) * 1e6} for c, n, t0, d, _l, _a in events]
        assert (port_critpath.analyze(summary, chrome)
                == ref_critpath.analyze(summary, chrome))

    def test_summary_only_equal(self):
        summary = {"wall_seconds": 4.0,
                   "devtime": {"codec_wait": 0.5},
                   "io": {"io_wait_fraction": 0.2,
                          "io_wait_write_fraction": 0.05},
                   "device": {"device_fraction": 0.3},
                   "stages": [{"stage": 1, "kind": "map", "seconds": 2.0,
                               "target": "device"},
                              {"stage": 2, "kind": "reduce",
                               "seconds": 1.0, "target": "host"}]}
        assert (port_critpath.analyze(summary, [])
                == ref_critpath.analyze(summary, []))


def _named(x):
    return x


def tf(x):
    return x


def _ops(base, text, segment):
    return [base.Map(_named), base.Map(lambda x: x), base.ValueMap(tf),
            base.MapValues(tf), base.MapKeys(tf), base.Filter(tf),
            base.FlatMap(tf), base.Rekey(tf), base.Prefix(tf),
            base.Suffix(tf), base.Inspect(), base.Reduce(tf),
            base.AssocFoldReducer(segment.SUM),
            text.DocFreq(mode="word", lower=True, pair_values=False),
            text.TokenCounts(mode="word", lower=True)]


class TestOpLabels:
    def test_op_label_and_chain_labels_equal(self):
        ref_ops = _ops(ref_base, ref_text, ref_segment)
        port_ops = _ops(port_base, port_text, port_segment)
        for i, (a, b) in enumerate(zip(ref_ops, port_ops)):
            assert port_profile.op_label(b) == ref_profile.op_label(a)
            assert (port_profile.op_label(b, i)
                    == ref_profile.op_label(a, i))
        assert (port_profile.chain_labels(port_ops)
                == ref_profile.chain_labels(ref_ops))

    def test_profiler_summary_equal(self):
        summaries = []
        for mod in (ref_profile, port_profile):
            p = mod.Profiler("t")
            p.begin_stage(1, "map", provenance=["map[A]", "map[B]"])
            rng = random.Random(4)
            for _ in range(20):
                p.op_add(rng.choice(["0:A", "1:B", "combine"]),
                         rng.randint(1, 100) / 1e3,
                         records=rng.randint(0, 50))
                p.device_add(rng.choice(["build", "h2d", "compute", "d2h"]),
                             rng.randint(1, 100) / 1e3,
                             rng.randint(0, 1 << 16))
                p.job_add(rng.randint(50, 200) / 1e3)
            p.begin_stage(2, "reduce")
            p.op_add("reduce:Reduce(tf)", 0.5, records=3)
            summaries.append(p.summary({1: 2.0, 2: 1.0}))
        assert summaries[1] == summaries[0]


def test_devtime_buckets_are_the_jax_packages():
    assert set(port_devtime.snapshot()) == set(ref_devtime.snapshot())


def test_trace_lanes_name_their_threads():
    """A span on a named thread gets that thread's name as its lane, in
    both packages."""
    names = []
    for mod in (ref_trace, port_trace):
        t = mod.Tracer("lanes")
        mod.start(t)

        def work():
            with mod.span("job", "x"):
                pass

        th = threading.Thread(target=work, name="dampr-job_0")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        mod.stop(t)
        names.append(sorted(t.lane_names.values()))
    assert names[0] == names[1] == ["dampr-job_0"]
