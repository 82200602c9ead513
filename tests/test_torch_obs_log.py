"""The port's structured log stream (``dampr_tpu_torch.obs.log``): the
port version of ``tests/test_obs_log.py`` (record shape and level floor,
capacity compaction, tolerant reads, the disabled-path pin, the stdlib
warn mirror, run integration, the crashdump's log tail), plus the coded
events the port's warning sites now emit.  ``flight_recorder_events`` is
the port's module constant ``flightrec.RING_EVENTS``.
"""

import json
import logging
import operator
import os

import pytest

from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import flightrec
from dampr_tpu_torch.obs import log as obslog
from dampr_tpu_torch.obs.flightrec import FlightRecorder
from dampr_tpu_torch.obs.log import LogStream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(ROOT, "docs", "trace_schema.json")) as _f:
    _LOG_ITEM_SCHEMA = (json.load(_f)["properties"]["otherData"]
                        ["properties"]["log"]["items"])


@pytest.fixture(autouse=True)
def cpu(tmp_path):
    old = (settings.device, settings.scratch_root)
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    yield
    settings.device, settings.scratch_root = old


@pytest.fixture
def logged(tmp_path):
    """Structured logging on (debug) with isolated artifacts."""
    old = (settings.log_level, settings.trace_dir, settings.scratch_root)
    settings.log_level = "debug"
    settings.trace_dir = str(tmp_path / "traces")
    settings.scratch_root = str(tmp_path / "scratch")
    yield tmp_path
    (settings.log_level, settings.trace_dir, settings.scratch_root) = old


class TestLogStream:
    def test_record_shape_and_floor(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        s = LogStream("r", rank=1, level="info", path=path)
        assert s.emit("debug", "run-start", "below floor") is None
        rec = s.emit("warn", "codec-fallback", "zstd gone", stage=3,
                     data={"codec": "zstd"})
        for key in ("ts", "level", "rank", "run", "stage", "code", "msg"):
            assert key in rec, key
        assert rec["level"] == "warn" and rec["rank"] == 1
        assert rec["code"] == "codec-fallback" and rec["stage"] == 3
        assert rec["data"] == {"codec": "zstd"}
        assert s.counts == {"warn": 1}
        assert s.summary()["records"] == 1
        assert s.summary()["level"] == "info"
        # one valid JSONL line on disk
        recs = obslog.tail(path)
        assert len(recs) == 1 and recs[0]["code"] == "codec-fallback"

    def test_capacity_compaction_bounds_the_file(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        s = LogStream("r", level="debug", path=path, capacity=16)
        # Compaction checks are amortized (every max(64, cap//8)
        # appends), so overshoot well past one check interval.
        for i in range(200):
            s.emit("info", "run-start", "event %d" % i)
        with open(path) as f:
            lines = f.readlines()
        assert len(lines) <= 16 + 64, len(lines)
        s._compact_if_over()
        with open(path) as f:
            lines = f.readlines()
        assert len(lines) <= 16
        # newest records survive
        assert obslog.tail(path, n=1)[0]["msg"] == "event 199"

    def test_zero_capacity_disables_disk(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        s = LogStream("r", level="debug", path=path, capacity=0)
        s.emit("info", "run-start", "x")
        assert s.path is None and not os.path.exists(path)

    def test_warn_mirrors_into_recorder(self, tmp_path):
        rec = FlightRecorder("r", 64)
        s = LogStream("r", level="info", path=None, recorder=rec)
        s.emit("info", "run-start", "not mirrored")
        s.emit("warn", "writer-pool-stuck", "mirrored")
        s.emit("error", "run-failed", "mirrored too")
        tail = list(rec._log)
        assert [r["code"] for r in tail] == ["writer-pool-stuck",
                                             "run-failed"]

    def test_floor_above_warn_still_mirrors(self, tmp_path):
        """A stream floored at error must still push warns into the
        crash tail (the crashdump is the record of last resort)."""
        rec = FlightRecorder("r", 64)
        s = LogStream("r", level="error", path=None, recorder=rec)
        assert s.emit("warn", "codec-fallback", "dropped on disk") is None
        assert [r["code"] for r in rec._log] == ["codec-fallback"]


class TestTolerantReads:
    def test_valid_line_rejects_garbage(self):
        assert obslog.valid_line("") is None
        assert obslog.valid_line("   \n") is None
        assert obslog.valid_line("not json {") is None
        assert obslog.valid_line('["a", "list"]') is None
        assert obslog.valid_line(json.dumps({"level": "info"})) is None
        assert obslog.valid_line(
            json.dumps({"level": "loud", "code": "x"})) is None
        ok = obslog.valid_line(json.dumps(
            {"ts": 1.0, "level": "info", "rank": 0, "run": "r",
             "code": "run-start", "msg": "m"}))
        assert ok is not None and ok["code"] == "run-start"

    def test_tail_survives_corruption(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        good = {"ts": 1.0, "level": "warn", "rank": 0, "run": "r",
                "code": "codec-fallback", "msg": "m"}
        with open(path, "w") as f:
            f.write(json.dumps(dict(good, msg="first")) + "\n")
            f.write("torn-li")  # crash mid-append
            f.write("\n" + json.dumps(dict(good, msg="last")) + "\n")
        recs = obslog.tail(path)
        assert [r["msg"] for r in recs] == ["first", "last"]
        assert obslog.tail(str(tmp_path / "missing.jsonl")) == []

    def test_tail_level_floor_and_bound(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        s = LogStream("r", level="debug", path=path)
        for i in range(10):
            s.emit("debug", "run-start", "d%d" % i)
        s.emit("warn", "codec-fallback", "w")
        assert len(obslog.tail(path, n=5)) == 5
        warns = obslog.tail(path, min_level="warn")
        assert [r["msg"] for r in warns] == ["w"]

    def test_format_tail(self):
        text = obslog.format_tail([
            {"ts": 0, "level": "warn", "rank": 1, "stage": 2,
             "code": "codec-fallback", "msg": "zstd unavailable"}])
        assert "WARN" in text and "r1 s2" in text
        assert "[codec-fallback]" in text
        assert "DAMPR_TPU_TORCH_LOG" in obslog.format_tail([])


class TestDisabledPath:
    def test_off_is_one_none_check(self):
        """The off-path pin: no active stream means the leveled helpers
        return before touching codes, rendering, or any file — an
        unregistered code and crashing %-args must both be inert."""
        assert obslog.active() is None and not obslog.enabled()
        obslog.debug("never-a-registered-code", "%d", "not-an-int")
        obslog.info("never-a-registered-code", "x")

    def test_warn_reaches_stdlib_even_when_off(self, caplog):
        assert obslog.active() is None
        with caplog.at_level(logging.WARNING, "dampr_tpu_torch"):
            obslog.warn("codec-fallback", "codec %s gone", "zstd",
                        logger=logging.getLogger(
                            "dampr_tpu_torch.io.codecs"))
        assert any("codec zstd gone" in r.getMessage()
                   for r in caplog.records)

    def test_start_stop_scoping(self, tmp_path):
        s = LogStream("r", level="debug",
                      path=str(tmp_path / "e.jsonl"))
        obslog.start(s)
        try:
            assert obslog.active() is s
            obslog.info("run-start", "via module api")
            assert s.counts.get("info") == 1
            # stopping a DIFFERENT stream must not clear the active one
            obslog.stop(LogStream("other"))
            assert obslog.active() is s
        finally:
            obslog.stop(s)
        assert obslog.active() is None


class TestRunIntegration:
    def test_events_jsonl_and_stats_section(self, logged):
        em = (Dampr.memory([(i % 7, i) for i in range(4000)])
              .group_by(lambda kv: kv[0])
              .reduce(lambda k, vs: sum(v[1] for v in vs))
              .run("log-smoke"))
        stats = em.stats()
        sec = stats.get("log")
        assert sec and sec["level"] == "debug", sec
        assert sec["records"] >= 2  # at least run-start + run-finish
        recs = obslog.tail("log-smoke")
        codes = [r["code"] for r in recs]
        assert codes[0] == "run-start" and "run-finish" in codes
        for r in recs:
            assert r["code"] in obslog.EVENT_CODES, r
        # the stream is run-scoped: stopped after finalize
        assert obslog.active() is None
        em.delete()

    def test_results_byte_identical_log_on_vs_off(self, tmp_path):
        def build():
            return (Dampr.memory(list(range(3000)))
                    .map(lambda x: (x % 11, x))
                    .fold_by(lambda kv: kv[0], operator.add,
                             lambda kv: kv[1]))

        old = (settings.log_level, settings.scratch_root,
               settings.trace_dir)
        try:
            settings.scratch_root = str(tmp_path / "off")
            settings.trace_dir = str(tmp_path / "off-traces")
            settings.log_level = ""
            off = sorted(build().run("ident").stream())
            settings.scratch_root = str(tmp_path / "on")
            settings.trace_dir = str(tmp_path / "on-traces")
            settings.log_level = "debug"
            on = sorted(build().run("ident").stream())
        finally:
            (settings.log_level, settings.scratch_root,
             settings.trace_dir) = old
        assert off == on

    def test_crashdump_carries_log_tail(self, logged):
        old = (settings.trace, flightrec.RING_EVENTS)
        settings.trace = True
        flightrec.RING_EVENTS = 256

        def boom(x):
            if x == 1234:
                raise RuntimeError("intentional crash")
            return (x, 1)

        try:
            with pytest.raises(Exception):
                Dampr.memory(list(range(4000))).map(boom).run("log-crash")
        finally:
            settings.trace, flightrec.RING_EVENTS = old
        dump = os.path.join(settings.trace_dir, "log-crash", "trace",
                            "crashdump.json")
        assert os.path.isfile(dump), dump
        with open(dump) as f:
            doc = json.load(f)
        tail = doc["otherData"].get("log")
        assert tail, "crashdump carries no log tail"
        assert any(r["code"] == "run-failed" for r in tail), tail
        for rec in tail:  # every entry matches the checked-in schema
            for key in _LOG_ITEM_SCHEMA["required"]:
                assert key in rec, (key, rec)
            assert rec["level"] in ("debug", "info", "warn", "error")
            assert rec["code"] in obslog.EVENT_CODES


class TestCodedSites:
    """The port's warning sites emit the JAX package's coded events."""

    def test_codec_fallback_is_coded(self, tmp_path, monkeypatch):
        from dampr_tpu_torch.io import codecs

        s = LogStream("r", level="info", path=str(tmp_path / "e.jsonl"))
        monkeypatch.setattr(codecs, "available",
                            lambda name: name in ("zlib", "raw", "none"))
        monkeypatch.setattr(codecs, "_logged", set())
        obslog.start(s)
        try:
            got = codecs.resolve("zstd")
        finally:
            obslog.stop(s)
        assert got.name == "zlib"
        recs = obslog.tail(str(tmp_path / "e.jsonl"))
        assert [r["code"] for r in recs] == ["codec-fallback"]
        assert recs[0]["data"] == {"codec": "zstd"}

    def test_stuck_writer_is_coded(self, tmp_path):
        import threading

        from dampr_tpu_torch.io.writer import SpillWriterPool

        s = LogStream("r", level="info", path=str(tmp_path / "e.jsonl"))
        pool = SpillWriterPool(store=None, threads=1, cap_bytes=1,
                               window=1)
        release = threading.Event()
        t = threading.Thread(target=release.wait, args=(30,),
                             name="dampr-spill-writer-stuck", daemon=True)
        t.start()
        pool._threads = [t]
        import dampr_tpu_torch.io.writer as writer_mod

        real_join = threading.Thread.join
        obslog.start(s)
        try:
            t.join = lambda timeout=None: real_join(t, 0.01)
            pool.close()
        finally:
            obslog.stop(s)
            release.set()
            real_join(t, 10)
        assert not t.is_alive()
        recs = obslog.tail(str(tmp_path / "e.jsonl"))
        assert [r["code"] for r in recs] == ["writer-pool-stuck"]
        assert recs[0]["data"]["thread"] == "dampr-spill-writer-stuck"
        assert writer_mod.log.name == "dampr_tpu_torch.io.writer"
