"""The fault layer of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_faults.py`` (less ``TestDoctorFaults``,
``TestWatchdog`` and the two shuffle cases of
``TestExchangeTimeoutPlumbing``: the doctor, the exchange watchdog and the
mesh shuffle are later slices), plus the cases earlier slices left out
(``TestOverlapRetry``, ``test_publish_fault_fails_clean``,
``TestFrameReadTiming``) and the device sink's ``device_dispatch`` sites
with the handoff forced on the CPU.

Both packages get the same seeded numpy inputs, the same fault spec and
seed, the same partition count and one job thread.  Exact: records, sink
bytes, quarantine sink lines, and the ``faults`` counters wherever the
schedule is deterministic (``nth=``, ``match=``); the ``FaultPlan`` firing
sequences over 1,000 probes are equal.  The port's device is the CPU.
"""

import json
import logging
import operator
import os
import signal
import subprocess
import sys
import textwrap
import time
import uuid

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu.ops.text
import dampr_tpu.runner
import dampr_tpu_torch
import dampr_tpu_torch.ops.text
import dampr_tpu_torch.runner
from dampr_tpu import faults as ref_faults
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import faults, settings
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.ops import handoff as port_handoff
from dampr_tpu_torch.ops.text import ParseNumbers
from dampr_tpu_torch.runner import MTRunner
from dampr_tpu_torch.storage import RunStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KNOBS = ("faults", "job_retries", "io_retries", "max_quarantined",
          "retry_backoff_ms", "retry_backoff_max_ms", "run_retries",
          "max_processes", "partitions")
_PORT_ONLY = ("device", "scratch_root")
_REF_ONLY = ("mesh_fold", "mesh_exchange")

PKGS = (("ref", dampr_tpu, ref_faults, ref_settings),
        ("port", dampr_tpu_torch, faults, settings))


@pytest.fixture(autouse=True)
def _clean_faults(tmp_path):
    """Injection off and every fault knob at its default, in both
    packages; one job thread and 8 partitions, so schedules replay."""
    saved = {tag: {n: getattr(s, n) for n in _KNOBS}
             for tag, _p, _f, s in PKGS}
    saved_port = {n: getattr(settings, n) for n in _PORT_ONLY}
    saved_ref = {n: getattr(ref_settings, n) for n in _REF_ONLY}
    for _tag, _p, _f, s in PKGS:
        s.max_processes = 1
        s.partitions = 8
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "port-scratch")
    # the JAX side's single-device branches, as the port has no mesh
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    yield
    for tag, _p, f, s in PKGS:
        for n, v in saved[tag].items():
            setattr(s, n, v)
        f.clear()
    for n, v in saved_port.items():
        setattr(settings, n, v)
    for n, v in saved_ref.items():
        setattr(ref_settings, n, v)


def _both(fn):
    """``{"ref": fn(pkg, faults, settings), "port": ...}``, each package
    under its own fresh run names."""
    out = {}
    for tag, pkg, f, s in PKGS:
        out[tag] = fn(pkg, f, s)
        f.clear()
    return out


def _unique(name):
    return "{}-{}".format(name, uuid.uuid4().hex[:8])


class TestPlanGrammar:
    def test_parse_and_describe(self):
        spec = ("spill_write:p=0.25;udf:match=BAD,kind=deterministic;"
                "exchange_step:nth=3;rank_kill:rank=1,exit=137;seed=42")
        p = faults.FaultPlan(spec)
        assert p.seed == 42
        assert p.rules["spill_write"].p == 0.25
        assert p.rules["udf"].match == "BAD"
        assert p.rules["udf"].kind == "deterministic"
        assert p.rules["exchange_step"].nth == 3
        assert p.rules["exchange_step"].times == 1  # nth defaults once
        assert p.rules["rank_kill"].exit_code == 137
        d = p.describe()
        assert d["seed"] == 42 and len(d["sites"]) == 4
        assert d == ref_faults.FaultPlan(spec).describe()

    def test_sites_equal_reference(self):
        assert faults.SITES == ref_faults.SITES

    def test_seed_position_independent(self):
        a = faults.FaultPlan("seed=9;spill_write:p=0.5")
        b = faults.FaultPlan("spill_write:p=0.5;seed=9")
        seq_a = [a.rules["spill_write"].should_fire() for _ in range(64)]
        seq_b = [b.rules["spill_write"].should_fire() for _ in range(64)]
        assert seq_a == seq_b and any(seq_a) and not all(seq_a)

    def test_p_schedule_reproducible_and_seed_sensitive(self):
        def seq(seed):
            p = faults.FaultPlan("spill_write:p=0.3;seed={}".format(seed))
            return [p.rules["spill_write"].should_fire()
                    for _ in range(128)]

        assert seq(1) == seq(1)
        assert seq(1) != seq(2)

    @pytest.mark.parametrize("spec", [
        "spill_write:p=0.01;seed=7",
        "spill_read:p=0.3,times=20;seed=3",
        "fold:every=7",
        "udf:every=3,times=50;seed=1",
        "device_dispatch:nth=17",
        "checkpoint_persist:nth=5,times=3",
        "spill_write:p=0.5;spill_read:p=0.5;seed=123",
        "stream_publish:p=0.05,kind=deterministic;seed=99",
    ])
    def test_firing_sequence_equals_reference(self, spec):
        """One spec and seed fire on the same invocations in both
        packages: 1,000 probes of every site of the plan."""
        port, ref = faults.FaultPlan(spec), ref_faults.FaultPlan(spec)
        for site in port.rules:
            got = [port.rules[site].should_fire() for _ in range(1000)]
            want = [ref.rules[site].should_fire() for _ in range(1000)]
            assert got == want, site
            assert port.rules[site].injected == ref.rules[site].injected

    @pytest.mark.parametrize("bad", ["spill_write", "udf:p=x", "udf:banana",
                                     "udf:kind=weird"])
    def test_bad_specs_raise(self, bad):
        with pytest.raises(faults.FaultSpecError):
            faults.FaultPlan(bad)
        with pytest.raises(ref_faults.FaultSpecError):
            ref_faults.FaultPlan(bad)

    def test_unknown_site_tolerated(self):
        p = faults.FaultPlan("not_a_site:nth=1")
        assert "not_a_site" in p.rules  # kept, warned, harmless

    def test_match_rule_fires_every_probe(self):
        """Content-keyed rules fire on every re-execution: the bisect
        relies on it."""
        p = faults.FaultPlan("udf:match=POISON,kind=deterministic")
        r = p.rules["udf"]
        for _ in range(5):
            assert r.should_fire(("POISON-x", 1))
        assert not r.should_fire(("clean", 1))

    def test_nth_and_times(self):
        p = faults.FaultPlan("fold:nth=2,times=1")
        r = p.rules["fold"]
        assert [r.should_fire() for _ in range(5)] == [
            False, True, False, False, False]


class TestClassification:
    def test_buckets(self):
        import torch

        cases = [(OSError("disk"), "transient"),
                 (TimeoutError(), "transient"),
                 (ConnectionError(), "transient"),
                 (ValueError("bad record"), "deterministic"),
                 (RuntimeError(), "deterministic"),
                 (MemoryError(), "fatal"),
                 (KeyboardInterrupt(), "fatal"),
                 (SystemExit(1), "fatal")]
        for exc, kind in cases:
            assert faults.classify(exc) == kind, exc
            assert ref_faults.classify(exc) == kind, exc
        assert faults.classify(
            faults.TransientInjectedFault("x")) == "transient"
        assert faults.classify(
            faults.DeterministicInjectedFault("x")) == "deterministic"
        assert faults.classify(
            faults.QuarantineOverflow("full")) == "fatal"
        assert faults.classify(faults.FatalInjectedFault("x")) == "fatal"
        # the card's out-of-memory error is a RuntimeError: deterministic,
        # as an XLA runtime error is in the JAX package
        assert faults.classify(torch.OutOfMemoryError("oom")) == \
            "deterministic"

    def test_transient_fault_is_oserror(self):
        # code catching real IO errors treats injected ones identically
        assert isinstance(faults.TransientInjectedFault("x"), OSError)

    def test_backoff_bounds(self):
        import random

        settings.retry_backoff_ms = ref_settings.retry_backoff_ms = 40
        settings.retry_backoff_max_ms = 300
        ref_settings.retry_backoff_max_ms = 300
        for attempt in range(10):
            for _ in range(20):
                d = faults.backoff(attempt)
                assert 0.0 <= d <= 0.3 + 1e-9
            # the same delays from the same stream
            assert faults.backoff(attempt, random.Random(attempt)) == \
                ref_faults.backoff(attempt, random.Random(attempt))
        # early attempts bounded by base * 2^n
        assert all(faults.backoff(0) <= 0.04 for _ in range(50))


class TestDisabledPath:
    def test_no_plan_no_cost_no_section_noise(self):
        assert faults.active() is None
        faults.check("spill_write")  # inert
        faults.check_records("udf", [1], [2])

        def run(pkg, f, s):
            em = pkg.Dampr.memory(list(range(500))).map(
                lambda x: (x, 1)).run()
            fa = em.stats()["faults"]
            got = em.read()
            em.delete()
            return got, fa

        out = _both(run)
        for _got, fa in out.values():
            assert fa["enabled"] is False
            assert fa["retries"] == 0 and fa["quarantined"] == 0
            assert "plan" not in fa and "injected" not in fa
        assert out["port"] == out["ref"]

    def test_stage_stats_carry_quarantined_field(self):
        em = dampr_tpu_torch.Dampr.memory(list(range(100))).map(
            lambda x: (x, 1)).run()
        assert all(s["quarantined"] == 0 and s["retries"] == 0
                   for s in em.stats)
        em.delete()


class TestClassifiedRetries:
    def test_transient_retry_backs_off(self):
        def run(pkg, f, s):
            s.job_retries = 2
            s.retry_backoff_ms = 20
            f.install(f.FaultPlan("udf:nth=1,kind=transient"))
            em = pkg.Dampr.memory(list(range(2000))).map(
                lambda x: (x, x)).run(name=_unique("retry-transient"))
            fa = em.stats()["faults"]
            got = em.read()
            em.delete()
            return got, fa

        out = _both(run)
        got, fa = out["port"]
        assert fa["job_retries"] >= 1
        assert fa["backoff_seconds"] > 0.0
        assert fa["injected"] == {"udf": 1}
        assert sorted(got)[:3] == [(0, 0), (1, 1), (2, 2)]
        assert got == out["ref"][0]
        assert fa["job_retries"] == out["ref"][1]["job_retries"]
        assert fa["injected"] == out["ref"][1]["injected"]

    def test_deterministic_retry_no_backoff(self):
        """Stateful flaky UDFs (deterministic class) still retry, at
        once."""
        def run(pkg, f, s):
            s.job_retries = 2
            state = {"n": 0}

            def flaky(x):
                state["n"] += 1
                if state["n"] == 1:
                    raise RuntimeError("transient-in-behavior")
                return (x, x)

            em = pkg.Dampr.memory([1, 2, 3], partitions=1).map(flaky).run(
                name=_unique("retry-det"))
            fa = em.stats()["faults"]
            got = em.read()
            em.delete()
            return got, fa["job_retries"], fa["backoff_seconds"]

        out = _both(run)
        assert out["port"] == out["ref"]
        assert out["port"][1] >= 1 and out["port"][2] == 0.0

    def test_fatal_never_retried(self):
        def run(pkg, f, s):
            s.job_retries = 5
            calls = {"n": 0}

            def oom(x):
                calls["n"] += 1
                raise MemoryError("boom")

            with pytest.raises(MemoryError):
                pkg.Dampr.memory([1], partitions=1).map(oom).run(
                    name=_unique("retry-oom"))
            return calls["n"]

        assert _both(run) == {"ref": 1, "port": 1}  # one attempt each


def _quarantine_lines(f, name):
    return [{k: v for k, v in rec.items() if k != "ts"}
            for rec in f.load_quarantine(name)]


class TestQuarantine:
    @staticmethod
    def _pipe(pkg, data):
        return pkg.Dampr.memory(data).map(lambda s: (int(s), s))

    def _run(self, pkg, f, data, name):
        em = self._pipe(pkg, data).run(name=name)
        got = em.read()
        fa = em.stats()["faults"]
        stages = [st["quarantined"] for st in em.stats]
        em.delete()
        return got, fa, stages, _quarantine_lines(f, name)

    def test_poison_record_quarantined_exactly(self):
        """Results under quarantine equal a run whose input lacked the
        poison records."""
        clean = [str(i) for i in range(5000)]
        poisoned = clean[:1234] + ["POISON-A"] + clean[1234:] + ["POISON-B"]

        def run(pkg, f, s):
            s.max_quarantined = 2
            name = _unique("q-exact")
            got = self._run(pkg, f, poisoned, name)
            want = self._pipe(pkg, clean).run(name=_unique("q-clean")).read()
            return got, want

        out = _both(run)
        (got, fa, _st, lines), want = out["port"]
        assert got == want
        assert fa["quarantined"] == 2
        assert [json.loads(json.dumps(x)) for x in lines] == \
            out["ref"][0][3]
        assert got == out["ref"][0][0]

    def test_counts_and_sink_file(self):
        def run(pkg, f, s):
            s.max_quarantined = 1
            return self._run(pkg, f, ["1", "2", "oops", "3"], "q-counts")

        out = _both(run)
        got, fa, stages, lines = out["port"]
        assert fa["quarantined"] == 1
        assert sum(stages) == 1
        assert len(lines) == 1
        assert "oops" in lines[0]["value"]
        assert lines[0]["error"] == "ValueError"
        assert lines == out["ref"][3]
        assert got == out["ref"][0]
        assert stages == out["ref"][2]

    def test_budget_overflow_fails_fast(self):
        def run(pkg, f, s):
            s.max_quarantined = 1
            s.job_retries = 3
            with pytest.raises(Exception) as ei:
                self._pipe(pkg, ["bad1", "bad2", "1"]).run(
                    name=_unique("q-overflow"))
            # overflow is fatal: it surfaces without the retry budget
            assert isinstance(ei.value, (f.QuarantineOverflow, ValueError))
            return type(ei.value).__name__

        out = _both(run)
        assert out["port"] == out["ref"]

    def test_disabled_fails_fast_as_before(self):
        assert settings.max_quarantined == 0
        with pytest.raises(ValueError):
            self._pipe(dampr_tpu_torch, ["1", "nope"]).run(
                name=_unique("q-off"))

    def test_duplicate_poison_records_each_count(self):
        """Duplicates are distinct records: each counts and each gets a
        sink line."""
        def run(pkg, f, s):
            s.max_quarantined = 2
            return self._run(pkg, f, ["1", "dup-bad", "2", "dup-bad", "3"],
                             "q-dup")

        out = _both(run)
        got, fa, _st, lines = out["port"]
        assert fa["quarantined"] == 2
        assert len(lines) == 2
        assert all("dup-bad" in r["value"] for r in lines)
        assert sorted(got) == [(1, "1"), (2, "2"), (3, "3")]
        assert lines == out["ref"][3] and got == out["ref"][0]

    def test_duplicate_poison_overflows_single_budget(self):
        def run(pkg, f, s):
            s.max_quarantined = 1
            with pytest.raises(Exception) as ei:
                self._pipe(pkg, ["bad", "1", "bad"]).run(
                    name=_unique("q-dup-over"))
            assert isinstance(ei.value, (f.QuarantineOverflow, ValueError))
            return type(ei.value).__name__

        out = _both(run)
        assert out["port"] == out["ref"]

    def test_idempotent_across_job_retries(self):
        """A transient fault in the job of a poison record: the retried
        job quarantines the same record without charging it twice."""
        data = [str(i) for i in range(3000)] + ["POISON"]

        def build(pkg, d):
            return (pkg.Dampr.memory(d, partitions=4)
                    .map(lambda s: (int(s) % 7, 1))
                    .fold_by(lambda kv: kv[0], operator.add,
                             lambda kv: kv[1]))

        def run(pkg, f, s):
            s.max_quarantined = 1
            s.job_retries = 3
            f.install(f.FaultPlan("fold:nth=1,kind=transient"))
            em = build(pkg, data).run(name=_unique("q-idem"))
            fa = em.stats()["faults"]
            got = dict(em.read())
            em.delete()
            f.clear()
            want = dict(build(pkg, data[:-1]).run(
                name=_unique("q-idem-clean")).read())
            return got, want, fa["quarantined"], fa["job_retries"]

        out = _both(run)
        got, want, quarantined, retries = out["port"]
        assert quarantined == 1 and retries >= 1
        assert got == want
        assert out["port"] == out["ref"]


def _write_numbers(tmp_path, n, seed=11):
    rng = np.random.RandomState(seed)
    ks = rng.randint(0, 1 << 40, size=n)
    path = str(tmp_path / "nums.txt")
    with open(path, "w") as f:
        f.write("\n".join(str(k) for k in ks) + "\n")
    return path, ks


class TestIoRetries:
    def test_spill_write_transient_absorbed(self, tmp_path):
        path, ks = _write_numbers(tmp_path, 60000)

        def run(pkg, f, s):
            f.install(f.FaultPlan("spill_write:nth=1,kind=transient,"
                                  "times=2"))
            s.retry_backoff_ms = 5
            pipe = (pkg.Dampr.text(path, chunk_size=64 * 1024)
                    .custom_mapper(pkg.ops.text.ParseNumbers())
                    .checkpoint(force=True))
            runner = pkg.runner.MTRunner(_unique("io-retry"),
                                         pipe.pmer.graph,
                                         memory_budget=1 << 18)
            old_dev = s.use_device
            s.use_device = False
            try:
                out = runner.run([pipe.source])
                got = [k for b in out[0].sorted_blocks()
                       for k in b.keys.tolist()]
            finally:
                s.use_device = old_dev
            fa = runner.run_summary["faults"]
            out[0].delete()
            runner.store.cleanup()
            return got, fa["io_retries"], fa["retries"]

        out = _both(run)
        got, io_retries, retries = out["port"]
        assert got == sorted(ks.tolist())
        assert io_retries.get("spill_write", 0) >= 1 and retries >= 1
        assert out["port"] == out["ref"]

    def test_spill_read_transient_absorbed(self, tmp_path):
        from dampr_tpu_torch.io import frames
        from dampr_tpu_torch.io.codecs import resolve

        path = str(tmp_path / "f.blk")
        arr = np.arange(5000, dtype=np.int64)
        with open(path, "wb") as f:
            frames.write_block_frames(Block(arr, arr.copy()), f,
                                      resolve("zlib", 1), 1000)
        faults.install(faults.FaultPlan(
            "spill_read:nth=1,kind=transient,times=2"))
        settings.retry_backoff_ms = 5
        snap = faults.counters_snapshot()
        r = frames.FrameReader(path)
        try:
            payloads = list(r.iter_payloads())
        finally:
            r.close()
        assert len(payloads) == 5
        _inj, io_r, io_backoff = faults.counters_delta(snap)
        assert io_r.get("spill_read", 0) == 1
        assert io_backoff >= 0.0
        # the JAX package reads the port's file, and its reader absorbs
        # the same schedule the same way
        from dampr_tpu.io import frames as ref_frames

        ref_faults.install(ref_faults.FaultPlan(
            "spill_read:nth=1,kind=transient,times=2"))
        ref_settings.retry_backoff_ms = 5
        rsnap = ref_faults.counters_snapshot()
        rr = ref_frames.FrameReader(path)
        try:
            assert [bytes(p) for p in rr.iter_payloads()] == \
                [bytes(p) for p in payloads]
        finally:
            rr.close()
        assert ref_faults.counters_delta(rsnap)[1] == io_r

    def test_io_retry_budget_exhausted_raises(self):
        faults.install(faults.FaultPlan("spill_write:p=1.0"))
        settings.io_retries = 1
        settings.retry_backoff_ms = 1
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            faults.check("spill_write")

        with pytest.raises(faults.TransientInjectedFault):
            faults.retry_io(always, "spill_write")
        assert calls["n"] == 2  # initial + one retry

    def test_deterministic_io_error_not_retried(self):
        calls = {"n": 0}

        def corrupt():
            calls["n"] += 1
            raise ValueError("corrupt frame")

        with pytest.raises(ValueError):
            faults.retry_io(corrupt, "spill_read")
        assert calls["n"] == 1

    def test_sync_spill_retries_in_place(self, tmp_path):
        """With the writer pool off, ``BlockRef.spill`` is the write site
        and retries the same way."""
        old = settings.spill_write_threads
        settings.spill_write_threads = 0
        try:
            faults.install(faults.FaultPlan(
                "spill_write:nth=1,kind=transient"))
            settings.retry_backoff_ms = 1
            snap = faults.counters_snapshot()
            store = RunStore("sync-spill", budget=1)
            arr = np.arange(5000, dtype=np.int64)
            ref = store.register(Block(arr, arr * 2))
            assert not ref.resident and ref.path is not None
            np.testing.assert_array_equal(ref.get().values, arr * 2)
            assert faults.counters_delta(snap)[1] == {"spill_write": 1}
            store.cleanup()
        finally:
            settings.spill_write_threads = old


class TestFrameReadTiming:
    def test_read_seconds_are_attempt_scoped(self, tmp_path, monkeypatch):
        """A transient spill_read retry keeps the failed attempt and its
        backoff sleep out of the frame's read seconds (the spill MB/s)."""
        from dampr_tpu_torch.io import codecs, frames

        p = str(tmp_path / "t.frames")
        with open(p, "wb") as f:
            w = frames.FrameWriter(f, codecs.resolve("zlib"))
            w.add_frame(b"payload-bytes" * 100, records=1)
            w.close()

        monkeypatch.setattr(settings, "io_retries", 2)
        monkeypatch.setattr(faults, "backoff", lambda attempt, rng=None: 0.25)
        faults.install(faults.FaultPlan("spill_read:nth=1,kind=transient"))
        r = frames.FrameReader(p)
        try:
            t0 = time.perf_counter()
            payload, secs = r._read_frame_timed(0)
            wall = time.perf_counter() - t0
        finally:
            r.close()
            faults.clear()
        assert bytes(payload) == b"payload-bytes" * 100
        assert wall >= 0.25  # the retry really slept the backoff
        assert secs < 0.2, (
            "read seconds {:.3f} include the retry backoff".format(secs))


class TestAutoResume:
    @staticmethod
    def _pipe(pkg):
        return (pkg.Dampr.memory(list(range(4000)))
                .map(lambda x: (x % 13, 1))
                .checkpoint(force=True)
                .fold_by(lambda kv: kv[0], operator.add,
                         lambda kv: kv[1]))

    def test_resume_auto_completes_byte_identical(self):
        def run(pkg, f, s):
            f.install(f.FaultPlan("fold:nth=1,kind=deterministic"))
            em = self._pipe(pkg).run(name=_unique("auto-res"),
                                     resume="auto")
            got = sorted(em.read())
            em.delete()
            f.clear()
            cold = sorted(self._pipe(pkg).run(name=_unique("auto-cold"))
                          .read())
            return got, cold

        out = _both(run)
        assert out["port"][0] == out["port"][1]
        assert out["port"] == out["ref"]

    def test_auto_resumed_summary_counts_the_failed_attempt(self):
        """The run that completes says which attempt it was; a run that
        needed no retry carries no such key (the JAX package's section)."""
        faults.install(faults.FaultPlan("fold:nth=1,kind=deterministic"))
        em = self._pipe(dampr_tpu_torch).run(name=_unique("auto-count"),
                                             resume="auto")
        fa = em.stats()["faults"]
        assert fa["run_attempt"] == 2 and fa["failed_attempts"] == 1
        em.delete()
        faults.clear()
        em = self._pipe(dampr_tpu_torch).run(name=_unique("auto-once"),
                                             resume="auto")
        assert "run_attempt" not in em.stats()["faults"]
        em.delete()

    def test_resume_auto_requires_name(self):
        for _tag, pkg, _f, _s in PKGS:
            with pytest.raises(ValueError, match="resume"):
                pkg.Dampr.memory([1]).map(lambda x: (x, x)).run(
                    resume="auto")

    def test_fatal_never_auto_resumes(self):
        def run(pkg, f, s):
            calls = {"n": 0}

            def oom(x):
                calls["n"] += 1
                raise MemoryError("fatal")

            with pytest.raises(MemoryError):
                pkg.Dampr.memory([1], partitions=1).map(oom).run(
                    name=_unique("auto-fatal"), resume="auto")
            return calls["n"]

        assert _both(run) == {"ref": 1, "port": 1}

    def test_quarantine_survives_auto_resume(self):
        """A failed attempt after a checkpointed quarantine: the retry
        restores the stage from its manifest, and the quarantine count and
        sink lines survive the fresh runner."""
        def run(pkg, f, s):
            s.max_quarantined = 1
            state = {"fails": 1}

            def flaky_reduce(k, vs):
                if state["fails"] > 0:
                    state["fails"] -= 1
                    raise RuntimeError("dies once after the checkpoint")
                return sum(v[1] for v in vs)

            name = _unique("auto-quar")
            em = (pkg.Dampr.memory([str(i) for i in range(2000)]
                                   + ["POISONX"])
                  .map(lambda s: (int(s) % 5, 1))
                  .checkpoint(force=True)
                  .group_by(lambda kv: kv[0])
                  .reduce(flaky_reduce)
                  .run(name=name, resume="auto"))
            fa = em.stats()["faults"]
            got = sorted(em.read())
            em.delete()
            return got, fa["quarantined"], _quarantine_lines(f, name)

        out = _both(run)
        got, quarantined, lines = out["port"]
        assert quarantined == 1
        assert len(lines) == 1 and "POISONX" in lines[0]["value"]
        assert sum(v for _k, v in got) == 2000
        assert got == out["ref"][0] and lines == out["ref"][2]

    def test_settings_cleared_plan_cleared(self):
        """``settings.faults = None`` clears a plan the settings installed,
        on the next run."""
        def run(pkg, f, s):
            s.faults = "udf:nth=1,kind=transient"
            s.job_retries = 1
            em = pkg.Dampr.memory([1, 2, 3]).map(lambda x: (x, x)).run(
                name=_unique("plan-on"))
            on = em.stats()["faults"]
            em.delete()
            s.faults = None
            em = pkg.Dampr.memory([1, 2, 3]).map(lambda x: (x, x)).run(
                name=_unique("plan-off"))
            off = em.stats()["faults"]
            em.delete()
            return (on["enabled"], on["injected"], off["enabled"],
                    off["retries"], f.active())

        out = _both(run)
        assert out["port"] == (True, {"udf": 1}, False, 0, None)
        assert out["port"] == out["ref"]

    def test_environment_variable_installs_the_plan(self, tmp_path):
        """``DAMPR_TPU_TORCH_FAULTS`` is the chaos harness's interface."""
        code = textwrap.dedent("""
            from dampr_tpu_torch import Dampr, settings
            settings.device = "cpu"
            settings.scratch_root = {root!r}
            settings.job_retries = 1
            em = Dampr.memory([1, 2, 3]).map(lambda x: (x, x)).run(
                name="env-plan")
            fa = em.stats()["faults"]
            print(fa["plan"], fa["injected"], sorted(em.read()))
        """).format(root=str(tmp_path / "envroot"))
        env = dict(os.environ, PYTHONPATH=ROOT,
                   DAMPR_TPU_TORCH_FAULTS="udf:nth=1,kind=transient")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip().splitlines()[-1] == (
            "udf:nth=1,kind=transient {'udf': 1} [(1, 1), (2, 2), (3, 3)]")

    def test_retry_budget_exhausted_reraises(self):
        def run(pkg, f, s):
            s.run_retries = 1
            calls = {"n": 0}

            def always(x):
                calls["n"] += 1
                raise RuntimeError("persistent")

            with pytest.raises(RuntimeError, match="persistent"):
                pkg.Dampr.memory([1], partitions=1).map(always).run(
                    name=_unique("auto-exhaust"), resume="auto")
            return calls["n"]

        assert _both(run) == {"ref": 2, "port": 2}


class TestEventSidecar:
    def test_event_sidecar_roundtrip(self):
        faults.clear_events("ev-run")
        faults.record_event("ev-run", "exchange_timeout", stage=3,
                            step=1, timeout_ms=500)
        faults.record_event("ev-run", "exchange_timeout", stage=None)
        evs = faults.load_events("ev-run")
        assert len(evs) == 2
        assert faults.stages_with_exchange_timeouts("ev-run") == {3}
        # the JAX package reads the port's sidecar
        old = ref_settings.scratch_root
        ref_settings.scratch_root = settings.scratch_root
        try:
            assert ref_faults.load_events("ev-run") == evs
        finally:
            ref_settings.scratch_root = old
        faults.clear_events("ev-run")
        assert faults.load_events("ev-run") == []

    def test_events_bounded(self):
        faults.clear_events("ev-cap")
        for i in range(faults.EVENTS_CAP + 50):
            faults.record_event("ev-cap", "exchange_timeout", stage=i)
        evs = faults.load_events("ev-cap")
        assert len(evs) == faults.EVENTS_CAP
        assert evs[-1]["stage"] == faults.EVENTS_CAP + 49
        faults.clear_events("ev-cap")


class TestThreadLeakWarnings:
    def test_sampler_slow_stop_warns(self, caplog):
        from dampr_tpu_torch.obs.metrics import Metrics
        from dampr_tpu_torch.obs.sampler import Sampler

        faults.install(faults.FaultPlan(
            "sampler_tick:nth=1,sleep_ms=3500"))
        m = Metrics("slow-stop")
        s = Sampler(m, interval_ms=10)
        with caplog.at_level(logging.WARNING,
                             logger="dampr_tpu_torch.obs.sampler"):
            s.start()
            time.sleep(0.05)  # let the tick enter the injected stall
            s.stop()
        assert any("did not stop" in r.getMessage()
                   and "dampr-tpu-sampler" in r.getMessage()
                   for r in caplog.records), caplog.records

    def test_progress_tick_site_fires(self):
        from dampr_tpu_torch.obs.metrics import Metrics
        from dampr_tpu_torch.obs.progress import ProgressReporter

        faults.install(faults.FaultPlan("progress_tick:nth=1,sleep_ms=1"))
        snap = faults.counters_snapshot()
        sink = open(os.devnull, "w")
        rep = ProgressReporter(Metrics("tick"), lambda: {}, interval_ms=50,
                               stream=sink)
        rep.start()
        deadline = time.time() + 5
        while (not faults.counters_delta(snap)[0]
               and time.time() < deadline):
            time.sleep(0.01)
        rep.stop()
        sink.close()
        assert faults.counters_delta(snap)[0] == {"progress_tick": 1}

    def test_overlap_producer_slow_stop_warns_and_drains(self, caplog,
                                                         monkeypatch):
        """A consumer that dies mid-stream while the producer is wedged
        still drains every budget reservation and names the stuck
        thread."""
        from dampr_tpu_torch import runner as port_runner

        faults.install(faults.FaultPlan(
            "overlap_produce:nth=3,sleep_ms=2500"))
        monkeypatch.setattr(port_runner, "OVERLAP_WINDOWS", 2)
        monkeypatch.setattr(port_runner, "_PRODUCER_JOIN_SECONDS", 0.5)
        store = RunStore("overlap-kill", budget=1 << 22)

        def codec():
            for _i in range(50):
                arr = np.arange(1000, dtype=np.int64)
                yield Block(arr, arr.copy())

        try:
            with caplog.at_level(logging.WARNING,
                                 logger="dampr_tpu_torch.runner"):
                with pytest.raises(RuntimeError):
                    for i, _blk in enumerate(
                            port_runner._overlap_stream(codec(), store)):
                        if i == 1:
                            raise RuntimeError("consumer died")
            assert any("did not stop" in r.getMessage()
                       for r in caplog.records), caplog.records
            # the wedged producer releases its own charge once it sees stop
            deadline = time.time() + 10
            while store.overlap_bytes != 0 and time.time() < deadline:
                time.sleep(0.05)
            assert store.overlap_bytes == 0
        finally:
            store.cleanup()


class _FlakyParse(ParseNumbers):
    """ParseNumbers whose codec dies mid-stream on its first invocation:
    the first window's block comes out, then the scan raises (a killed
    window inside an overlapped job)."""

    attempts = []  # class-level: survives the per-job deepcopy

    def window_sink(self):
        inner = ParseNumbers.window_sink(self)

        class _Sink(object):
            def add(_s, win):
                blocks = inner.add(win)
                if not _FlakyParse.attempts:
                    _FlakyParse.attempts.append(1)
                    raise IOError("synthetic codec failure mid-window")
                return blocks

            def finish(_s):
                return inner.finish()

        return _Sink()


class TestOverlapRetry:
    def test_kill_mid_window_retries_without_leaks(self, tmp_path,
                                                   monkeypatch):
        from dampr_tpu_torch import runner as port_runner

        path, ks = _write_numbers(tmp_path, 60000)
        monkeypatch.setattr(port_runner, "OVERLAP_WINDOWS", 2)
        settings.job_retries = 1
        _FlakyParse.attempts = []
        pipe = (dampr_tpu_torch.Dampr.text(path, chunk_size=1 << 18)
                .custom_mapper(_FlakyParse())
                .checkpoint(force=True))
        runner = MTRunner("overlap-retry", pipe.pmer.graph)
        out = runner.run([pipe.source])
        assert _FlakyParse.attempts, "failure never injected"
        got = [k for k, _v in out[0].read()]
        assert got == sorted(ks.tolist())
        # the killed window's reservations and refs were rolled back
        assert runner.store.overlap_bytes == 0
        assert runner.run_summary["faults"]["job_retries"] == 1
        out[0].delete()
        runner.store.cleanup()


class TestPublishFault:
    def test_publish_fault_fails_clean(self):
        def build(pkg):
            return (pkg.Dampr.memory(list(range(8000)), partitions=8)
                    .map(lambda x: x + 1)
                    .fold_by(lambda x: x % 7, operator.add))

        faults.install(faults.FaultPlan(
            "stream_publish:nth=1,kind=deterministic"))
        try:
            with pytest.raises(Exception):
                build(dampr_tpu_torch).run(name=_unique("pipe-kill"))
            assert faults.injected_counts.get("stream_publish")
        finally:
            faults.clear()
        # the failed streamed run leaves nothing that changes a rerun:
        # pipelined and staged reads agree, and with the JAX package's
        old = settings.pipeline
        try:
            on = build(dampr_tpu_torch).run(name=_unique("pipe-on")).read()
            settings.pipeline = "off"
            off = build(dampr_tpu_torch).run(name=_unique("pipe-off")).read()
        finally:
            settings.pipeline = old
        assert on == off == build(dampr_tpu).run().read()


# -- the device sink's fault sites (the handoff forced on the CPU) ----------

def _corpus(tmp_path, seed=3, n_lines=3000, vocab=140):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(vocab)] + ["Tok_1", "UPPER", "a"]
    lines = [" ".join(rng.choice(words, size=rng.randint(1, 10)))
             for _ in range(n_lines)]
    path = str(tmp_path / "corpus.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture
def lowered(monkeypatch):
    """Lowering and the handoff forced on the port's CPU device, small
    scan windows and batches, so a job takes several table batches."""
    monkeypatch.setattr(settings, "lower", "on")
    monkeypatch.setattr(settings, "handoff", "on")
    monkeypatch.setattr(settings, "scan_window_bytes", 8192)
    monkeypatch.setattr(settings, "lower_batch", 1024)
    monkeypatch.setattr(settings, "pipeline", "off")


def _docfreq(pkg, text, path, chunks=3):
    docs = pkg.Dampr.text(path, os.path.getsize(path) // chunks + 1)
    return docs.custom_mapper(text.DocFreq(
        mode="word", lower=True, pair_values=False)).fold_values(
            operator.add)


def _port_docfreq(path, name, **kw):
    pipe = _docfreq(dampr_tpu_torch, dampr_tpu_torch.ops.text, path)
    runner = MTRunner(name, pipe.pmer.graph, **kw)
    out = runner.run([pipe.source])
    got = sorted(v for _k, v in out[0].read())
    out[0].delete()
    return got, runner


@pytest.fixture(params=["host", "classic"])
def bootstrap(request, monkeypatch):
    """The CPU's host bootstrap, or the card's classic one."""
    if request.param == "classic":
        monkeypatch.setattr(port_handoff, "_host_bootstrap", lambda: False)
    return request.param


class TestDeviceDispatch:
    def _reference(self, path):
        old = ref_settings.lower
        ref_settings.lower = "1"
        try:
            return sorted(_docfreq(dampr_tpu, dampr_tpu.ops.text, path)
                          .run().read())
        finally:
            ref_settings.lower = old

    def test_retried_job_equals_clean_run(self, tmp_path, lowered,
                                          bootstrap):
        """A transient fault at a dispatch after the vocabulary reached
        table mode: the job retries from a fresh vocabulary, the counts
        equal a clean run's (and the JAX package's), and nothing of the
        failed attempt stays registered."""
        path = _corpus(tmp_path)
        clean, crunner = _port_docfreq(path, _unique("dd-clean"))
        dev = crunner.run_summary["device"]["handoff"]
        assert dev["table_batches"] > 0, dev
        assert clean == self._reference(path)
        settings.job_retries = 2
        settings.retry_backoff_ms = 1
        # the first job's dispatches: a bootstrap (or classic seed), then
        # table batches; the 4th is a table dispatch either way
        faults.install(faults.FaultPlan("device_dispatch:nth=4"))
        got, runner = _port_docfreq(path, _unique("dd-retry"))
        fa = runner.run_summary["faults"]
        assert fa["injected"] == {"device_dispatch": 1}
        assert fa["job_retries"] == 1
        assert got == clean
        assert runner.run_summary["device"]["handoff"]["table_batches"] > \
            dev["table_batches"]
        # the run ended with no device bytes held: the failed attempt's
        # lanes never registered, the finished ones were folded and freed
        assert runner.store._dev_bytes == 0
        assert runner.store.handoff_degrades == 0

    @pytest.mark.parametrize("nth", [1, 2, 5])
    def test_every_dispatch_site_fails_the_job(self, tmp_path, lowered,
                                               bootstrap, nth):
        """Without retries a dispatch fault fails the run (it never
        degrades the job to the host codec or the classic program), and
        the failed run leaves no device ref."""
        path = _corpus(tmp_path)
        faults.install(faults.FaultPlan(
            "device_dispatch:nth={},kind=deterministic".format(nth)))
        pipe = _docfreq(dampr_tpu_torch, dampr_tpu_torch.ops.text, path)
        runner = MTRunner(_unique("dd-fail"), pipe.pmer.graph)
        with pytest.raises(faults.DeterministicInjectedFault):
            runner.run([pipe.source])
        assert runner.store._dev_bytes == 0
        assert runner.store._dev_resident == []
        assert runner.store.handoff_degrades == 0


class TestAttemptRollback:
    def test_failed_attempt_drops_its_device_refs(self, monkeypatch):
        """``store.attempt()`` drops what a failed attempt registered,
        device refs included, and gives back their HBM charge; a
        committed inner attempt's refs roll back with the outer one."""
        from dampr_tpu_torch import storage

        monkeypatch.setattr(settings, "hbm_budget", 1 << 26)
        monkeypatch.setattr(storage, "HBM_MIN_RECORDS", 1)
        store = RunStore("attempt-rollback")
        arr = np.arange(8192, dtype=np.int64)
        kept = store.register(Block(arr, arr % 7), device=True)
        assert kept.is_device
        held = store._dev_bytes
        with pytest.raises(RuntimeError):
            with store.attempt():
                with store.attempt():
                    inner = store.register(Block(arr + 1, arr % 5),
                                           device=True)
                outer = store.register(Block(arr + 2, arr % 3),
                                       device=True)
                assert store._dev_bytes == held + inner.dev_bytes + \
                    outer.dev_bytes
                raise RuntimeError("attempt dies")
        assert store._dev_bytes == held
        assert store._dev_resident == [kept]
        assert inner._dev is None and outer._dev is None
        assert inner._dead and outer._dead
        np.testing.assert_array_equal(kept.get().values, arr % 7)
        store.cleanup()


class TestSigterm:
    def test_sigterm_leaves_schema_valid_crashdump(self, tmp_path):
        """A SIGTERM'd run exits non-zero and leaves a schema-valid
        crashdump."""
        script = tmp_path / "victim.py"
        ready = tmp_path / "ready"
        script.write_text(textwrap.dedent("""
            import sys, time
            sys.path.insert(0, {root!r})
            from dampr_tpu_torch import Dampr, settings
            settings.device = "cpu"
            settings.scratch_root = {scratch!r}
            settings.trace = True
            settings.trace_dir = {tdir!r}
            settings.max_processes = 1  # serial jobs: the signal lands
            #                             in the main thread's UDF loop

            def slow(x):
                if x == 0:
                    open({ready!r}, "w").write("up")
                time.sleep(0.15)
                return (x, x)

            Dampr.memory(list(range(600)), partitions=2).map(
                slow).run(name="sigterm-victim")
            print("COMPLETED-UNEXPECTEDLY")
        """).format(root=ROOT, tdir=str(tmp_path),
                    scratch=str(tmp_path / "scratch"), ready=str(ready)))
        proc = subprocess.Popen([sys.executable, str(script)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        deadline = time.time() + 60
        while not ready.exists() and time.time() < deadline:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        assert ready.exists(), proc.communicate()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0, (proc.returncode, out, err)
        assert "COMPLETED-UNEXPECTEDLY" not in out
        dump = os.path.join(str(tmp_path), "sigterm-victim", "trace",
                            "crashdump.json")
        assert os.path.isfile(dump), (out, err[-2000:])
        with open(dump) as f:
            doc = json.load(f)
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "validate_trace",
            os.path.join(ROOT, "tools", "validate_trace.py"))
        vt = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(vt)
        with open(os.path.join(ROOT, "docs", "trace_schema.json")) as f:
            schema = json.load(f)
        assert not vt.validate(doc, schema)
        assert doc["otherData"]["crash"]["exception"] == "SystemExit"


class TestSiteCatalogDocs:
    def test_documented_sites_match_module(self):
        """docs/robustness.md's site table and the port's SITES agree."""
        with open(os.path.join(ROOT, "docs", "robustness.md")) as f:
            doc = f.read()
        for site in faults.SITES:
            assert "`{}`".format(site) in doc, site
