"""The port's per-operator profiler (``dampr_tpu_torch.obs.profile``):
the port version of ``tests/test_profile.py`` (the disabled-path pin,
per-op attribution on batched chains and scanner stages, fusion
provenance, the lowered stage's device sub-phases, coverage), and the
``settings.profile_dir`` hatch (``torch.profiler``) on the CPU.

``test_scanner_stage_covers_job_time`` gives each job about 12 MB of
its corpus, so per-job fixed costs and scheduling jitter under ``-n 6``
cannot pull the coverage under the JAX package's acceptance bar of 0.9;
it runs once.
"""

import operator
import os
import threading

import pytest

from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import profile


@pytest.fixture(autouse=True)
def cpu():
    old = settings.device
    settings.device = "cpu"
    yield
    settings.device = old


@pytest.fixture
def profiled(tmp_path):
    """Profiler + tracing on for one test, artifacts and scratch under
    tmp_path (scratch isolation keeps the history corpus per-test)."""
    old = (settings.trace, settings.trace_dir, settings.profile,
           settings.scratch_root)
    settings.trace = True
    settings.trace_dir = str(tmp_path / "traces")
    settings.profile = True
    settings.scratch_root = str(tmp_path / "scratch")
    yield tmp_path
    (settings.trace, settings.trace_dir, settings.profile,
     settings.scratch_root) = old


def _corpus(tmp_path, lines=6000):
    path = tmp_path / "corpus.txt"
    words = ["alpha", "beta", "gamma", "delta", "tok7", "zz", "mu", "xi"]
    with open(path, "w") as f:
        for i in range(lines):
            f.write(" ".join(words[(i + j) % len(words)]
                             for j in range(9)) + "\n")
    return str(path)


class TestDisabledPath:
    def test_off_by_default_no_thread_no_section(self):
        """The default-off pin (same discipline as test_metrics): module
        surface is inert, no profiler instance, no new threads, and the
        run summary carries no profile section."""
        assert settings.profile is False
        assert profile.active() is None
        assert not profile.enabled()
        # inert module-level calls (would raise if they touched state)
        profile.device_add("build", 0.1, 123)
        before = {t.name for t in threading.enumerate()}
        em = Dampr.memory(list(range(3000))).map(lambda x: (x, 1)).run()
        assert "profile" not in em.stats()
        assert {t.name for t in threading.enumerate()} <= before
        em.delete()

    def test_off_path_no_alloc_in_hot_sites(self):
        """The hot-site contract: with no active profiler the module
        global is None and the (hoisted) site check is one load — pinned
        by asserting active() returns the same object (None) with no
        per-call allocation of noop wrappers (unlike span(), there is no
        wrapper object at all)."""
        assert profile.active() is None
        assert profile.active() is None  # stable, allocation-free


class TestAttribution:
    def test_batch_chain_per_op_and_provenance(self, profiled, tmp_path):
        """A fused map chain attributes per-op seconds/records under
        index-prefixed labels, carries fusion provenance, and covers the
        bulk of the stage's job time."""
        em = (Dampr.memory(list(range(20000)))
              .map(lambda x: (x % 64, x))
              .filter(lambda kv: kv[1] % 2 == 0)
              .fold_by(lambda kv: kv[0], binop=operator.add,
                       value=lambda kv: kv[1])
              .run("prof-chain"))
        prof = em.stats()["profile"]
        assert prof["enabled"] is True
        fused = [s for s in prof["stages"]
                 if any(o["op"].startswith("0:") for o in s["ops"])]
        assert fused, prof["stages"]
        st = fused[0]
        labels = [o["op"] for o in st["ops"]]
        # the chain's ops appear individually, plus the hoisted combiner
        assert any("Filter" in l for l in labels), labels
        assert "combine" in labels, labels
        # records flow through the ops (filter halves them)
        by = {o["op"]: o for o in st["ops"]}
        filt = next(v for k, v in by.items() if "Filter" in k)
        assert filt["records"] > 0
        assert st["provenance"], st
        assert any("Filter" in p for p in st["provenance"])
        assert st["jobs"] >= 1 and st["job_seconds"] > 0
        em.delete()

    def test_scanner_stage_covers_job_time(self, profiled, tmp_path):
        """The scanner (``map_blocks``) stage with its map-side fold, the
        TF-IDF shape, attributes its codec windows to the scanner op and
        its folds to ``combine``.  Each of its two jobs scans about 12 MB,
        so the codec dominates the job's fixed costs and the attributed
        share clears 0.9 of the job thread-seconds however the scheduler
        interleaves the jobs (0.93-0.99 measured with six such runs
        side by side on a CPU box)."""
        from dampr_tpu_torch.ops.text import DocFreq

        words = ["alpha", "beta", "gamma", "delta", "tok7", "zz", "mu",
                 "xi"]
        period = "".join(" ".join(words[(i + j) % len(words)]
                                  for j in range(9)) + "\n"
                         for i in range(len(words)))
        corpus = str(tmp_path / "big.txt")
        with open(corpus, "w") as f:
            f.write(period * 80000)  # 640,000 lines, as _corpus writes
        em = (Dampr.text(corpus, 16 << 20)
              .custom_mapper(DocFreq(mode="word", lower=True,
                                     pair_values=False))
              .fold_values(operator.add)
              .run("prof-scan"))
        prof = em.stats()["profile"]
        scan = [s for s in prof["stages"]
                if any("DocFreq" in o["op"] or o["op"].startswith("scan:")
                       for o in s["ops"])]
        assert scan, prof["stages"]
        st = max(scan, key=lambda s: s["job_seconds"])
        assert dict(em.read())["alpha"] == 640000
        em.delete()
        assert st["jobs"] == 2, st
        assert {o["op"] for o in st["ops"]} == {"0:DocFreq", "combine"}
        assert st["coverage"] is not None, st
        assert st["coverage"] >= 0.9, st

    def test_stats_profile_reaches_persisted_summary(self, profiled,
                                                     tmp_path):
        """The profile section lands in the persisted stats.json too."""
        import json

        em = (Dampr.memory(list(range(4096)))
              .map(lambda x: (x % 7, 1))
              .fold_by(lambda kv: kv[0], binop=operator.add,
                       value=lambda kv: kv[1])
              .run("prof-persist"))
        path = em.stats()["stats_file"]
        assert path and os.path.isfile(path)
        with open(path) as f:
            on_disk = json.load(f)
        assert on_disk.get("profile", {}).get("enabled") is True
        em.delete()


class TestDeviceSubPhases:
    def test_lowered_stage_decomposes(self, profiled, tmp_path):
        """A device-lowered scanner stage records build/h2d/compute/d2h
        sub-phases with byte counts (the double-buffered dispatch loop's
        brackets)."""
        from dampr_tpu_torch.ops.text import TokenCounts

        old = settings.lower
        old_handoff = settings.handoff
        settings.lower = "on"
        # The classic dispatch loop is what decomposes into these four
        # brackets; the handoff tier's bootstrap/probe path replaces it
        # on this edge and has its own observability pins
        # (test_handoff).
        settings.handoff = "off"
        try:
            # pair_values=False + fold_values is the device-eligible
            # map->fold shape (the bench's): no Rekey between scanner
            # and fold, so the lowering pass claims the map stage.
            em = (Dampr.text(_corpus(tmp_path), 1 << 17)
                  .custom_mapper(TokenCounts(mode="word", lower=True,
                                             pair_values=False))
                  .fold_values(operator.add)
                  .run("prof-device"))
            prof = em.stats()["profile"]
            dev = [s for s in prof["stages"] if s["device"]]
            assert dev, prof["stages"]
            phases = dev[0]["device"]
            for phase in ("build", "h2d", "compute", "d2h"):
                assert phase in phases, phases
                assert phases[phase]["seconds"] >= 0
                assert phases[phase]["calls"] >= 1
            assert phases["h2d"]["bytes"] > 0
            assert phases["d2h"]["bytes"] > 0
            # results are unperturbed by profiling (byte-identity is the
            # lowering contract)
            counts = dict(em.read())
            assert counts and all(v > 0 for v in counts.values())
            assert counts["alpha"] > 1000
            em.delete()
        finally:
            settings.lower = old
            settings.handoff = old_handoff


class TestProfilerUnit:
    def test_op_labels_and_accumulate(self):
        p = profile.Profiler("t")
        p.begin_stage(3, "map", provenance=["map[A]", "map[B]"])
        p.op_add("0:A", 0.5, records=10)
        p.op_add("0:A", 0.25, records=5)
        p.op_add("1:B", 0.1, records=15)
        p.device_add("h2d", 0.05, 1024, sid=3)
        p.job_add(1.0)
        s = p.summary({3: 2.0})
        st = s["stages"][0]
        assert st["stage"] == 3
        assert st["ops"][0] == {"op": "0:A", "seconds": 0.75,
                                "records": 15, "calls": 2}
        assert st["device"]["h2d"]["bytes"] == 1024
        assert st["jobs"] == 1
        assert abs(st["attributed_seconds"] - 0.9) < 1e-9
        assert st["coverage"] == round(min(1.0, 0.9 / 1.0), 4)
        assert st["seconds"] == 2.0
        assert st["provenance"] == ["map[A]", "map[B]"]

    def test_coverage_caps_at_one(self):
        p = profile.Profiler("t")
        p.begin_stage(0, "map")
        p.op_add("x", 5.0)
        p.job_add(1.0)
        assert p.summary()["stages"][0]["coverage"] == 1.0

    def test_timed_iter_attributes_each_next(self):
        p = profile.Profiler("t")
        p.begin_stage(1, "map")
        out = list(p.timed_iter(iter([[1, 2], [3]]), "scan"))
        assert out == [[1, 2], [3]]
        ops = p.summary()["stages"][0]["ops"]
        assert ops[0]["op"] == "scan"
        assert ops[0]["calls"] == 2
        assert ops[0]["records"] == 3

    def test_start_stop_nesting(self):
        a, b = profile.Profiler("a"), profile.Profiler("b")
        profile.start(a)
        profile.start(b)
        assert profile.active() is b
        profile.stop(b)
        assert profile.active() is a
        profile.stop(a)
        assert profile.active() is None


class TestProfileDirHatch:
    def test_cpu_run_exports_a_chrome_trace(self, tmp_path):
        """``settings.profile_dir`` wraps the run in ``torch.profiler``
        and exports its Chrome trace there; results are unchanged."""
        import json

        from dampr_tpu_torch.ops.text import TokenCounts

        def run(profile_dir):
            old = (settings.profile_dir, settings.lower)
            settings.profile_dir = profile_dir
            settings.lower = "on"
            try:
                em = (Dampr.text(_corpus(tmp_path, 2000), 1 << 16)
                      .custom_mapper(TokenCounts(mode="word", lower=True,
                                                 pair_values=False))
                      .fold_values(operator.add)
                      .run("prof-hatch"))
            finally:
                settings.profile_dir, settings.lower = old
            out, s = em.read(), em.stats()
            em.delete()
            return out, s

        plain, s0 = run(None)
        got, s1 = run(str(tmp_path / "pt"))
        assert got == plain
        assert "profile_trace_file" not in s0
        path = s1["profile_trace_file"]
        assert path == os.path.join(str(tmp_path / "pt"),
                                    "prof-hatch.pt.trace.json")
        with open(path) as f:
            doc = json.load(f)
        names = {ev.get("name") for ev in doc["traceEvents"]}
        assert any(n and "aten::" in n for n in names), sorted(names)[:20]

    def test_failed_run_still_writes_its_trace(self, tmp_path,
                                               monkeypatch):
        import json

        monkeypatch.setattr(settings, "profile_dir", str(tmp_path / "pt"))

        def boom(x):
            if x == 50:
                raise RuntimeError("dies under the profiler")
            return (x, x)

        with pytest.raises(RuntimeError, match="under the profiler"):
            Dampr.memory(list(range(100))).map(boom).run("prof-dies")
        path = os.path.join(str(tmp_path / "pt"), "prof-dies.pt.trace.json")
        with open(path) as f:
            assert json.load(f)["traceEvents"]

    def test_cuda_run_without_cuda_activity_raises(self, tmp_path,
                                                   monkeypatch):
        """No quiet CPU-only trace of a CUDA run: when torch cannot
        profile CUDA activity, the hatch refuses before the run."""
        import torch

        from dampr_tpu_torch import runner as port_runner

        monkeypatch.setattr(settings, "profile_dir", str(tmp_path / "pt"))
        monkeypatch.setattr(torch.profiler, "supported_activities",
                            lambda: {torch.profiler.ProfilerActivity.CPU})
        r = port_runner.MTRunner("hatch", Dampr.memory([1]).pmer.graph)
        r.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="cannot profile CUDA"):
            r._torch_profile()
