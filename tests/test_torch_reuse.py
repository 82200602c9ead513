"""The cross-run cache of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_reuse.py``: shared-prefix reuse across
runs and incremental recompute over appended corpora.  Each scenario
runs through both packages with the cache on (each under its own scratch
root and cache directory, the same run names, 8 partitions, adaptive
sizing off so a rerun keys as the first run did): the records are equal,
and so are the hit, miss, skip, incremental and fallback counts and the
per-stage decisions.  A cold run with the cache off is the oracle.

Beside them, the card's hazards on the CPU device with lowering forced
on: a device-resident output (the handoff's counts) publishes through
``resume._ensure_on_disk`` and the entry outlives the run's store; a
mounted producer in front of a fold whose edge was planned ``handoff``
takes the fold's host path (edge kind ``mounted``, no degrade); and an
incremental run unions cached host frames with the new file's device
refs into the device fold with the HBM charge back to 0 at the end.
Every comparison is exact.
"""

import json
import operator
import os
import shutil
import threading

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import faults as ref_faults
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import faults, settings
from dampr_tpu_torch.plan import reuse

PKGS = (("ref", dampr_tpu, ref_settings),
        ("port", dampr_tpu_torch, settings))

#: The stats()["reuse"] counters both packages must agree on (bytes
#: differ: each package writes its own frames).
COUNTS = ("hits", "misses", "stages_skipped", "incremental_merges",
          "recompute_fallbacks")


@pytest.fixture(autouse=True)
def reuse_on(tmp_path):
    """The cache on in both packages, each over its own cache directory
    and scratch root; adaptive sizing off; the JAX package on its
    single-device branches; the port on the CPU."""
    names = ("reuse", "reuse_dir", "reuse_budget_bytes", "scratch_root",
             "plan_adapt", "partitions")
    old = {tag: {n: getattr(s, n) for n in names} for tag, _p, s in PKGS}
    old_dev = settings.device
    old_mesh = (ref_settings.mesh_fold, ref_settings.mesh_exchange)
    for tag, _p, s in PKGS:
        s.reuse = "on"
        s.reuse_dir = str(tmp_path / (tag + "-cache"))
        s.scratch_root = str(tmp_path / (tag + "-scratch"))
        s.plan_adapt = False
        s.partitions = 8
    settings.device = "cpu"
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    yield {tag: s.reuse_dir for tag, _p, s in PKGS}
    for tag, _p, s in PKGS:
        for n, v in old[tag].items():
            setattr(s, n, v)
    settings.device = old_dev
    ref_settings.mesh_fold, ref_settings.mesh_exchange = old_mesh


def _corpus(d, nfiles=3, lines=300, stamp="w"):
    os.makedirs(d, exist_ok=True)
    for i in range(nfiles):
        with open(os.path.join(d, "f{}.txt".format(i)), "w") as f:
            for j in range(lines):
                f.write("{}{} alpha beta gamma\n".format(stamp, j % 11))


def _wordcount(pkg, d, binop=operator.add):
    return (pkg.Dampr.text(d)
            .flat_map(lambda line: line.split())
            .map(lambda w: (w, 1))
            .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                     binop=binop))


def _cold(pkg, s, build):
    """Oracle: the same pipeline with the cache off entirely."""
    old = s.reuse
    s.reuse = "off"
    try:
        return sorted(build().run(name="reuse-cold-oracle").stream())
    finally:
        s.reuse = old


def _counts(em):
    ru = em.stats()["reuse"]
    return {k: ru[k] for k in COUNTS}, ru["decisions"]


def _both(scenario):
    """``scenario(pkg, settings, tag)`` through both packages; asserts
    their returns equal and returns the port's."""
    out = {tag: scenario(pkg, s, tag) for tag, pkg, s in PKGS}
    assert out["port"] == out["ref"], (out["port"], out["ref"])
    return out["port"]


def _entry_dirs(cache_root):
    ed = os.path.join(cache_root, "entries")
    return [os.path.join(ed, n) for n in sorted(os.listdir(ed))
            if not n.startswith(".tmp-")]


class TestIdenticalRerun:
    def test_second_run_mounts_and_is_identical(self, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            first = _wordcount(pkg, d).run(name="reuse-id")
            r1 = sorted(first.stream())
            assert first.stats()["reuse"]["bytes_published"] > 0
            second = _wordcount(pkg, d).run(name="reuse-id")
            r2 = sorted(second.stream())
            assert r1 == r2 == _cold(pkg, s, lambda: _wordcount(pkg, d))
            assert second.stats()["reuse"]["bytes_mounted"] > 0
            kinds = [st["kind"] for st in second.stats]
            return r2, _counts(first), _counts(second), kinds

        r2, _c1, c2, kinds = _both(scenario)
        assert c2[0]["hits"] >= 1 and c2[0]["stages_skipped"] >= 1
        assert any(k.startswith("reused-") for k in kinds)

    def test_reuse_off_env_produces_identical_bytes(self, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            r_on = sorted(_wordcount(pkg, d).run(name="reuse-on").stream())
            s.reuse = "off"
            off = _wordcount(pkg, d).run(name="reuse-off-leg")
            assert "reuse" not in off.stats()
            return r_on, sorted(off.stream())

        r_on, r_off = _both(scenario)
        assert r_on == r_off

    def test_volatile_stage_never_cached(self, reuse_on):
        class Opaque:
            __slots__ = ()

            def __reduce__(self):
                raise TypeError("nope")

            def __call__(self, x):
                return (x % 3, 1)

        def scenario(pkg, s, tag):
            def build():
                return (pkg.Dampr.memory(list(range(30)), partitions=4)
                        .map(Opaque())
                        .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                 binop=operator.add))

            got1 = dict(build().run(name="reuse-volatile").stream())
            second = build().run(name="reuse-volatile")
            entries = os.path.join(reuse_on[tag], "entries")
            # nothing of the volatile chain landed on disk
            assert not os.path.isdir(entries) or not os.listdir(entries)
            return got1, dict(second.stream()), _counts(second)

        got1, got2, (counts, decisions) = _both(scenario)
        assert got1 == got2 == {0: 10, 1: 10, 2: 10}
        assert counts["hits"] == 0
        assert any(x["decision"] == "volatile" for x in decisions)


class TestDegrade:
    def _seed(self, pkg, d):
        out = _wordcount(pkg, d).run(name="reuse-degrade")
        return sorted(out.stream())

    def test_corrupt_manifest_recomputes(self, reuse_on, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            r1 = self._seed(pkg, d)
            for e in _entry_dirs(reuse_on[tag]):
                with open(os.path.join(e, "manifest.json"), "w") as f:
                    f.write("{ not json !!")
            out = _wordcount(pkg, d).run(name="reuse-degrade")
            assert sorted(out.stream()) == r1
            return r1, _counts(out)

        _r, (counts, _d) = _both(scenario)
        assert counts["recompute_fallbacks"] >= 1
        assert counts["stages_skipped"] == 0

    def test_truncated_block_recomputes(self, reuse_on, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            r1 = self._seed(pkg, d)
            truncated = 0
            for e in _entry_dirs(reuse_on[tag]):
                for fn in os.listdir(e):
                    if fn.endswith(".frames"):
                        p = os.path.join(e, fn)
                        with open(p, "r+b") as f:
                            f.truncate(max(0, os.path.getsize(p) // 2))
                        truncated += 1
            assert truncated
            out = _wordcount(pkg, d).run(name="reuse-degrade")
            assert sorted(out.stream()) == r1
            return r1, _counts(out)

        _r, (counts, _d) = _both(scenario)
        assert counts["recompute_fallbacks"] >= 1

    def test_cache_read_fault_site_degrades(self, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)
        mods = {"ref": ref_faults, "port": faults}

        def scenario(pkg, s, tag):
            fm = mods[tag]
            r1 = self._seed(pkg, d)
            fm.install(fm.FaultPlan("cache_read:p=1.0"))
            try:
                out = _wordcount(pkg, d).run(name="reuse-degrade")
                ru = out.stats()["reuse"]
                assert sorted(out.stream()) == r1
                # chaos runs consume but never seed the shared cache
                assert ru["bytes_published"] == 0
                injected = out.stats()["faults"]["injected"]
            finally:
                fm.clear()
            return r1, _counts(out), injected

        _r, (counts, _d), injected = _both(scenario)
        assert counts["recompute_fallbacks"] >= 1
        assert injected.get("cache_read", 0) >= 1


class TestEviction:
    def test_tight_budget_evicts_lru_whole_entries(self, tmp_path):
        d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
        _corpus(d1, stamp="aa")
        _corpus(d2, stamp="bb")

        def scenario(pkg, s, tag):
            first = _wordcount(pkg, d1).run(name="reuse-evict")
            published = first.stats()["reuse"]["bytes_published"]
            assert published > 0
            # room for about one run's entries, not two
            s.reuse_budget_bytes = int(published * 1.25)
            second = _wordcount(pkg, d2).run(name="reuse-evict")
            assert second.stats()["reuse"]["evictions"] >= 1
            mod = (reuse if tag == "port"
                   else __import__("dampr_tpu.plan.reuse",
                                   fromlist=["CacheStore"]))
            assert mod.CacheStore().total_bytes() <= s.reuse_budget_bytes
            # d1's evicted prefix recomputes, exactly
            third = _wordcount(pkg, d1).run(name="reuse-evict")
            r1 = sorted(third.stream())
            assert r1 == sorted(first.stream())
            return r1, _counts(second), _counts(third)

        _both(scenario)

    def test_single_entry_over_budget_is_declined(self, reuse_on,
                                                  tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            s.reuse_budget_bytes = 64  # smaller than any real entry
            out = _wordcount(pkg, d).run(name="reuse-declined")
            assert out.stats()["reuse"]["bytes_published"] == 0
            entries = os.path.join(reuse_on[tag], "entries")
            names = os.listdir(entries) if os.path.isdir(entries) else []
            assert not [n for n in names if not n.startswith(".tmp-")]
            return sorted(out.stream()), _counts(out)

        _both(scenario)


class TestIncremental:
    def test_append_only_growth_merges_partials(self, tmp_path):
        def scenario(pkg, s, tag):
            d = str(tmp_path / (tag + "-data"))
            _corpus(d, nfiles=3)
            _wordcount(pkg, d).run(name="reuse-incr")
            with open(os.path.join(d, "f3.txt"), "w") as f:
                for j in range(80):
                    f.write("new{} appended tokens\n".format(j % 5))
            out = _wordcount(pkg, d).run(name="reuse-incr")
            got = sorted(out.stream())
            assert got == _cold(pkg, s, lambda: _wordcount(pkg, d))
            return got, _counts(out)

        _got, (counts, decisions) = _both(scenario)
        assert counts["incremental_merges"] >= 1
        assert any(x["decision"].startswith("incremental:")
                   for x in decisions)

    def test_grown_file_forces_full_recompute(self, tmp_path):
        def scenario(pkg, s, tag):
            d = str(tmp_path / (tag + "-data"))
            _corpus(d)
            _wordcount(pkg, d).run(name="reuse-grown")
            with open(os.path.join(d, "f0.txt"), "a") as f:
                f.write("tail grew beyond the signed chunks\n")
            out = _wordcount(pkg, d).run(name="reuse-grown")
            got = sorted(out.stream())
            assert got == _cold(pkg, s, lambda: _wordcount(pkg, d))
            return got, _counts(out)

        _got, (counts, _d) = _both(scenario)
        assert counts["incremental_merges"] == 0

    def test_uncertified_fold_is_ineligible(self, tmp_path):
        binop = lambda a, b: a + b  # noqa: E731 - no assoc certificate

        def scenario(pkg, s, tag):
            d = str(tmp_path / (tag + "-data"))
            _corpus(d)
            _wordcount(pkg, d, binop).run(name="reuse-lam")
            with open(os.path.join(d, "f3.txt"), "w") as f:
                for j in range(50):
                    f.write("more{} appended tokens\n".format(j % 5))
            out = _wordcount(pkg, d, binop).run(name="reuse-lam")
            got = sorted(out.stream())
            assert got == _cold(pkg, s, lambda: _wordcount(pkg, d, binop))
            return got, _counts(out)

        _got, (counts, decisions) = _both(scenario)
        assert counts["incremental_merges"] == 0
        assert any(x["decision"].startswith("incremental-ineligible")
                   for x in decisions)


class TestConcurrentPublish:
    def test_race_resolves_to_one_winner(self, reuse_on):
        from dampr_tpu_torch.blocks import Block
        from dampr_tpu_torch.runner import MTRunner
        from dampr_tpu_torch.storage import PartitionSet

        runner = MTRunner("reuse-race",
                          dampr_tpu_torch.Dampr.memory([1]).pmer.graph)
        try:
            def mk_pset():
                pset = PartitionSet(2)
                blk = Block(np.arange(20, dtype=np.int64),
                            np.arange(20, dtype=np.int64) * 3)
                for pid, sub in blk.split_by_partition(2).items():
                    pset.add(pid, runner.store.register(sub))
                return pset

            key = reuse._resume._h("race-key")
            struct = reuse._resume._h("race-struct")
            cache = reuse.CacheStore()
            barrier = threading.Barrier(2)
            landed = []

            def publish():
                pset = mk_pset()
                barrier.wait()
                landed.append(cache.publish(
                    key, struct, pset, 20, None, runner.store))

            ts = [threading.Thread(target=publish) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert sorted(b > 0 for b in landed) == [False, True]
            entries = [n for n in os.listdir(
                os.path.join(reuse_on["port"], "entries"))
                if not n.startswith(".tmp-")]
            assert len(entries) == 1
            m = cache.lookup(key)  # the winner validates end to end
            pset, nrec, _ = cache.mount(m, runner.store)
            assert nrec == 20
            got = sorted(
                (int(k), int(v))
                for refs in pset.parts.values() for ref in refs
                for k, v in ref.get().iter_pairs())
            assert got == [(i, i * 3) for i in range(20)]
        finally:
            runner.store.cleanup()


class TestSurfaces:
    def test_stats_renderer_shows_reuse_section(self):
        from dampr_tpu.obs import export as ref_export
        from dampr_tpu_torch.obs import export

        summary = {
            "run": "r", "wall_seconds": 1.0, "stages": [],
            "reuse": {"enabled": True, "hits": 2, "misses": 1,
                      "stages_skipped": 2, "bytes_mounted": 1024,
                      "bytes_published": 0, "incremental_merges": 1,
                      "recompute_fallbacks": 0, "evictions": 0,
                      "decisions": [{"stage": 1, "decision": "hit"}]},
        }
        text = export.format_summary(summary)
        assert "reuse: 2 hit(s)" in text
        assert "s1=hit" in text
        ref = ref_export.format_summary(summary)
        want = [ln for ln in ref.splitlines() if ln.startswith(
            ("reuse:", "  1 incremental", "  decisions:"))]
        assert len(want) == 3
        for line in want:
            assert line in text.splitlines()

    def test_explain_has_reuse_preview(self, tmp_path):
        d = str(tmp_path / "data")
        _corpus(d)

        def scenario(pkg, s, tag):
            _wordcount(pkg, d).run(name="reuse-explain")
            text = _wordcount(pkg, d).explain()
            lines = text.splitlines()
            at = [i for i, ln in enumerate(lines)
                  if ln.startswith("reuse: cache")]
            assert len(at) == 1, text
            rows = []
            for ln in lines[at[0] + 1:]:
                if not ln.startswith("  s"):
                    break
                rows.append(ln)
            return rows

        rows = _both(scenario)
        assert any("would mount" in r for r in rows)

    def test_explain_reuse_off_one_liner(self):
        settings.reuse = "off"
        text = dampr_tpu_torch.Dampr.memory([1, 2, 3]).map(
            lambda x: x).explain()
        assert "reuse: off" in text
        assert "reuse: cache" not in text

    def test_trace_carries_reuse_spans(self, tmp_path, monkeypatch):
        monkeypatch.setattr(settings, "trace", True)
        monkeypatch.setattr(settings, "trace_dir", str(tmp_path / "traces"))
        d = str(tmp_path / "data")
        _corpus(d)
        cats = []
        for _ in range(2):
            # read each trace before the rerun writes its own in its place
            em = _wordcount(dampr_tpu_torch, d).run(name="reuse-traced")
            tf = em.stats().get("trace_file")
            assert tf and os.path.isfile(tf)
            with open(tf) as f:
                cats.append({(e.get("cat"), e.get("name", "").split(":")[0])
                             for e in json.load(f)["traceEvents"]})
        assert ("reuse", "publish") in cats[0]
        assert ("reuse", "plan") in cats[1]
        assert ("reuse", "mount") in cats[1]

    def test_doctor_reads_the_ports_thrash(self, tmp_path, monkeypatch):
        """The JAX package's doctor diagnoses a port run's stats.json:
        a budget that evicts as much as it hits is ``reuse-thrash``."""
        from dampr_tpu.obs import doctor

        monkeypatch.setattr(settings, "trace", True)
        monkeypatch.setattr(settings, "trace_dir", str(tmp_path / "traces"))
        d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
        _corpus(d1, stamp="aa")
        _corpus(d2, stamp="bb")
        P = dampr_tpu_torch
        first = _wordcount(P, d1).run(name="thrash-a")
        settings.reuse_budget_bytes = int(
            first.stats()["reuse"]["bytes_published"] * 1.25)
        second = _wordcount(P, d2).run(name="thrash-b")
        ru = second.stats()["reuse"]
        assert ru["evictions"] >= 1 and ru["hits"] == 0
        rep = doctor.diagnose(second.stats()["stats_file"])
        found = [x for x in rep["findings"]
                 if x["bottleneck"] == "reuse-thrash"]
        assert found, rep["findings"]
        assert rep["reuse"]["evictions"] == ru["evictions"]

    def test_doctor_playbook_reuse_knobs_exist(self):
        """Every knob the JAX doctor suggests for a reuse finding is a
        setting of the port too."""
        from dampr_tpu.obs.doctor import _PLAYBOOK

        for verdict in ("reuse-thrash", "reuse-off"):
            assert verdict in _PLAYBOOK
            for knob, _env, _fn, _why in _PLAYBOOK[verdict]:
                assert hasattr(settings, knob), knob


# ---------------------------------------------------------------------------
# the card's hazards, on the CPU device with lowering forced on
# ---------------------------------------------------------------------------

def _docfreq_corpus(d, nfiles, seed=3, lines=700):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(150)]
    os.makedirs(d, exist_ok=True)
    for i in range(nfiles):
        with open(os.path.join(d, "f{}.txt".format(i)), "w") as f:
            for _ in range(lines):
                f.write(" ".join(rng.choice(words, size=rng.randint(1, 9)))
                        + "\n")


def _docfreq(pkg, text, d):
    return (pkg.Dampr.text(d, 16 * 1024)
            .custom_mapper(text.DocFreq(mode="word", lower=True,
                                        pair_values=False))
            .fold_values(operator.add))


@pytest.fixture
def handoff_on(monkeypatch):
    monkeypatch.setattr(settings, "lower", "on")
    monkeypatch.setattr(settings, "handoff", "on")
    monkeypatch.setattr(settings, "pipeline", "off")
    monkeypatch.setattr(ref_settings, "lower", "1")


def _ref_docfreq_cold(d):
    from dampr_tpu.ops import text as ref_text

    old = ref_settings.reuse
    ref_settings.reuse = "off"
    try:
        return sorted(_docfreq(dampr_tpu, ref_text, d).run(
            name="df-ref-cold").read())
    finally:
        ref_settings.reuse = old


def _handoff_edge(em):
    edges = em.stats()["plan"]["lowering"]["handoff"]
    assert len(edges) == 1, edges
    return edges[0]


class TestHandoffHazards:
    def test_device_refs_publish_through_ensure_on_disk(
            self, reuse_on, tmp_path, handoff_on, monkeypatch):
        from dampr_tpu_torch import resume
        from dampr_tpu_torch.ops import text as port_text

        d = str(tmp_path / "data")
        _docfreq_corpus(d, 3)
        calls = []
        real = resume._ensure_on_disk

        def spy(ref, directory, pool=None):
            calls.append(ref.is_device)
            return real(ref, directory, pool)

        monkeypatch.setattr(resume, "_ensure_on_disk", spy)
        em = _docfreq(dampr_tpu_torch, port_text, d).run(name="df-publish")
        got = sorted(em.read())
        st = em.stats()
        assert st["device"]["handoff_bytes"] > 0
        assert _handoff_edge(em)["kind"] == "resident"
        # every device ref went through the checkpoint path, fetched once
        assert calls and all(calls)
        assert st["device"]["d2h_bytes"] > 0
        assert st["reuse"]["bytes_published"] > 0
        em.delete()
        # the run's store is gone; the entries survive it, uncharged
        entries = _entry_dirs(reuse_on["port"])
        assert len(entries) == 2
        for e in entries:
            with open(os.path.join(e, "manifest.json")) as f:
                m = json.load(f)
            for b in m["blocks"]:
                assert os.path.getsize(os.path.join(e, b[1])) == b[6]
        again = _docfreq(dampr_tpu_torch, port_text, d).run(
            name="df-publish")
        assert sorted(again.read()) == got == _ref_docfreq_cold(d)
        assert again.stats()["reuse"]["hits"] == 1
        assert again.stats()["device"]["handoff_bytes"] == 0

    def test_mounted_producer_takes_the_folds_host_path(
            self, reuse_on, tmp_path, handoff_on):
        from dampr_tpu_torch.ops import text as port_text

        d = str(tmp_path / "data")
        _docfreq_corpus(d, 3)
        em = _docfreq(dampr_tpu_torch, port_text, d).run(name="df-mount")
        got = sorted(em.read())
        # drop the fold's entry (published last): the rerun's fold misses
        # and its producer, planned as a handoff edge, mounts
        newest = max(_entry_dirs(reuse_on["port"]), key=lambda e: json.load(
            open(os.path.join(e, "manifest.json")))["created"])
        shutil.rmtree(newest)
        em2 = _docfreq(dampr_tpu_torch, port_text, d).run(name="df-mount")
        assert sorted(em2.read()) == got == _ref_docfreq_cold(d)
        st = em2.stats()
        edge = _handoff_edge(em2)
        assert edge["handoff"] == "device" and edge["kind"] == "mounted"
        decisions = {x["stage"]: x["decision"]
                     for x in st["reuse"]["decisions"]}
        assert decisions[edge["src"]] == "hit"
        assert decisions[edge["dst"]] == "miss"
        kinds = [s["kind"] for s in st["stages"]]
        assert kinds == ["reused-map", "reduce"]
        # host frames into the fold's host path: no device fold, no
        # degrade, nothing registered on the device, no fault
        assert st["device"]["mesh_folds"] == 0
        assert st["device"]["handoff_degrades"] == 0
        assert st["device"]["handoff_bytes"] == 0
        assert st["faults"]["retries"] == 0
        assert sum(sum(s["launches"].values()) for s in st["stages"]) == 0

    def test_incremental_unions_host_frames_with_device_refs(
            self, reuse_on, tmp_path, handoff_on, monkeypatch):
        from dampr_tpu_torch.ops import text as port_text
        from dampr_tpu_torch.runner import MTRunner

        d = str(tmp_path / "data")
        _docfreq_corpus(d, 3)
        _docfreq(dampr_tpu_torch, port_text, d).run(name="df-incr")
        _docfreq_corpus(str(tmp_path / "extra"), 1, seed=11)
        shutil.move(str(tmp_path / "extra" / "f0.txt"),
                    os.path.join(d, "f3.txt"))
        stores = []
        real_init = MTRunner.__init__

        def keep(self, *a, **kw):
            real_init(self, *a, **kw)
            stores.append(self.store)

        monkeypatch.setattr(MTRunner, "__init__", keep)
        em = _docfreq(dampr_tpu_torch, port_text, d).run(name="df-incr")
        got = sorted(em.read())
        st = em.stats()
        assert got == _ref_docfreq_cold(d)
        edge = _handoff_edge(em)
        assert edge["kind"] == "incremental"
        decisions = {x["stage"]: x["decision"]
                     for x in st["reuse"]["decisions"]}
        assert decisions[edge["src"]] == "incremental:1-new-file(s)"
        assert st["reuse"]["incremental_merges"] == 1
        # the new file's partials stayed on the device into the fold,
        # which took the cached host frames in the same pass
        assert st["device"]["handoff_bytes"] > 0
        assert st["device"]["mesh_folds"] == 1
        assert st["device"]["handoff_degrades"] == 0
        # the HBM charge returned to 0
        assert stores[-1]._dev_bytes == 0
        # and the merged output published under the grown corpus's key
        em3 = _docfreq(dampr_tpu_torch, port_text, d).run(name="df-incr")
        assert sorted(em3.read()) == got
        assert em3.stats()["reuse"]["hits"] == 1
