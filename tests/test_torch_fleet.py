"""The fleet observability of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_fleet.py``, host-side (the 2-process
runs are ``test_torch_fleet_mp.py``'s).  Per-rank artifacts are written
through the port's export path (its rank and clock handshake pinned the
way the writers read them), and both packages' ``fleet`` modules merge
the same files: the sections, shifts, skew and merged timelines are
equal (the merged trace's ``producer`` names its package).  The port's
rank-tagged crashdumps, history records, critpath skew, doctor fleet
verdicts, Prometheus rank labels and the metrics endpoint's rank follow
the JAX package's.  Inputs are seeded.
"""

import importlib.util
import json
import os
import random
import urllib.request

import pytest

from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import critpath as ref_critpath
from dampr_tpu.obs import doctor as ref_doctor
from dampr_tpu.obs import fleet as ref_fleet
from dampr_tpu_torch import settings
from dampr_tpu_torch.obs import (critpath, doctor, export, fleet, flightrec,
                                 history, metrics as obs_metrics, promtext,
                                 serve, trace)
from dampr_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


validate_trace = _load_tool("validate_trace")

with open(os.path.join(ROOT, "docs", "trace_schema.json")) as _f:
    TRACE_SCHEMA = json.load(_f)
with open(os.path.join(ROOT, "docs", "doctor_schema.json")) as _f:
    DOCTOR_SCHEMA = json.load(_f)


@pytest.fixture
def scratch(tmp_path, monkeypatch):
    for st in (settings, ref_settings):
        monkeypatch.setattr(st, "scratch_root", str(tmp_path / "scratch"))
        monkeypatch.setattr(st, "trace_dir", None)
    return tmp_path


def _set_rank(monkeypatch, rank, num, barrier_perf=None):
    """Pin the process identity and clock handshake the port's artifact
    writers read."""
    monkeypatch.setattr(mesh, "rank_info", lambda: (rank, num))
    monkeypatch.setattr(
        mesh, "clock_sync",
        None if barrier_perf is None else {
            "barrier_perf": barrier_perf,
            "barrier_wall": 1000.0 + barrier_perf,
            "method": "test",
        })


def _write_rank_artifacts(monkeypatch, run, rank, num, events,
                          epoch=0.0, barrier=None, wall_start=1000.0,
                          stats_extra=None, counters=()):
    """One rank's trace.json and stats.json through the port's export.
    ``events`` are tracer tuples relative to this rank's epoch; barrier
    None is a rank without the handshake."""
    _set_rank(monkeypatch, rank, num, barrier_perf=barrier)
    tracer = trace.Tracer(run)
    tracer.epoch = epoch
    tracer.wall_start = wall_start
    tracer.events = list(events)
    for _cat, _name, _t0, _dur, lane, _args in events:
        if lane is not None and lane not in tracer.lane_names:
            tracer.lane_names[lane] = str(lane)
    tdir = export.run_trace_dir(run, rank=rank)
    os.makedirs(tdir, exist_ok=True)
    tpath = export.write_trace(tracer, os.path.join(tdir,
                                                    export.TRACE_FILE))
    if counters:
        with open(tpath) as f:
            doc = json.load(f)
        doc["traceEvents"].extend(counters)
        with open(tpath, "w") as f:
            json.dump(doc, f)
    summary = {
        "schema": export.STATS_SCHEMA,
        "run": run,
        "process": export.process_section(),
        "started_at": wall_start,
        "wall_seconds": 2.0 + rank,
        "stages": [],
        "totals": {"records_out": 100 * (rank + 1),
                   "bytes_out": 1000 * (rank + 1),
                   "spill_bytes": 10 * rank},
        "trace_file": tpath,
    }
    if stats_extra:
        summary.update(stats_extra)
    spath = os.path.join(tdir, export.STATS_FILE)
    summary["stats_file"] = spath
    export.write_stats(summary, spath)
    return tdir


def _span(cat, name, t0, dur, lane="L"):
    return (cat, name, t0, dur, lane, None)


def _both_merge(run, **kw):
    """The JAX package's merge (computed only) and the port's (written):
    equal but for the file the port wrote."""
    ref = ref_fleet.merge_run(run, write=False, **kw)
    port = fleet.merge_run(run, **kw)
    if ref is None:
        assert port is None
        return None
    got = {k: v for k, v in port.items() if k != "merged_trace_file"}
    assert got == ref
    return port


def _merged_equal(run):
    ranks = fleet.load_ranks(run)
    assert ranks == ref_fleet.load_ranks(run)
    shifts = fleet.clock_shifts(ranks)
    assert shifts == ref_fleet.clock_shifts(ranks)
    doc, t0 = fleet.merge_traces(ranks, shifts[0])
    ref_doc, ref_t0 = ref_fleet.merge_traces(ranks, shifts[0])
    assert doc["otherData"].pop("producer") == "dampr_tpu_torch.obs.fleet"
    ref_doc["otherData"].pop("producer")
    assert (doc, t0) == (ref_doc, ref_t0)
    return ranks, shifts, doc


class TestRankArtifacts:
    def test_rank_dirs_layout(self, scratch, monkeypatch):
        d0 = _write_rank_artifacts(monkeypatch, "lay", 0, 2,
                                   [_span("stage", "s0:map", 0.0, 1.0)])
        d1 = _write_rank_artifacts(monkeypatch, "lay", 1, 2,
                                   [_span("stage", "s0:map", 0.0, 1.0)])
        assert d0.endswith(os.path.join("lay", "trace"))
        assert d1.endswith(os.path.join("lay", "trace", "rank1"))
        assert fleet.rank_dirs("lay") == ref_fleet.rank_dirs("lay") == {
            0: d0, 1: d1}

    def test_artifacts_carry_process_identity(self, scratch, monkeypatch):
        _write_rank_artifacts(monkeypatch, "ident", 1, 3,
                              [_span("codec", "w", 0.0, 0.5)],
                              epoch=5.0, barrier=4.0)
        d = export.run_trace_dir("ident", rank=1)
        with open(os.path.join(d, export.TRACE_FILE)) as f:
            proc = json.load(f)["otherData"]["process"]
        assert proc["process_id"] == 1 and proc["num_processes"] == 3
        assert proc["epoch_perf"] == 5.0
        assert proc["clock"]["barrier_perf"] == 4.0
        with open(os.path.join(d, export.STATS_FILE)) as f:
            assert json.load(f)["process"]["process_id"] == 1

    def test_rank_info_env_fallback(self, monkeypatch):
        monkeypatch.setattr(mesh, "_initialized", False)
        monkeypatch.setenv("DAMPR_TPU_TORCH_NUM_PROCESSES", "4")
        monkeypatch.setenv("DAMPR_TPU_TORCH_PROCESS_ID", "2")
        assert mesh.rank_info() == (2, 4)
        assert export.process_section() == {"process_id": 2,
                                            "num_processes": 4}
        monkeypatch.delenv("DAMPR_TPU_TORCH_NUM_PROCESSES")
        monkeypatch.delenv("DAMPR_TPU_TORCH_PROCESS_ID")
        assert mesh.rank_info() == (0, 1)


class TestClockAlignment:
    def test_merge_ordering_respects_handshake_offsets(self, scratch,
                                                       monkeypatch):
        """Events at known fleet-common times, seen through ranks whose
        monotonic clocks drift far apart, come back in true order and
        with true gaps, and both packages merge them alike."""
        rng = random.Random(17)
        for trial in range(8):
            run = "drift{}".format(trial)
            n = rng.choice([2, 3, 4])
            truth = []
            ranks_events = {r: [] for r in range(n)}
            for i in range(24):
                t = rng.uniform(0.0, 8.0)
                r = rng.randrange(n)
                truth.append((t, "e{}".format(i)))
                ranks_events[r].append((t, "e{}".format(i)))
            for r in range(n):
                barrier_r = rng.uniform(0.0, 200.0)
                epoch_r = barrier_r + rng.uniform(-2.0, 2.0)
                events = [_span("codec", name, barrier_r + t - epoch_r,
                                0.001) for t, name in ranks_events[r]]
                _write_rank_artifacts(monkeypatch, run, r, n, events,
                                      epoch=epoch_r, barrier=barrier_r)
            _ranks, (_shifts, mode), doc = _merged_equal(run)
            assert mode == "clock"
            got = sorted((ev["ts"], ev["name"])
                         for ev in doc["traceEvents"] if ev.get("ph") == "X")
            want = sorted(truth)
            assert [nm for _t, nm in got] == [nm for _t, nm in want]
            for (gt, _), (wt, _) in zip(got, want):
                assert abs((gt - got[0][0]) / 1e6
                           - (wt - want[0][0])) < 1e-3

    def test_wall_fallback_when_handshake_missing(self, scratch,
                                                  monkeypatch):
        run = "nowclock"
        _write_rank_artifacts(monkeypatch, run, 0, 2,
                              [_span("codec", "a", 0.0, 0.1)],
                              barrier=None, wall_start=1000.0)
        _write_rank_artifacts(monkeypatch, run, 1, 2,
                              [_span("codec", "b", 0.0, 0.1)],
                              barrier=None, wall_start=1003.5)
        _ranks, (shifts, mode), _doc = _merged_equal(run)
        assert mode == "wall"
        assert shifts[0] == 0.0 and abs(shifts[1] - 3.5) < 1e-9

    def test_merged_trace_validates_with_counters(self, scratch,
                                                  monkeypatch):
        run = "valid"
        for r in range(2):
            counters = [
                {"ph": "C", "name": "store.resident_bytes",
                 "cat": "metric", "pid": 1, "tid": 0,
                 "ts": float(i * 1000), "args": {"value": i * (r + 1)}}
                for i in range(4)]
            _write_rank_artifacts(
                monkeypatch, run, r, 2,
                [_span("exchange", "step:0", 0.1 * (r + 1), 0.5),
                 _span("stage", "s0:map", 0.0, 1.0)],
                epoch=10.0 * r, barrier=10.0 * r - 0.5 * r,
                counters=counters)
        section = _both_merge(run)
        with open(section["merged_trace_file"]) as f:
            doc = json.load(f)
        assert validate_trace.validate(doc, TRACE_SCHEMA,
                                       require_cats=("exchange",)) == []
        assert {ev["name"] for ev in doc["traceEvents"]
                if ev.get("ph") == "C"} == {"rank0/store.resident_bytes",
                                            "rank1/store.resident_bytes"}
        assert {ev["pid"] for ev in doc["traceEvents"]} == {1, 2}


class TestSkewMath:
    def _ranks_with_steps(self, monkeypatch, run, entries):
        n = len(entries)
        for r, steps in entries.items():
            events = [_span("exchange", "step:{}".format(s), t, d)
                      for s, t, d in steps]
            _write_rank_artifacts(monkeypatch, run, r, n, events,
                                  epoch=0.0, barrier=0.0)
        return fleet.load_ranks(run)

    def _skew(self, ranks):
        shifts, _ = fleet.clock_shifts(ranks)
        skew = fleet.step_skew(ranks, shifts)
        assert skew == ref_fleet.step_skew(ranks, shifts)
        return skew

    def test_skew_fractions_in_unit_interval(self, scratch, monkeypatch):
        rng = random.Random(5)
        for trial in range(20):
            n = rng.choice([2, 3, 4])
            entries = {r: [(s, rng.uniform(0, 2), rng.uniform(0.001, 1))
                           for s in range(rng.randrange(1, 5))]
                       for r in range(n)}
            skew = self._skew(self._ranks_with_steps(
                monkeypatch, "skewp{}".format(trial), entries))
            if skew is None:
                continue
            for st in skew["steps"]:
                assert 0.0 <= st["fraction"] <= 1.0
            assert skew["late_ratio"] >= 1.0 - 1e-9

    def test_straggler_identified(self, scratch, monkeypatch):
        skew = self._skew(self._ranks_with_steps(monkeypatch, "strag", {
            0: [(0, 0.0, 1.0), (1, 2.0, 1.0)],
            1: [(0, 0.8, 0.2), (1, 2.8, 0.2)]}))
        assert skew["straggler_rank"] == 1
        assert skew["max_fraction"] >= 0.7
        assert abs(skew["skew_seconds"] - 1.6) < 1e-6

    def test_single_rank_steps_yield_no_skew(self, scratch, monkeypatch):
        assert self._skew(self._ranks_with_steps(
            monkeypatch, "solo", {0: [(0, 0.0, 1.0)]})) is None


class TestFleetSection:
    def test_single_process_run_has_no_fleet_section(self, scratch,
                                                     monkeypatch):
        run = "single"
        _write_rank_artifacts(monkeypatch, run, 0, 1,
                              [_span("stage", "s0:map", 0.0, 1.0)])
        assert _both_merge(run) is None
        base = export.run_trace_dir(run, rank=0)
        assert not os.path.isdir(os.path.join(base, fleet.FLEET_DIR))
        with open(os.path.join(base, export.STATS_FILE)) as f:
            assert "fleet" not in json.load(f)

    def test_exchange_matrices_from_routes(self, scratch, monkeypatch):
        routes = [[0, 4, 100], [4, 0, 70], [1, 2, 30], [5, 6, 9]]
        extra = {"mesh": {"exchange": {
            "routes": routes,
            "sent_per_device": {"0": 100, "4": 70, "1": 30, "5": 9},
            "received_per_device": {"4": 100, "0": 70, "2": 30, "6": 9},
        }}}
        for r in range(2):
            _write_rank_artifacts(
                monkeypatch, "matrix", r, 2,
                [_span("exchange", "step:0", 0.1 * r, 0.5)],
                epoch=0.0, barrier=0.0, stats_extra=extra)
        section = _both_merge("matrix")
        ex = section["exchange"]
        assert ex["devices"] == 7 and ex["bytes"] == 209
        assert ex["rank_sent_matrix"] == [[30, 100], [70, 9]]
        pr = {e["rank"]: e for e in section["per_rank"]}
        assert (pr[0]["exchange_sent_bytes"],
                pr[1]["exchange_sent_bytes"]) == (130, 79)

    def test_device_count_prefers_process_block(self, scratch,
                                                 monkeypatch):
        """The port stamps ``global_devices`` once its process group is
        up: the shard -> rank map reads it before any route maximum."""
        routes = [[0, 3, 50], [3, 0, 20]]
        extra = {"mesh": {"exchange": {
            "routes": routes, "sent_per_device": {"0": 50, "3": 20},
            "received_per_device": {"3": 50, "0": 20}}}}
        monkeypatch.setattr(mesh, "_initialized", True)
        monkeypatch.setattr(settings, "mesh_devices", "cpu*4")
        for r in range(2):
            _write_rank_artifacts(
                monkeypatch, "devcount", r, 2,
                [_span("exchange", "step:0", 0.1 * r, 0.5)],
                epoch=0.0, barrier=0.0, stats_extra=extra)
        monkeypatch.setattr(mesh, "_initialized", False)
        with open(os.path.join(export.run_trace_dir("devcount", rank=1),
                               export.STATS_FILE)) as f:
            proc = json.load(f)["process"]
        assert (proc["global_devices"], proc["local_devices"]) == (8, 4)
        ex = _both_merge("devcount")["exchange"]
        assert ex["devices"] == 8
        assert ex["rank_sent_matrix"] == [[70, 0], [0, 0]]

    def test_per_rank_totals_and_straggler_lateness(self, scratch,
                                                    monkeypatch):
        for r in range(2):
            _write_rank_artifacts(
                monkeypatch, "totals", r, 2,
                [_span("exchange", "step:0", 0.5 * r, 1.0 - 0.4 * r)],
                epoch=0.0, barrier=0.0)
        section = _both_merge("totals")
        assert (section["num_processes"], section["ranks"],
                section["missing_ranks"], section["alignment"]) == (
                    2, [0, 1], [], "clock")
        pr = {e["rank"]: e for e in section["per_rank"]}
        assert pr[1]["mean_entry_lateness_seconds"] == pytest.approx(0.5)
        assert section["skew"]["straggler_rank"] == 1

    def test_missing_rank_recorded(self, scratch, monkeypatch):
        for r, t in ((0, 0.0), (1, 0.2)):
            _write_rank_artifacts(
                monkeypatch, "short", r, 3,
                [_span("exchange", "step:0", t, 1.0 - t)],
                epoch=0.0, barrier=0.0)
        assert _both_merge("short", wait_ms=50)["missing_ranks"] == [2]

    def test_fleet_injected_into_rank0_stats(self, scratch, monkeypatch):
        for r in range(2):
            _write_rank_artifacts(
                monkeypatch, "inject", r, 2,
                [_span("exchange", "step:0", 0.3 * r, 0.5)],
                epoch=0.0, barrier=0.0)
        _both_merge("inject")
        with open(os.path.join(export.run_trace_dir("inject", rank=0),
                               export.STATS_FILE)) as f:
            stats = json.load(f)
        assert stats["fleet"]["num_processes"] == 2
        assert os.path.isfile(stats["fleet"]["merged_trace_file"])

    def test_format_fleet_equal(self, scratch, monkeypatch):
        for r in range(2):
            _write_rank_artifacts(
                monkeypatch, "fmt", r, 2,
                [_span("exchange", "step:0", 0.3 * r, 0.5)],
                epoch=0.0, barrier=0.0)
        section = _both_merge("fmt")
        assert fleet.format_fleet(section) == ref_fleet.format_fleet(
            section)
        assert fleet.format_fleet(None) == ref_fleet.format_fleet(None)


class TestCritpathSkew:
    def test_apply_skew_injects_resource_and_can_flip_verdict(self):
        def section():
            return {"run": {"verdict": "mesh", "fractions": {"mesh": 0.3},
                            "attributed_fraction": 0.3, "seconds": 10.0}}

        fl = {"skew": {"skew_seconds": 6.0}}
        out = critpath.apply_skew(section(), fl, wall=10.0)
        assert out == ref_critpath.apply_skew(section(), fl, wall=10.0)
        assert out["run"]["verdict"] == "skew"
        assert out["run"]["fractions"]["skew"] == pytest.approx(0.6)

    def test_apply_skew_noop_without_skew(self):
        section = {"run": {"verdict": "codec", "fractions": {"codec": 0.8}}}
        out = critpath.apply_skew(section, {}, wall=10.0)
        assert out["run"]["verdict"] == "codec"
        assert "skew" not in out["run"]["fractions"]

    def test_skew_in_priority_taxonomy(self):
        assert "skew" in critpath._PRIORITY
        assert critpath._PRIORITY == ref_critpath._PRIORITY


class TestDoctorFleet:
    def _diagnosable_run(self, monkeypatch, run="doc-fleet"):
        for r in range(2):
            dur = 0.2 if r else 1.0
            events = [_span("exchange", "step:{}".format(s),
                            2.0 * s + (0.8 if r else 0.0), dur)
                      for s in range(3)]
            events.append(_span("stage", "s0:reduce", 0.0, 6.0))
            extra = {"wall_seconds": 6.0,
                     "critpath": {"source": "spans", "stages": [],
                                  "run": {"verdict": "codec",
                                          "fractions": {"codec": 0.5}}}}
            _write_rank_artifacts(monkeypatch, run, r, 2, events,
                                  epoch=0.0, barrier=0.0, stats_extra=extra)
        fleet.merge_run(run)
        return export.run_trace_dir(run, rank=0)

    def test_doctor_names_straggler_with_real_knob(self, scratch,
                                                   monkeypatch):
        rundir = self._diagnosable_run(monkeypatch)
        report = doctor.diagnose(rundir)
        ref = ref_doctor.diagnose(rundir)
        assert report["fleet"] == ref["fleet"]
        assert report["fleet"]["straggler_rank"] == 1
        skews = [f for f in report["findings"] if f["bottleneck"] == "skew"]
        ref_skews = [f for f in ref["findings"] if f["bottleneck"] == "skew"]
        assert skews and skews[0]["evidence"] == ref_skews[0]["evidence"]
        assert "rank 1" in skews[0]["evidence"]
        settings_named = [s["setting"] for s in skews[0]["suggestions"]]
        assert settings_named == [s["setting"]
                                  for s in ref_skews[0]["suggestions"]]
        for s in skews[0]["suggestions"]:
            assert history.knob_home(s["setting"]) is not None

    def test_doctor_report_schema_valid_with_fleet(self, scratch,
                                                   monkeypatch):
        report = doctor.diagnose(self._diagnosable_run(monkeypatch))
        assert _load_tool("validate_doctor").validate(
            report, DOCTOR_SCHEMA) == []

    def test_doctor_human_rendering_mentions_fleet(self, scratch,
                                                   monkeypatch):
        out = doctor.format_report(doctor.diagnose(
            self._diagnosable_run(monkeypatch)))
        assert "straggler: rank 1" in out

    def test_single_process_report_has_no_fleet(self, scratch,
                                                monkeypatch):
        _write_rank_artifacts(
            monkeypatch, "doc-solo", 0, 1,
            [_span("stage", "s0:map", 0.0, 1.0)],
            stats_extra={"critpath": {"source": "spans", "stages": [],
                                      "run": {"verdict": "codec",
                                              "fractions": {}}}})
        assert "fleet" not in doctor.diagnose(
            export.run_trace_dir("doc-solo", rank=0))


class TestHistoryRankDiscipline:
    def _summary(self, rank, num):
        return {
            "run": "hist-run",
            "process": {"process_id": rank, "num_processes": num},
            "wall_seconds": 1.0, "started_at": 1.0, "n_partitions": 4,
            "stages": [{"stage": 0, "kind": "map", "jobs": 1,
                        "records_in": 10, "records_out": 10,
                        "bytes_in": 100, "bytes_out": 100,
                        "spill_bytes": 0, "seconds": 0.5}],
            "totals": {"records_out": 10, "bytes_out": 100},
            "plan": {"stage_shapes": [{"shape": "map"}]},
        }

    def test_nonzero_rank_records_are_tagged_and_excluded(self, scratch):
        rec0 = history.compact_record(self._summary(0, 2))
        rec1 = history.compact_record(self._summary(1, 2))
        assert "rank" not in rec0 and rec1["rank"] == 1
        shapes = [{"shape": "map"}]
        assert history.matching([rec0, rec1], shapes) == [rec0]

    def test_corpus_append_roundtrip_keeps_rank(self, scratch):
        assert history.append(self._summary(0, 2)) == history.append(
            self._summary(1, 2))
        recs = history.load("hist-run")
        assert [r.get("rank") for r in recs] == [None, 1]
        assert len(history.matching(recs, [{"shape": "map"}])) == 1


class TestCrashdumpRankAttribution:
    def test_crashdump_filename_per_rank(self):
        from dampr_tpu.obs import flightrec as ref_flightrec

        for r in (0, 1, 2, 7):
            assert flightrec.crashdump_filename(r) == \
                ref_flightrec.crashdump_filename(r)

    def test_flush_lands_in_rank_dir_and_is_discoverable(self, scratch,
                                                         monkeypatch):
        from dampr_tpu.obs import flightrec as ref_flightrec

        _set_rank(monkeypatch, 1, 2)
        rec = flightrec.FlightRecorder("crash-run", 16)
        rec.record_span("codec", "w", 0.0, 0.1, 1, "lane", None)
        path = rec.flush("test-kill")
        assert path.endswith(os.path.join("rank1", "crashdump.rank1.json"))
        with open(path) as f:
            doc = json.load(f)
        assert doc["otherData"]["process"]["process_id"] == 1
        assert validate_trace.validate(doc, TRACE_SCHEMA) == []
        _set_rank(monkeypatch, 0, 2)
        rec0 = flightrec.FlightRecorder("crash-run", 16)
        rec0.record_span("codec", "w", 0.0, 0.1, 1, "lane", None)
        path0 = rec0.flush("test-kill")
        base = export.run_trace_dir("crash-run", rank=0)
        dumps = flightrec.locate_all_crashdumps(base)
        assert dumps == ref_flightrec.locate_all_crashdumps(base)
        assert dumps == sorted([path0, path])
        assert flightrec.locate_crashdump(base) == path0


class TestPromtextRankLabels:
    def test_multiprocess_summary_gets_rank_label(self):
        out = promtext.render_summary({
            "run": "r", "process": {"process_id": 1, "num_processes": 2},
            "metrics": {"counters": {"store.records": 5}}})
        assert 'rank="1"' in out and 'run="r"' in out

    def test_single_process_summary_stays_unlabeled(self):
        out = promtext.render_summary({
            "run": "r", "process": {"process_id": 0, "num_processes": 1},
            "metrics": {"counters": {"store.records": 5}}})
        assert "rank=" not in out


class TestServeEndpoint:
    def _get(self, port, path):
        with urllib.request.urlopen(
                "http://127.0.0.1:{}{}".format(port, path),
                timeout=5) as resp:
            return resp.status, resp.read().decode("utf-8")

    def test_rank_comes_from_the_process_group(self, monkeypatch):
        """The endpoint's rank is the mesh's (the launcher environment
        before a group is up), no longer a fixed 0 of 1."""
        monkeypatch.setattr(mesh, "_initialized", False)
        monkeypatch.setenv("DAMPR_TPU_TORCH_NUM_PROCESSES", "2")
        monkeypatch.setenv("DAMPR_TPU_TORCH_PROCESS_ID", "1")
        assert serve.rank_info() == (1, 2)
        srv = serve.MetricsServer(0).start()
        try:
            status, body = self._get(srv.port, "/healthz")
            assert status == 200
            assert json.loads(body)["process_id"] == 1
        finally:
            srv.stop()

    def test_metrics_rank_label_from_live_run(self, monkeypatch):
        monkeypatch.setattr(mesh, "rank_info", lambda: (1, 2))
        reg = obs_metrics.Metrics("serve-run")
        reg.counter_add("store.records", 42)
        obs_metrics.start(reg)
        srv = serve.MetricsServer(0, run_name="serve-run").start()
        try:
            status, body = self._get(srv.port, "/metrics")
            assert status == 200 and 'rank="1"' in body
        finally:
            srv.stop()
            obs_metrics.stop(reg)

    def test_per_rank_port_offset(self, monkeypatch):
        monkeypatch.setattr(mesh, "rank_info", lambda: (2, 4))
        srv = serve.MetricsServer(9300)
        assert srv.base_port == 9300 and srv.rank == 2
        assert srv.num_processes == 4
