"""The regression sentry of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_sentry.py``: the port's ``detect``
equals the JAX ``detect`` on 200 seeded series (flat baselines with MAD
0, windows of fewer than 3 points, improvements that never alarm), the
finding's knob pointer excepted: the port names its own knob and
variable, and none for ``late_ratio`` (mitigation comes with several
devices).  The CLI's exit codes equal the JAX CLI's over one telemetry
store.  End to end, a port run made slow after five like it gets a
``summary["sentry"]`` finding and a ``sentry-regression`` event, and the
two CLIs' ``--strict`` agree on it.
"""

import json
import operator
import os
import time

import numpy as np
import pytest

import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import sentry as ref_sentry
from dampr_tpu.obs import timeseries as ref_timeseries
from dampr_tpu_torch import settings
from dampr_tpu_torch.obs import history, sentry, timeseries

KNOB_KEYS = ("setting", "env", "why")


@pytest.fixture
def scratch(tmp_path):
    """Both packages over one scratch root; the port on the CPU."""
    old = (settings.scratch_root, ref_settings.scratch_root,
           settings.device, settings.sentry_window)
    settings.scratch_root = ref_settings.scratch_root = str(
        tmp_path / "scratch")
    settings.device = "cpu"
    settings.sentry_window = 8
    yield tmp_path
    (settings.scratch_root, ref_settings.scratch_root, settings.device,
     settings.sentry_window) = old


def _series(rng, i):
    """One seeded series: 1-12 points, some metrics flat (MAD 0), some
    missing, the newest sometimes far off in either direction."""
    n = int(rng.randint(1, 13))
    flat = rng.rand() < 0.3
    pts = []
    for j in range(n):
        p = {"schema": timeseries.SCHEMA, "run": "s{}".format(i),
             "ts": 1000.0 + j, "fingerprint": "f{}".format(i % 3)}
        for metric in timeseries.METRICS:
            if rng.rand() < 0.15:
                continue  # a metric with no sample in this point
            base = 0.0 if metric in ("retries", "quarantined") else 10.0
            v = base if flat else base + rng.normal(0, 1)
            if j == n - 1 and rng.rand() < 0.5:
                v = v + rng.choice([-1, 1]) * rng.uniform(0, 40)
            p[metric] = int(round(v)) if metric in (
                "retries", "quarantined") else float(v)
        pts.append(p)
    return pts


def _without_knob(findings):
    return [{k: v for k, v in f.items() if k not in KNOB_KEYS}
            for f in findings]


class TestDetect:
    def test_equals_jax_on_seeded_series(self):
        rng = np.random.RandomState(2024)
        seen = {"findings": 0, "flat": 0, "thin": 0}
        for i in range(200):
            pts = _series(rng, i)
            window = int(rng.choice([0, 1, 2, 3, 5, 8]))
            threshold = float(rng.choice([0.0, 2.0, 3.5]))
            ref = ref_sentry.detect(pts, window=window, threshold=threshold)
            got = sentry.detect(pts, window=window, threshold=threshold)
            assert _without_knob(got) == _without_knob(ref), i
            for f in got:
                knob = sentry.METRIC_KNOBS.get(f["metric"])
                assert (f["setting"], f["env"], f["why"]) == (
                    knob if knob else (None, None, None))
            seen["findings"] += len(got)
            seen["flat"] += sum(1 for f in got if f["mad"] == 0)
            seen["thin"] += window < 3
        # the draw covers what it claims to
        assert seen["findings"] and seen["flat"] and seen["thin"]

    def test_defaults_from_settings(self, monkeypatch):
        pts = [{"wall_seconds": w, "ts": i} for i, w in
               enumerate([10.0, 10.2, 9.9, 10.1, 13.0])]
        monkeypatch.setattr(settings, "sentry_window", 8)
        monkeypatch.setattr(settings, "sentry_mad_threshold", 3.5)
        assert _without_knob(sentry.detect(pts)) == _without_knob(
            ref_sentry.detect(pts, window=8, threshold=3.5))
        monkeypatch.setattr(settings, "sentry_window", 0)
        assert sentry.detect(pts) == []

    def test_metric_knobs_are_the_ports(self):
        assert set(sentry.METRIC_KNOBS) == set(ref_sentry.METRIC_KNOBS) - {
            "late_ratio"}
        for metric, (knob, env, why) in sentry.METRIC_KNOBS.items():
            assert history.knob_home(knob) is not None, knob
            assert env.startswith("DAMPR_TPU_TORCH_") and why
            assert knob == ref_sentry.METRIC_KNOBS[metric][0]

    def test_format_findings(self):
        pts = [{"wall_seconds": w, "run": "r", "ts": i} for i, w in
               enumerate([10.0, 10.2, 9.9, 10.1, 13.0])]
        lines = sentry.format_findings(sentry.detect(pts, 8, 3.5))
        ref = ref_sentry.format_findings(ref_sentry.detect(pts, 8, 3.5))
        assert lines[0] == ref[0]
        assert lines[1] == ref[1].replace("DAMPR_TPU_", "DAMPR_TPU_TORCH_")


def _write_store(points, run="synth"):
    path = timeseries.store_path(run)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for p in points:
            f.write(json.dumps(p, sort_keys=True) + "\n")


def _point(i, wall):
    return {"schema": timeseries.SCHEMA, "run": "synth", "ts": 1000.0 + i,
            "fingerprint": "feedfacecafebeef", "wall_seconds": wall,
            "mbps": 100.0 / wall}


HEALTHY = [_point(i, w) for i, w in enumerate([10.0, 10.2, 9.9, 10.1,
                                               10.0])]


class TestCLI:
    @pytest.mark.parametrize("newest,argv", [
        (13.0, ["--strict"]), (13.0, []), (10.05, ["--strict"]),
        (13.0, ["--json"]), (13.0, ["--window", "2", "--strict"]),
        (13.0, ["--threshold", "100", "--strict"])])
    def test_exit_codes_equal_jax(self, scratch, capsys, newest, argv):
        _write_store(HEALTHY + [_point(9, newest)])
        got = sentry.main(["synth"] + argv)
        out = capsys.readouterr().out
        assert got == ref_sentry.main(["synth"] + argv)
        ref_out = capsys.readouterr().out
        if "--json" in argv:
            doc, ref_doc = json.loads(out), json.loads(ref_out)
            assert _without_knob(doc.pop("findings")) == _without_knob(
                ref_doc.pop("findings"))
            assert doc == ref_doc
        else:
            assert out.splitlines()[:2] == ref_out.splitlines()[:2]

    def test_missing_run_exits_one(self, scratch, capsys):
        assert sentry.main(["nonesuch", "--strict"]) == 1
        assert "no telemetry" in capsys.readouterr().out
        assert ref_sentry.main(["nonesuch", "--strict"]) == 1

    def test_store_written_by_port_loads_in_jax(self, scratch):
        _write_store(HEALTHY)
        assert ref_timeseries.load("synth") == timeseries.load("synth")


SLOW = {"seconds": 0.0}


def _slowable(kv):
    if SLOW["seconds"]:
        time.sleep(SLOW["seconds"])
    return kv


def _run_once(name):
    em = (dampr_tpu_torch.Dampr.memory([(i % 13, i) for i in range(6000)],
                                       partitions=4)
          .map(_slowable)
          .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
          .run(name))
    stats = em.stats()
    em.delete()
    return stats


class TestEndToEnd:
    @pytest.fixture
    def traced(self, scratch, monkeypatch):
        monkeypatch.setattr(settings, "trace", True)
        monkeypatch.setattr(settings, "trace_dir",
                            str(scratch / "traces"))
        monkeypatch.setitem(SLOW, "seconds", 0.0)
        return scratch

    def test_injected_slowdown_is_a_finding(self, traced, capsys):
        for _ in range(5):
            stats = _run_once("sentry-e2e")
        pts = timeseries.load("sentry-e2e")
        assert len(pts) == 5 and len({p["fingerprint"] for p in pts}) == 1
        SLOW["seconds"] = 0.0005  # half a ms a record: ~0.4 s more a run
        stats = _run_once("sentry-e2e")
        found = stats.get("sentry")
        assert found and any(f["metric"] == "wall_seconds" for f in found)
        events = os.path.join(os.path.dirname(stats["stats_file"]),
                              "events.jsonl")
        with open(events) as f:
            codes = [json.loads(ln)["code"] for ln in f]
        assert "sentry-regression" in codes
        assert len(timeseries.load("sentry-e2e")) == 6
        got = sentry.main(["sentry-e2e", "--strict"])
        assert got == 2
        assert ref_sentry.main(["sentry-e2e", "--strict"]) == got
        capsys.readouterr()

    def test_hook_off_at_window_zero(self, traced, monkeypatch):
        monkeypatch.setattr(settings, "sentry_window", 0)
        _run_once("sentry-off")
        assert timeseries.load("sentry-off") == []
        assert history.load("sentry-off")

    def test_check_run_folds_from_history(self, traced):
        for _ in range(4):
            _run_once("sentry-fold")
        store = timeseries.store_path("sentry-fold")
        os.remove(store)
        assert sentry.check_run("sentry-fold") == []
        assert os.path.isfile(store)
        assert len(timeseries.load("sentry-fold")) == 4
