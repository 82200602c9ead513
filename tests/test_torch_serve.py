"""The serve daemon of dampr_tpu_torch: wire form, scheduler fairness,
admission gate, isolation, coalescing, cancellation, drain, and the live
metrics endpoint, against dampr_tpu's.

The port version of ``tests/test_serve.py`` (its wire, scheduler, e2e
and settings classes; ``TestCheckBenchDirection`` waits for the port's
``check_bench``), with ``test_metrics.py::test_promtext_render`` and
``test_top.py``'s ``MetricsServer`` cases.  The e2e tests start a real
:class:`ServeDaemon` on an ephemeral loopback port with the port's device
set to the CPU, and each job runs in its own worker subprocess
(``python -m dampr_tpu_torch.serve.worker``), which inherits that device:
a served result equals the JAX package's in-process ``read()`` of the
same plan, the worker imports neither ``jax`` nor ``dampr_tpu``, and a
worker told ``cuda`` on a host without a card fails its job with a
classified error instead of running on the CPU.  The JAX package's
``top`` reads the port daemon's job table and the port's exposition.
"""

import importlib.util
import json
import os
import sys
import threading
import time

import pytest
import torch

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import metrics, promtext
from dampr_tpu_torch.obs.metrics import Metrics
from dampr_tpu_torch.obs.serve import MetricsServer
from dampr_tpu_torch.serve import scheduler as sched_mod
from dampr_tpu_torch.serve import wire
from dampr_tpu_torch.serve.client import ServeClient, SubmitError
from dampr_tpu_torch.serve.daemon import ServeDaemon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HELPER_SCALE = 10


def _helper(x):
    return x * HELPER_SCALE


@pytest.fixture(autouse=True)
def cpu(tmp_path):
    """The port on the CPU, under its own scratch root (the daemon hands
    both to its workers)."""
    old = (settings.device, settings.scratch_root, settings.reuse_dir)
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    settings.reuse_dir = ""
    yield
    settings.device, settings.scratch_root, settings.reuse_dir = old


@pytest.fixture
def daemon(tmp_path):
    """A live daemon on an ephemeral loopback port (2 worker slots)."""
    d = ServeDaemon(port=0, state_dir=str(tmp_path / "serve"), workers=2)
    assert d.start() is not None
    yield d
    d.stop()


@pytest.fixture
def client(daemon):
    return ServeClient("http://127.0.0.1:{}".format(daemon.port))


def _plan(tag="t", items=20, pkg=dampr_tpu_torch):
    return (pkg.Dampr.memory(list(range(items)))
            .map(lambda x: x * 3)
            .map(lambda x, t=tag: (t, x)))


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------

class TestWire:
    def test_roundtrip_executes_identically(self):
        bias = 7

        def suffix(x):
            return _helper(x) + bias   # closure + module-global helper

        def build(pkg):
            return pkg.Dampr.memory(list(range(12))).map(
                lambda x: x + 1).map(suffix)

        p = build(dampr_tpu_torch)
        graph, source = wire.decode(wire.encode(p.pmer.graph, p.source))
        from dampr_tpu_torch.dampr import PBase

        rebuilt = PBase(source, Dampr(graph))
        got = list(rebuilt.run(name="wire-rt-b").dataset.read())
        assert got == list(p.run(name="wire-rt-a").dataset.read())
        assert got == list(build(dampr_tpu).run().dataset.read())

    def test_python_version_mismatch_refused(self):
        import pickle

        env = {"wire": wire.WIRE_VERSION, "py": [2, 7],
               "graph": None, "source": None}
        with pytest.raises(wire.WireError, match="version mismatch"):
            wire.decode(pickle.dumps(env))

    def test_malformed_payload_refused(self):
        import pickle

        with pytest.raises(wire.WireError):
            wire.decode(b"not a pickle")
        with pytest.raises(wire.WireError, match="wire version"):
            wire.decode(pickle.dumps({"wire": 99}))

    def test_unserializable_capture_is_coded_wire_error(self):
        lock = threading.Lock()
        p = Dampr.memory([1]).map(lambda x: (lock, x)[1])
        with pytest.raises(wire.WireError, match="cannot be serialized"):
            wire.encode(p.pmer.graph, p.source)

    def test_fingerprint_stable_and_distinct(self):
        fp = lambda p: wire.plan_fingerprint(p.pmer.graph, p.source)  # noqa
        assert fp(_plan("a")) == fp(_plan("a"))   # same plan, same fp
        assert fp(_plan("a")) != fp(_plan("b"))   # default-arg capture
        assert not wire.is_volatile(fp(_plan("a")))

    def test_estimate_input_bytes(self, tmp_path):
        from dampr_tpu.serve import wire as ref_wire

        f = tmp_path / "in.txt"
        f.write_text("x" * 4096)
        for pkg, w in ((dampr_tpu_torch, wire), (dampr_tpu, ref_wire)):
            est = w.estimate_input_bytes(
                pkg.Dampr.text(str(f)).map(lambda s: s).pmer.graph)
            assert est >= 4096
            p_mem = pkg.Dampr.memory(list(range(10))).map(lambda x: x)
            assert w.estimate_input_bytes(p_mem.pmer.graph) == 10 * 128

    def test_by_reference_list_is_the_ports(self):
        """Functions of the port, numpy, torch and the stdlib travel by
        reference; the JAX package and jax are not on the list; a
        scanner is rebuilt from the worker's own import and a lambda and
        ``math`` travel by value and by name."""
        import math
        import pickle

        from dampr_tpu_torch import base
        from dampr_tpu_torch.ops.text import DocFreq

        assert {"dampr_tpu_torch", "numpy", "torch"} <= \
            wire._BY_REF_PACKAGES
        assert not {"dampr_tpu", "jax", "jaxlib"} & wire._BY_REF_PACKAGES
        assert wire._ships_by_reference(base._identity)
        assert not wire._ships_by_reference(lambda x: x)
        p = (Dampr.text(os.path.join(ROOT, "README.md"))
             .custom_mapper(DocFreq(pair_values=False))
             .map(lambda kv: (kv[0], math.log(1 + kv[1]))))
        data = wire.encode(p.pmer.graph, p.source)
        assert b"dampr_tpu_torch.ops.text" in data and b"DocFreq" in data
        assert b"dampr_tpu.ops" not in data
        graph, _source = wire.decode(data)
        scanners = [st.mapper for st in graph.stages
                    if isinstance(getattr(st, "mapper", None), DocFreq)]
        assert len(scanners) == 1   # the worker's own class
        assert pickle.dumps(scanners[0])


# ---------------------------------------------------------------------------
# scheduler (pure state machine, no daemon)
# ---------------------------------------------------------------------------

def _job(jid, tenant, cost, fp=None):
    return sched_mod.Job(jid, tenant, fp or ("f" + jid), cost)


class TestScheduler:
    def test_budget_admission_and_release(self):
        s = sched_mod.Scheduler(tenant_budget=100, quantum=10,
                                queue_depth=8)
        j1 = _job("j1", "a", 60)
        j2 = _job("j2", "a", 60)
        s.admit(j1)
        with pytest.raises(sched_mod.AdmissionError) as ei:
            s.admit(j2)
        assert ei.value.reason == "budget"
        # a cancelled job releases its reservation at once
        assert s.remove_queued(j1)
        j1.state = "cancelled"
        s.release(j1)
        assert s.tenants["a"].reserved == 0
        s.admit(j2)   # fits now

    def test_queue_depth_rejects(self):
        s = sched_mod.Scheduler(tenant_budget=10**9, quantum=10,
                                queue_depth=2)
        s.admit(_job("j1", "a", 1))
        s.admit(_job("j2", "a", 1))
        with pytest.raises(sched_mod.AdmissionError) as ei:
            s.admit(_job("j3", "a", 1))
        assert ei.value.reason == "queue-full"

    def test_drr_byte_fairness_bounds_queue_wait(self):
        """A tenant flooding small jobs cannot starve a tenant with one
        job, and one big job cannot starve small ones; the dispatch order
        is the JAX scheduler's."""
        from dampr_tpu.serve import scheduler as ref_sched

        orders = []
        for mod in (sched_mod, ref_sched):
            s = mod.Scheduler(tenant_budget=10**9, quantum=100,
                              queue_depth=64)
            for i in range(10):
                s.admit(mod.Job("a{}".format(i), "flood", "fa%d" % i, 50))
            s.admit(mod.Job("b0", "victim", "fb0", 100))
            order = [s.next_job().id for _ in range(6)]
            assert "b0" in order[:3], order
            s2 = mod.Scheduler(tenant_budget=10**9, quantum=100,
                               queue_depth=64)
            s2.admit(mod.Job("big", "heavy", "fbig", 300))
            for i in range(3):
                s2.admit(mod.Job("s{}".format(i), "light", "fs%d" % i, 100))
            order2 = [s2.next_job().id for _ in range(4)]
            assert order2.index("big") < 3, order2
            orders.append((order, order2))
        assert orders[0] == orders[1]

    def test_coalesce_target_lifecycle(self):
        s = sched_mod.Scheduler(tenant_budget=10**9, quantum=10,
                                queue_depth=8)
        j1 = _job("j1", "a", 1, fp="same")
        s.admit(j1)
        assert s.coalesce_target("same") is j1
        follower = _job("j2", "b", 1, fp="same")
        s.attach_follower(j1, follower)
        assert follower.state == "coalesced"
        assert follower.primary == "j1"
        assert j1.followers == ["j2"]
        j1.state = "done"
        s.release(j1)
        assert s.coalesce_target("same") is None

    def test_release_is_idempotent(self):
        s = sched_mod.Scheduler(tenant_budget=100, quantum=10,
                                queue_depth=8)
        j = _job("j1", "a", 40)
        s.admit(j)
        j.state = "done"
        s.release(j)
        s.release(j)
        assert s.tenants["a"].reserved == 0


# ---------------------------------------------------------------------------
# e2e: daemon + subprocess workers over HTTP
# ---------------------------------------------------------------------------

def _validate_trace():
    spec = importlib.util.spec_from_file_location(
        "validate_trace", os.path.join(ROOT, "tools", "validate_trace.py"))
    vt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vt)
    with open(os.path.join(ROOT, "docs", "trace_schema.json")) as f:
        return vt, json.load(f)


class TestServeE2E:
    def test_submit_roundtrip_equals_the_jax_read(self, daemon, client):
        """A served result equals the JAX package's in-process read of the
        same plan, record for record; the worker ran on the CPU the
        daemon was told to use and loaded neither jax nor dampr_tpu; a
        second tenant's submission mounts it from the cache, running no
        stage."""
        def build(pkg):
            return _plan("rt", pkg=pkg).map(lambda kv: (kv, sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dampr_tpu"))))

        job = client.submit(build(dampr_tpu_torch), tenant="alice")
        row = job.wait(timeout_s=120)
        assert row["state"] == "done", row
        got = job.result()
        assert row["records"] == len(got) == 20
        assert all(v[1] == [] for _k, v in got)   # hazard: no JAX loaded
        want = list(_plan("rt", pkg=dampr_tpu).run().dataset.read())
        assert [(k, v[0]) for k, v in got] == want
        with open(os.path.join(daemon.state_dir, "jobs", job.id,
                               "result.json")) as f:
            meta = json.load(f)
        assert meta["device"] == "cpu"
        assert meta["reuse"]["enabled"] is True   # "auto" -> on in a worker
        doc = client.jobs()
        assert doc["schema"] == "dampr-tpu-serve-jobs/1"
        assert any(r["job"] == job.id and r["tenant"] == "alice"
                   for r in doc["jobs"])
        # a second tenant's identical plan, after the first finished,
        # mounts the published output
        second = client.submit(build(dampr_tpu_torch), tenant="bob")
        row = second.wait(120)
        assert row["state"] == "done"
        assert row["reuse_hits"] >= 1
        assert second.result() == got
        with open(os.path.join(daemon.state_dir, "jobs", second.id,
                               "result.json")) as f:
            meta = json.load(f)
        with open(meta["stats_file"]) as f:
            stats = json.load(f)
        assert [s["kind"] for s in stats["stages"]] == ["reused-map"]
        assert stats["device"]["batches"] == 0

    def test_cuda_worker_without_a_card_fails_classified(self, daemon,
                                                          client):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible: the no-card case cannot "
                        "occur")
        settings.device = "cuda"   # the daemon forwards its live device
        job = client.submit(_plan("nocard"), tenant="eve", validate=False)
        row = job.wait(timeout_s=120)
        settings.device = "cpu"
        assert row["state"] == "failed"
        assert "is_available" in row["error"]
        with open(os.path.join(daemon.state_dir, "jobs", job.id,
                               "error.json")) as f:
            err = json.load(f)
        assert err["device"] == "cuda"
        assert err["type"] == "RuntimeError"
        assert err["kind"] in ("transient", "deterministic", "fatal")
        assert not os.path.exists(os.path.join(
            daemon.state_dir, "jobs", job.id, "result.pkl"))

    def test_identical_inflight_submissions_coalesce(self, tmp_path):
        """Two clients submitting one fingerprint mid-flight coalesce onto
        one run; both get the same result bytes."""
        d = ServeDaemon(port=0, state_dir=str(tmp_path / "s"), workers=1)
        assert d.start() is not None
        try:
            c = ServeClient("http://127.0.0.1:{}".format(d.port))

            def slowish(x):
                time.sleep(0.15)
                return x + 1

            p = Dampr.memory(list(range(6))).map(slowish)
            j1 = c.submit(p, tenant="alice")
            j2 = c.submit(p, tenant="bob")
            assert j2.state == "coalesced" and j2.primary == j1.id
            r1 = j1.wait(timeout_s=120)
            r2 = j2.wait(timeout_s=120)
            assert r1["state"] == "done" and r2["state"] == "done"
            assert j1.result_bytes() == j2.result_bytes()
            # one run: only the primary has a job directory
            assert os.listdir(str(tmp_path / "s" / "jobs")) == [j1.id]
            assert d.counters["serve-coalesce"] == 1
        finally:
            d.stop()

    def test_reuse_off_submissions_never_coalesce(self, daemon, client):
        p = _plan("nc")
        j1 = client.submit(p, tenant="alice", reuse="off")
        j2 = client.submit(p, tenant="bob", reuse="off")
        assert j2.primary is None
        assert j1.wait(120)["state"] == "done"
        assert j2.wait(120)["state"] == "done"
        with open(os.path.join(daemon.state_dir, "jobs", j2.id,
                               "result.json")) as f:
            assert json.load(f)["reuse"] is None   # the cache stayed out

    def test_cancel_running_releases_budget_and_dumps(self, daemon,
                                                      client):
        def very_slow(x):
            time.sleep(2)
            return x

        p = Dampr.memory(list(range(3))).map(very_slow)
        job = client.submit(p, tenant="alice")
        while job.poll()["state"] == "queued":
            time.sleep(0.05)
        # wait until the worker's run starts (its trace dir appears), so
        # SIGTERM lands on the runner's handler, not on an interpreter
        # still importing
        trace_dir = os.path.join(daemon.state_dir, "jobs", job.id, "trace")
        deadline = time.time() + 60
        while time.time() < deadline and not (
                os.path.isdir(trace_dir) and os.listdir(trace_dir)):
            time.sleep(0.05)
        time.sleep(0.3)
        job.cancel()
        row = job.wait(timeout_s=60)
        assert row["state"] == "cancelled"
        assert row["exit_code"] == 143     # SIGTERM -> the crashdump path
        assert client.jobs()["tenants"]["alice"]["reserved_bytes"] == 0
        dump = row["crashdump"]
        assert dump and os.path.isfile(dump)
        vt, schema = _validate_trace()
        with open(dump) as f:
            doc = json.load(f)
        assert not vt.validate(doc, schema)
        assert doc["otherData"]["crash"]["exception"] == "SystemExit"

    def test_cancel_queued_releases_immediately(self, tmp_path):
        d = ServeDaemon(port=0, state_dir=str(tmp_path / "s"), workers=1)
        assert d.start() is not None
        try:
            c = ServeClient("http://127.0.0.1:{}".format(d.port))

            def slowish(x):
                time.sleep(2)
                return x

            blocker = c.submit(Dampr.memory([1]).map(slowish),
                               tenant="alice")
            queued = c.submit(_plan("q"), tenant="alice")
            assert queued.cancel()["state"] == "cancelled"
            assert c.jobs()["tenants"]["alice"]["reserved_bytes"] == \
                blocker.poll()["cost_bytes"]
            blocker.cancel()
            blocker.wait(timeout_s=60)
            assert c.jobs()["tenants"]["alice"]["reserved_bytes"] == 0
        finally:
            d.stop()

    def test_poison_tenant_is_isolated(self, daemon, client):
        """One tenant's poison record fails its job (classified, with a
        crashdump) while a concurrent healthy tenant's job completes, and
        the daemon keeps serving."""
        def poison(x):
            if x == 7:
                raise ValueError("poison record {!r}".format(x))
            return x

        bad = client.submit(Dampr.memory(list(range(20))).map(poison),
                            tenant="eve")
        good = client.submit(_plan("ok"), tenant="alice")
        bad_row = bad.wait(timeout_s=120)
        good_row = good.wait(timeout_s=120)
        assert bad_row["state"] == "failed"
        assert "poison record" in bad_row["error"]
        assert bad_row["crashdump"] and os.path.isfile(bad_row["crashdump"])
        assert good_row["state"] == "done"
        again = client.submit(_plan("again"), tenant="alice")
        assert again.wait(timeout_s=120)["state"] == "done"

    def test_server_side_admission_gate_rejects_dta401(self, daemon,
                                                       client):
        # a capture the wire ships but the pickle probe flags (a lambda in
        # a container): it bounces at the door with the coded diagnostic
        def make(fns):
            return lambda x: fns[0](x)

        p = Dampr.memory([1, 2]).map(make([lambda v: v * 2]))
        with pytest.raises(SubmitError) as ei:
            client.submit(p, tenant="eve", validate=False)
        assert ei.value.reason == "invalid"
        assert [d["code"] for d in ei.value.diagnostics] == ["DTA401"]
        assert daemon.counters["serve-reject"] == 1
        # the client-side pre-flight reports the same coded diagnostic
        with pytest.raises(SubmitError) as ei2:
            client.submit(p, tenant="eve")
        assert [d["code"] for d in ei2.value.diagnostics] == ["DTA401"]

    def test_drain_finishes_inflight_and_rejects_new(self, tmp_path):
        d = ServeDaemon(port=0, state_dir=str(tmp_path / "s"), workers=1)
        assert d.start() is not None
        try:
            c = ServeClient("http://127.0.0.1:{}".format(d.port))

            def slowish(x):
                time.sleep(0.3)
                return x * 2

            inflight = c.submit(Dampr.memory(list(range(4))).map(slowish),
                                tenant="alice")
            while inflight.poll()["state"] == "queued":
                time.sleep(0.05)
            assert d.drain(timeout_s=60) == 0   # in-flight job finished
            assert inflight.poll()["state"] == "done"
            with pytest.raises(SubmitError) as ei:
                c.submit(_plan("late"), tenant="bob")
            assert ei.value.reason == "draining"
            assert c.health()["status"] == "draining"
            with open(str(tmp_path / "s" / "events.jsonl")) as f:
                codes = [json.loads(line)["code"] for line in f]
            assert "serve-drain" in codes and "serve-reject" in codes
        finally:
            d.stop()

    def test_top_jobs_view(self, daemon, client, capsys):
        """The JAX package's ``top`` reads the port daemon's job table."""
        job = client.submit(_plan("top"), tenant="alice")
        job.wait(timeout_s=120)
        from dampr_tpu.obs import top as top_mod

        url = "http://127.0.0.1:{}".format(daemon.port)
        assert top_mod.main(["--jobs", url, "--once", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        rows = doc["jobs"]["jobs"]
        assert any(r["job"] == job.id and r["state"] == "done"
                   and r["tenant"] == "alice" for r in rows)
        text = top_mod.render_jobs(doc["jobs"])
        assert "TENANT" in text and "alice" in text

    def test_metrics_exposition(self, daemon, client):
        job = client.submit(_plan("m"), tenant="alice")
        job.wait(timeout_s=120)
        text = client.metrics()
        assert ('dampr_tpu_serve_jobs{tenant="alice",state="done"} 1'
                in text)
        assert ('dampr_tpu_serve_events_total{code="serve-admit"} 1'
                in text)
        assert "dampr_tpu_serve_uptime_seconds" in text
        # the finished job appended its tenant's telemetry point
        from dampr_tpu_torch.obs import timeseries

        points = timeseries.load("serve-alice")
        assert len(points) == 1 and points[0]["wall_seconds"] > 0


class TestSettingsServe:
    def test_reuse_auto_resolves_on_only_under_serve(self, monkeypatch):
        monkeypatch.setattr(settings, "reuse", "auto")
        monkeypatch.setattr(settings, "serve_active", False)
        assert settings.reuse_enabled() is False
        monkeypatch.setattr(settings, "serve_active", True)
        assert settings.reuse_enabled() is True
        # an explicit off keeps the cache out, in the daemon too
        monkeypatch.setattr(settings, "reuse", "off")
        assert settings.reuse_enabled() is False
        monkeypatch.setattr(settings, "reuse", "on")
        monkeypatch.setattr(settings, "serve_active", False)
        assert settings.reuse_enabled() is True

    def test_serve_defaults_are_the_jax_packages(self):
        from dampr_tpu import settings as ref

        for knob in ("reuse", "reuse_budget_bytes", "reuse_chunk_bytes",
                     "metrics_port", "serve_port", "serve_host",
                     "serve_workers", "serve_tenant_budget",
                     "serve_quantum", "serve_queue_depth",
                     "serve_job_timeout_ms", "serve_drain_ms",
                     "serve_trace", "serve_jobs_keep"):
            assert getattr(settings, knob) == getattr(ref, knob), knob

    def test_dsl_submit_hook_exists(self):
        from dampr_tpu_torch.dampr import PBase

        assert callable(getattr(PBase, "submit", None))


class TestFromDataset:
    def test_non_chunker_raises_what_the_jax_package_raises(self):
        errors = []
        for pkg in (dampr_tpu, dampr_tpu_torch):
            with pytest.raises(BaseException) as ei:
                pkg.Dampr.from_dataset([1, 2, 3])
            errors.append(type(ei.value))
        assert errors[0] is errors[1] is AssertionError


# ---------------------------------------------------------------------------
# the live metrics endpoint and its exposition
# ---------------------------------------------------------------------------

@pytest.fixture
def live_server():
    """A MetricsServer on an OS-assigned port with a live registry."""
    reg = Metrics("top-test")
    reg.gauge_set("run.stage", 2)
    reg.gauge_set("writer.queue_depth", 5)
    reg.gauge_set("store.bytes", 1_000_000)
    metrics.start(reg)
    srv = MetricsServer(0, run_name="top-test", rank=0, num_processes=1)
    assert srv.start() is not None
    yield srv, reg
    srv.stop()
    metrics.stop(reg)


class TestMetricsEndpoint:
    def test_promtext_render(self, monkeypatch, tmp_path):
        monkeypatch.setattr(settings, "metrics_interval_ms", 10)
        em = Dampr.memory(list(range(4000))).map(lambda x: (x, 1)).run(
            name="prom")
        txt = promtext.render_summary(em.stats())
        assert "# TYPE dampr_tpu_store_records_total counter" in txt
        assert 'run="prom"' in txt
        assert "dampr_tpu_sampler_overhead" in txt
        # a pre-metrics stats file renders to empty, not an error
        assert promtext.render_summary({"run": "old"}) == ""
        em.delete()

    def test_live_scrape_parses_with_the_jax_top(self, live_server):
        import urllib.request

        from dampr_tpu.obs import top

        srv, _reg = live_server
        base = "http://127.0.0.1:{}".format(srv.port)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        parsed = top.parse_exposition(text)
        assert parsed["dampr_tpu_run_stage"] == 2.0
        assert parsed["dampr_tpu_writer_queue_depth"] == 5.0
        assert 'rank="0"' in text
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read().decode())
        assert health == {"status": "ok", "run": "top-test",
                          "process_id": 0, "num_processes": 1,
                          "metrics_live": True}

    def test_port_collision_probes_above_fleet_block(self):
        a = MetricsServer(0, rank=0, num_processes=1)
        assert a.start() is not None
        try:
            b = MetricsServer(a.port, rank=0, num_processes=2)
            assert b.start() is not None
            try:
                assert b.fallback is True
                # never a sibling rank's expected port (a.port + 1)
                assert b.port != a.port + 1
                assert b.port >= a.port + 2
            finally:
                b.stop()
        finally:
            a.stop()

    def test_fallback_recorded_in_run_stats(self, monkeypatch):
        blocker = MetricsServer(0, rank=0, num_processes=1)
        assert blocker.start() is not None
        monkeypatch.setattr(settings, "metrics_port", blocker.port)
        try:
            em = (Dampr.memory(list(range(2000)))
                  .map(lambda x: (x % 5, 1)).run("endpoint-fallback"))
            ep = em.stats().get("endpoint")
            em.delete()
        finally:
            blocker.stop()
        assert ep, "run recorded no endpoint section"
        assert ep["requested"] == blocker.port
        assert ep["fallback"] is True and ep["port"] != blocker.port

    def test_back_to_back_runs_rebind_cleanly(self, monkeypatch):
        """Sequential runs on one configured port: teardown releases the
        socket, so the second run binds it without a fallback."""
        probe = MetricsServer(0, rank=0, num_processes=1)
        assert probe.start() is not None
        free_port = probe.port
        probe.stop()
        monkeypatch.setattr(settings, "metrics_port", free_port)
        endpoints = []
        for i in range(2):
            em = (Dampr.memory(list(range(2000)))
                  .map(lambda x: (x % 5, 1)).run("b2b-%d" % i))
            endpoints.append(em.stats().get("endpoint"))
            em.delete()
        for ep in endpoints:
            assert ep and ep["port"] == free_port, endpoints
            assert ep["fallback"] is False, endpoints

    def test_escape_label_value(self):
        from dampr_tpu.obs import promtext as ref_promtext

        for raw in ('a"b', "a\nb", "a\\b", '\\"'):
            assert (promtext.escape_label_value(raw)
                    == ref_promtext.escape_label_value(raw))
        assert promtext.escape_label_value('\\"') == '\\\\\\"'

    def test_hostile_run_name_keeps_exposition_parseable(self):
        from dampr_tpu.obs import top

        reg = Metrics('evil"run\nname\\x')
        reg.gauge_set("run.stage", 1)
        text = promtext.render(reg, rank=0)
        assert "\n\n" not in text.strip()
        for line in text.splitlines():
            assert line.startswith("#") or " " in line, line
        assert top.parse_exposition(text)["dampr_tpu_run_stage"] == 1.0
