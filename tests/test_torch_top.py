"""The live dashboard of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_top.py``'s ``top`` cases.
``parse_exposition`` and ``render`` equal the JAX functions on the
port's ``promtext`` output (a live registry's and a finished run's);
``scrape`` and the ``--once --json`` CLI read a port run's live
``metrics_port`` while the run is in flight; a rank nobody serves renders
``DEAD`` without a hang; ``render_jobs`` renders the port daemon's job
table as the JAX one does.
"""

import json
import socket
import threading
import time

import pytest

from dampr_tpu.obs import top as ref_top
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import metrics, promtext, top
from dampr_tpu_torch.obs.metrics import Metrics
from dampr_tpu_torch.obs.serve import MetricsServer


@pytest.fixture(autouse=True)
def cpu(tmp_path):
    old = (settings.device, settings.scratch_root)
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    yield
    settings.device, settings.scratch_root = old


@pytest.fixture
def live_server():
    """A MetricsServer on an OS-assigned port with a live registry."""
    reg = Metrics("top-test")
    reg.gauge_set("run.stage", 2)
    reg.gauge_set("writer.queue_depth", 5)
    reg.gauge_set("store.bytes", 1_000_000)
    reg.counter_add("run.jobs_done", 3)
    metrics.start(reg)
    srv = MetricsServer(0, run_name="top-test", rank=0, num_processes=1)
    assert srv.start() is not None
    yield srv, reg
    srv.stop()
    metrics.stop(reg)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestParseAndRender:
    def test_parse_equals_jax_on_live_exposition(self, live_server):
        _srv, reg = live_server
        text = promtext.render(reg, rank=0)
        got = top.parse_exposition(text)
        assert got == ref_top.parse_exposition(text)
        assert got["dampr_tpu_run_stage"] == 2.0
        assert got["dampr_tpu_writer_queue_depth"] == 5.0

    def test_parse_equals_jax_on_a_runs_summary(self, monkeypatch):
        monkeypatch.setattr(settings, "metrics_interval_ms", 10)
        em = Dampr.memory(list(range(4000))).map(lambda x: (x, 1)).run(
            name="prom-top")
        text = promtext.render_summary(em.stats())
        em.delete()
        assert text
        assert top.parse_exposition(text) == ref_top.parse_exposition(text)

    def test_parse_tolerates_garbage(self):
        text = "\n".join([
            "# TYPE dampr_tpu_run_stage gauge",
            'dampr_tpu_run_stage{run="r",rank="0"} 3',
            "malformed-line-without-value",
            "dampr_tpu_bad_value nan-ish-garbage x", ""])
        assert top.parse_exposition(text) == ref_top.parse_exposition(text)

    def test_render_equals_jax(self, live_server):
        srv, reg = live_server
        rows = top.snapshot([srv.port, srv.port + 17], timeout=1.0)
        reg.gauge_set("store.bytes", 5_000_000)
        rows2 = top.snapshot([srv.port, srv.port + 17], prev_rows=rows,
                             dt=2.0, timeout=1.0)
        assert rows2 == ref_top.snapshot([srv.port, srv.port + 17],
                                         prev_rows=rows, dt=2.0,
                                         timeout=1.0)
        assert rows2[0]["mbps"] == pytest.approx(2.0)
        for color in (False, True):
            assert top.render(rows2, color=color) == ref_top.render(
                rows2, color=color)
        lines = top.render(rows2).splitlines()
        assert "UP" in lines[1] and "DEAD" in lines[2]


class TestScrape:
    def test_live_rank_row(self, live_server):
        srv, _ = live_server
        row = top.snapshot([srv.port], timeout=2.0)[0]
        assert row["alive"] is True and row["run"] == "top-test"
        assert row["stage"] == 2.0 and row["queue_depth"] == 5.0

    def test_dead_rank_marker_and_no_hang(self, live_server):
        srv, _ = live_server
        t0 = time.monotonic()
        rows = top.snapshot([srv.port, srv.port + 17], timeout=1.0)
        assert time.monotonic() - t0 < 5.0
        assert rows[1] == {"rank": 1, "port": srv.port + 17, "alive": False}

    def test_scrape_a_port_run_in_flight(self, monkeypatch, capsys):
        """A run with ``metrics_port`` set serves its registry while it
        runs: ``scrape`` and ``--once --json`` read it."""
        port = _free_port()
        monkeypatch.setattr(settings, "metrics_port", port)
        done, release = threading.Event(), threading.Event()

        def held(x):
            release.wait(30)  # the run stays in flight until released
            return (x % 7, 1)

        def run():
            try:
                em = (Dampr.memory(list(range(6000)), partitions=4)
                      .map(held)
                      .fold_by(lambda kv: kv[0], lambda a, b: a + b,
                               lambda kv: kv[1])
                      .run(name="top-live"))
                em.delete()
            finally:
                done.set()

        t = threading.Thread(target=run)
        t.start()
        try:
            snap = None
            deadline = time.monotonic() + 30
            while not done.is_set() and time.monotonic() < deadline:
                snap = top.scrape(port, timeout=0.5)
                if snap["alive"]:
                    break
                time.sleep(0.02)
            assert snap and snap["alive"], "the run never served /metrics"
            assert snap["health"]["run"] == "top-live"
            assert top.main(["--ports", str(port), "--once",
                             "--json"]) == 0
            doc = json.loads(capsys.readouterr().out)
            assert doc["ports"] == [port]
            assert doc["ranks"][0]["run"] == "top-live"
        finally:
            release.set()
            t.join(60)
        assert not t.is_alive()
        assert not top.scrape(port, timeout=0.5)["alive"]

    def test_once_all_dead_exits_one(self, capsys):
        assert top.main(["--ports", "1", "--once", "--json"]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert doc["ranks"][0]["alive"] is False

    def test_no_ports_exits_one(self, monkeypatch, capsys):
        monkeypatch.setattr(settings, "metrics_port", 0)
        assert top.main(["--once"]) == 1

    def test_resolve_ports_asks_rank_zero(self, live_server):
        srv, _ = live_server
        assert top.resolve_ports(base_port=srv.port) == [srv.port]
        assert top.resolve_ports(ports=[5, 6]) == [5, 6]


class TestJobs:
    def test_render_jobs_of_the_ports_daemon(self, tmp_path, capsys):
        from dampr_tpu_torch.serve.client import ServeClient
        from dampr_tpu_torch.serve.daemon import ServeDaemon

        d = ServeDaemon(port=0, state_dir=str(tmp_path / "serve"),
                        workers=1)
        assert d.start() is not None
        try:
            url = "http://127.0.0.1:{}".format(d.port)
            job = ServeClient(url).submit(
                Dampr.memory(list(range(20))).map(lambda x: x * 3),
                tenant="alice")
            job.wait(timeout_s=120)
            doc = top.scrape_jobs(url, timeout=5.0)
            assert any(r["job"] == job.id and r["state"] == "done"
                       and r["tenant"] == "alice" for r in doc["jobs"])
            text = top.render_jobs(doc)
            assert text == ref_top.render_jobs(doc)
            assert "TENANT" in text and "alice" in text
            assert top.main(["--jobs", url, "--once", "--json"]) == 0
            assert json.loads(capsys.readouterr().out)["jobs"]["jobs"]
        finally:
            d.stop()
        assert top.render_jobs(None) == ref_top.render_jobs(None)
