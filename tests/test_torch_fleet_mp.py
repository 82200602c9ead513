"""The fleet plane of the port with rank artifacts from real processes.

The port version of ``tests/test_fleet_mp.py``, the same checks:

- env-rank workers (``DAMPR_TPU_TORCH_PROCESS_ID``/``_NUM_PROCESSES``,
  no process group, which rank identity never needs): the history
  corpus's rank discipline, per-rank trace artifacts with rank 0's merge
  at finalize (wall alignment: no handshake), and a killed rank's named
  crashdump, which the stats CLI reports with exit 3;
- a two-process gloo deployment: the clock handshake runs at init, both
  ranks trace a chunked byte exchange with rank 1 held back, rank 0
  merges the fleet timeline, the skew names rank 1, and the merged trace
  validates against ``docs/trace_schema.json``; the JAX package's
  ``fleet.merge_run`` over the same files gives the same section.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _communicate(procs, timeout=150):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _run_env_ranks(tmp_path, sources):
    """One process per source, its rank in the environment (no process
    group).  Returns the scratch root and [(rc, out, err)] by rank."""
    scratch = str(tmp_path / "scratch")
    procs = []
    for rank, src in enumerate(sources):
        script = str(tmp_path / "worker{}.py".format(rank))
        with open(script, "w") as f:
            f.write(src)
        env = dict(os.environ)
        env.pop("DAMPR_TPU_TORCH_COORDINATOR", None)
        env.update({
            "DAMPR_TPU_TORCH_DEVICE": "cpu",
            "DAMPR_TPU_TORCH_NUM_PROCESSES": str(len(sources)),
            "DAMPR_TPU_TORCH_PROCESS_ID": str(rank),
            "DAMPR_TPU_TORCH_SCRATCH": scratch,
            "DAMPR_TPU_TORCH_TRACE": "1",
            "DAMPR_TPU_TORCH_FLEET_WAIT_MS": "5000",
        })
        procs.append(subprocess.Popen(
            [sys.executable, script], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    return scratch, _communicate(procs)


_HIST_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from dampr_tpu_torch import Dampr
    em = (Dampr.memory(list(range(3000)), partitions=4)
          .count(lambda x: x % 11)).run("mp-hist")
    assert sorted(v for _k, v in em.read()) == sorted(
        [273] * 8 + [272] * 3), "results diverged"
    print("HIST_OK")
""").format(root=ROOT)

_CRASH_WORKER_OK = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from dampr_tpu_torch import Dampr
    em = (Dampr.memory(list(range(1000)), partitions=2)
          .count(lambda x: x % 3)).run("mp-crash")
    list(em.read())
    print("CRASH0_OK")
""").format(root=ROOT)

_CRASH_WORKER_DIES = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from dampr_tpu_torch import Dampr

    def boom(x):
        if x == 500:
            raise RuntimeError("rank1 injected failure")
        return (x, 1)

    try:
        list((Dampr.memory(list(range(1000)), partitions=2)
              .map(boom).run("mp-crash")).read())
    except Exception:
        print("CRASH1_DIED")
        raise SystemExit(7)
""").format(root=ROOT)


class TestEnvRankProcesses:
    def test_history_and_per_rank_artifacts(self, tmp_path):
        """Two ranks of one logical run: only rank 0's history record
        feeds the plan (rank 1's is tagged and left out, in both
        packages' readers); each rank writes its artifacts, and rank 0
        merged them at finalize, on wall alignment."""
        from dampr_tpu.obs import fleet as ref_fleet
        from dampr_tpu.obs import history as ref_history
        from dampr_tpu_torch.obs import history

        scratch, outs = _run_env_ranks(tmp_path,
                                       [_HIST_WORKER, _HIST_WORKER])
        for rank, (rc, out, err) in enumerate(outs):
            assert rc == 0 and "HIST_OK" in out, (rank, out, err[-2000:])
        corpus = os.path.join(scratch, "mp-hist", "history.jsonl")
        recs = [json.loads(ln) for ln in open(corpus) if ln.strip()]
        assert sorted(r.get("rank", 0) for r in recs) == [0, 1]
        untagged = [r for r in recs if not r.get("rank")]
        assert untagged[0]["process"]["num_processes"] == 2
        shapes = untagged[0]["stage_shapes"]
        for H in (history, ref_history):
            matched = H.matching(recs, shapes)
            assert len(matched) == 1 and not matched[0].get("rank")
            assert H.synthesize(matched)["history_entries"] == 1

        base = os.path.join(scratch, "mp-hist", "trace")
        with open(os.path.join(base, "rank1", "stats.json")) as f:
            assert json.load(f)["process"] == {"process_id": 1,
                                               "num_processes": 2}
        with open(os.path.join(base, "stats.json")) as f:
            fl = json.load(f).get("fleet")
        assert fl is not None, "rank 0 should have merged the fleet"
        assert fl["num_processes"] == 2 and fl["alignment"] == "wall"
        assert {e["rank"] for e in fl["per_rank"]} == {0, 1}
        assert os.path.isfile(fl["merged_trace_file"])
        ref = ref_fleet.merge_run(base, write=False)
        assert {k: v for k, v in fl.items()
                if k != "merged_trace_file"} == ref
        # the stats CLI prints the merged fleet section
        env = dict(os.environ, DAMPR_TPU_TORCH_DEVICE="cpu",
                   DAMPR_TPU_TORCH_SCRATCH=scratch)
        proc = subprocess.run(
            [sys.executable, "-m", "dampr_tpu_torch.cli", "stats",
             "mp-hist", "--fleet"], cwd=ROOT, capture_output=True,
            text=True, env=env, timeout=120)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "fleet: 2 process(es), ranks present [0, 1]" in proc.stdout
        assert "alignment: wall" in proc.stdout

    def test_killed_rank_leaves_named_crashdump(self, tmp_path):
        from dampr_tpu.obs import flightrec as ref_flightrec

        scratch, outs = _run_env_ranks(
            tmp_path, [_CRASH_WORKER_OK, _CRASH_WORKER_DIES])
        (rc0, out0, err0), (rc1, out1, err1) = outs
        assert rc0 == 0, (out0, err0[-2000:])
        assert rc1 == 7 and "CRASH1_DIED" in out1, (out1, err1[-2000:])
        base = os.path.join(scratch, "mp-crash", "trace")
        dump = os.path.join(base, "rank1", "crashdump.rank1.json")
        with open(dump) as f:
            doc = json.load(f)
        assert doc["otherData"]["process"]["process_id"] == 1
        assert doc["otherData"]["crash"]["reason"] == "run-failed"
        assert os.path.isfile(os.path.join(base, "stats.json"))
        assert not os.path.isfile(os.path.join(base, "crashdump.json"))
        run_dir = os.path.join(scratch, "mp-crash")
        assert ref_flightrec.locate_all_crashdumps(run_dir) == [dump]
        env = dict(os.environ, DAMPR_TPU_TORCH_DEVICE="cpu",
                   DAMPR_TPU_TORCH_SCRATCH=scratch)
        for var in ("DAMPR_TPU_TORCH_PROCESS_ID",
                    "DAMPR_TPU_TORCH_NUM_PROCESSES"):
            env.pop(var, None)
        proc = subprocess.run(
            [sys.executable, "-m", "dampr_tpu_torch.cli", "stats",
             run_dir], cwd=ROOT, capture_output=True, text=True, env=env,
            timeout=120)
        assert proc.returncode == 3, (proc.stdout, proc.stderr)
        assert "rank 1" in proc.stderr
        assert "crashdump.rank1.json" in proc.stderr


_GLOO_WORKER = textwrap.dedent("""
    import json, os, sys, time
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, @ROOT@)
    from dampr_tpu_torch import settings
    settings.device = "cpu"
    settings.mesh_devices = "cpu*4"
    settings.scratch_root = os.environ["FLEET_SCRATCH"]
    from dampr_tpu_torch.parallel import mesh as M
    M.GROUP_TIMEOUT_FLOOR_S = 60  # the gloo group's timeout
    M.init_distributed("localhost:%s" % port, 2, pid)
    assert M.clock_sync is not None and M.clock_sync["barrier_perf"] > 0
    assert M.clock_sync["method"] == "gloo_barrier"
    assert M.rank_info() == (pid, 2)
    import numpy as np
    from dampr_tpu_torch.obs import export, fleet, trace as T
    from dampr_tpu_torch.parallel import exchange as px
    mesh = M.data_mesh()
    D = 8
    rng = np.random.RandomState(3)
    blobs = {(s, d): rng.randint(0, 256, size=6000).astype(
                 np.uint8).tobytes()
             for s in range(D) for d in range(D) if (s + d) % 3 == 0}
    budget = 1 << 18
    px.mesh_blob_exchange(mesh, blobs, budget=budget)  # warm

    run = "mp-fleet"
    tracer = T.Tracer(run)
    T.start(tracer)
    w0 = time.time()
    if pid == 1:
        time.sleep(0.4)  # rank 1 arrives late
    out = px.mesh_blob_exchange(mesh, blobs, budget=budget)
    T.stop(tracer)
    wall = time.time() - w0
    assert out == blobs, "exchange diverged on rank %d" % pid
    info = px.last_info
    proc = export.process_section()
    assert proc["process_id"] == pid and proc["num_processes"] == 2
    assert proc["global_devices"] == 8 and "clock" in proc
    tdir = export.run_trace_dir(run)
    os.makedirs(tdir, exist_ok=True)
    tf = export.write_trace(tracer, os.path.join(tdir, export.TRACE_FILE))
    summary = {
        "schema": export.STATS_SCHEMA, "run": run, "process": proc,
        "started_at": round(w0, 3), "wall_seconds": round(wall, 4),
        "stages": [],
        "totals": {"records_out": 0, "bytes_out": info["bytes"],
                   "spill_bytes": 0},
        "mesh": {"exchange": {
            "bytes": info["bytes"], "steps": info["steps"],
            "peak_inflight_bytes": info["peak_inflight_bytes"],
            "hbm_budget": budget,
            "sent_per_device": {str(k): v for k, v in
                                px.sent_bytes_per_device.items()},
            "received_per_device": {str(k): v for k, v in
                                    px.received_bytes_per_device.items()},
            "routes": [[s, d, n] for (s, d), n in
                       sorted(px.pair_bytes_per_route.items())],
        }},
        "spans": tracer.span_summary(), "trace_file": tf,
    }
    export.write_stats(summary, os.path.join(tdir, export.STATS_FILE))
    if pid == 0:
        section = fleet.merge_run(run, wait_ms=20000)
        assert section["alignment"] == "clock", section["alignment"]
        assert section["missing_ranks"] == []
        skew = section["skew"]
        assert skew["straggler_rank"] == 1, skew
        assert skew["skew_seconds"] >= 0.3, skew
        ex = section["exchange"]
        assert ex["bytes"] > 0 and len(ex["rank_sent_matrix"]) == 2
        print("FLEET_JSON=" + json.dumps(section), flush=True)
    print("FLEETP_%d_OK" % pid, flush=True)
""").replace("@ROOT@", repr(ROOT))


class TestTwoProcessFleet:
    def test_traced_gloo_exchange_merges_with_clock_skew(self, tmp_path):
        import importlib.util

        from dampr_tpu import settings as ref_settings
        from dampr_tpu.obs import fleet as ref_fleet

        port = _free_port()
        scratch = str(tmp_path / "scratch")
        env = dict(os.environ, FLEET_SCRATCH=scratch)
        script = str(tmp_path / "gloo_worker.py")
        with open(script, "w") as f:
            f.write(_GLOO_WORKER)
        outs = _communicate([subprocess.Popen(
            [sys.executable, script, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)])
        for i, (rc, out, err) in enumerate(outs):
            assert rc == 0, (i, out[-2000:], err[-3000:])
            assert "FLEETP_%d_OK" % i in out, (i, out, err[-2000:])
        line = [ln for ln in outs[0][1].splitlines()
                if ln.startswith("FLEET_JSON=")][0]
        section = json.loads(line.split("=", 1)[1])
        assert section["skew"]["straggler_rank"] == 1
        saved = ref_settings.scratch_root
        ref_settings.scratch_root = scratch
        try:
            ref = ref_fleet.merge_run("mp-fleet", write=False)
        finally:
            ref_settings.scratch_root = saved
        assert {k: v for k, v in section.items()
                if k != "merged_trace_file"} == json.loads(json.dumps(ref))

        spec = importlib.util.spec_from_file_location(
            "validate_trace", os.path.join(ROOT, "tools",
                                           "validate_trace.py"))
        vt = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(vt)
        with open(section["merged_trace_file"]) as f:
            doc = json.load(f)
        with open(os.path.join(ROOT, "docs", "trace_schema.json")) as f:
            schema = json.load(f)
        assert vt.validate(doc, schema, require_cats=("exchange",)) == []
        assert {ev["pid"] for ev in doc["traceEvents"]} == {1, 2}
        names = {ev["args"]["name"] for ev in doc["traceEvents"]
                 if ev.get("ph") == "M" and ev["name"] == "process_name"}
        assert {"rank0/2", "rank1/2"} <= names, names
