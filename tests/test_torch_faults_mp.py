"""A rank killed mid-exchange, on the port's two-process gloo mesh.

The port version of ``tests/test_faults_mp.py``, the same chaos run: two
rank processes run a resumable traced group_by over the byte exchange,
and rank 1 dies at its first exchange step (``rank_kill:rank=1,nth=1,
exit=137``).  Then:

- rank 1 exits 137 and still leaves a schema-valid crashdump
  (``crashdump.rank1.json``: the kill flushes the flight recorder);
- rank 0's step watchdog (``settings.exchange_timeout_ms``) ends the
  step the dead rank left, exits 70 within twice the deadline of rank
  1's death, leaves its own crashdump and records the
  ``exchange_timeout`` fault event;
- a ``resume="auto"`` rerun in one process under the same name restores
  rank 0's checkpoints, keeps the stage on the host shuffle for the
  recorded timeout, and reads back the bytes of a cold run, and of the
  JAX package's run of the same pipeline.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMEOUT_MS = 4000  # the exchange watchdog's deadline in the chaos run

#: The pipeline, exec'd as it is by the workers and by the recovery and
#: cold runs here: the same source gives the same resume fingerprints.
PIPELINE_SRC = textwrap.dedent("""
    def build_pipe(Dampr):
        data = [(i % 13, (i * 2654435761) % 99991) for i in range(4000)]
        return (Dampr.memory(data, partitions=8)
                .map(lambda x: (x[0], x[1] * 2))
                .checkpoint(force=True)
                .group_by(lambda x: x[0])
                .reduce(lambda k, vs: sorted(v[1] for v in vs)[:5]))
""")

_WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, @ROOT@)
    from dampr_tpu_torch import Dampr, settings
    settings.device = "cpu"
    settings.mesh_devices = "cpu*4"
    settings.scratch_root = os.path.join(
        os.environ["CHAOS_SCRATCH"], "rank%d" % pid)
    settings.partitions = 8
    settings.trace = True
    settings.mesh_fold = "off"
    settings.mesh_exchange = "on"
    settings.exchange_timeout_ms = @TIMEOUT_MS@
    from dampr_tpu_torch.parallel import mesh as M
    M.GROUP_TIMEOUT_FLOOR_S = 60  # the gloo group's timeout
    M.init_distributed("localhost:%s" % port, 2, pid)
    assert settings.device_count_for_auto() == 8
    # rank 1 dies at its first exchange step, where a dead rank strands
    # its peers
    settings.faults = "rank_kill:rank=1,nth=1,exit=137"
    exec(@PIPELINE_SRC@)
    from dampr_tpu_torch.runner import MTRunner
    pipe = build_pipe(Dampr)
    print("RUN_START_%d" % pid, flush=True)
    MTRunner("rankdeath", pipe.pmer.graph, resume=True).run([pipe.source])
    print("UNEXPECTED_COMPLETE_%d" % pid, flush=True)
""").replace("@ROOT@", repr(ROOT)).replace(
    "@TIMEOUT_MS@", str(TIMEOUT_MS)).replace(
    "@PIPELINE_SRC@", repr(PIPELINE_SRC))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _validate_crashdump(path):
    import importlib.util

    with open(path) as f:
        doc = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "validate_trace", os.path.join(ROOT, "tools", "validate_trace.py"))
    vt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vt)
    with open(os.path.join(ROOT, "docs", "trace_schema.json")) as f:
        schema = json.load(f)
    assert vt.validate(doc, schema) == [], path
    return doc


def _run_reads(D, st, scratch, name, **kw):
    """One process's run of the pipeline: the port's on an 8-shard CPU
    rig (as the JAX package's tests see 8 CPU devices), so the shuffle
    planner has a mesh to keep the stage off."""
    g = {}
    exec(PIPELINE_SRC, g)
    port = hasattr(st, "mesh_devices")
    saved = (st.scratch_root, st.partitions, st.mesh_fold)
    st.scratch_root, st.partitions, st.mesh_fold = scratch, 8, "off"
    if port:
        saved_port = (st.device, st.mesh_devices)
        st.device, st.mesh_devices = "cpu", "cpu*8"
    try:
        em = g["build_pipe"](D).run(name=name, **kw)
        return em, sorted(map(repr, em.read()))
    finally:
        st.scratch_root, st.partitions, st.mesh_fold = saved
        if port:
            st.device, st.mesh_devices = saved_port


class TestRankDeath:
    def test_kill_rank1_bounded_abort_and_auto_resume(self, tmp_path):
        import dampr_tpu
        import dampr_tpu_torch
        from dampr_tpu import settings as ref_settings
        from dampr_tpu_torch import faults, settings

        port = _free_port()
        scratch_base = str(tmp_path / "chaos")
        env = dict(os.environ, CHAOS_SCRATCH=scratch_base)
        script = str(tmp_path / "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        procs = [subprocess.Popen(
            [sys.executable, script, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        try:
            out1, err1 = procs[1].communicate(timeout=120)
            t_rank1_dead = time.time()
            assert procs[1].returncode == 137, (
                procs[1].returncode, out1, err1[-2000:])
            assert "UNEXPECTED_COMPLETE_1" not in out1
            bound = 2 * TIMEOUT_MS / 1000.0
            out0, err0 = procs[0].communicate(timeout=bound + 30)
            t_rank0_dead = time.time()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert procs[0].returncode == 70, (
            procs[0].returncode, out0, err0[-3000:])
        assert "UNEXPECTED_COMPLETE_0" not in out0
        assert t_rank0_dead - t_rank1_dead <= bound, (
            "abort took %.1fs, bound %.1fs"
            % (t_rank0_dead - t_rank1_dead, bound))

        dump0 = os.path.join(scratch_base, "rank0", "rankdeath", "trace",
                             "crashdump.json")
        dump1 = os.path.join(scratch_base, "rank1", "rankdeath", "trace",
                             "rank1", "crashdump.rank1.json")
        doc0 = _validate_crashdump(dump0)
        doc1 = _validate_crashdump(dump1)
        assert doc0["otherData"]["crash"]["reason"] == "exchange-timeout"
        assert doc1["otherData"]["crash"]["reason"] == (
            "fault-injected-kill")
        assert doc1["otherData"]["process"]["process_id"] == 1

        rank0 = os.path.join(scratch_base, "rank0")
        saved = settings.scratch_root
        settings.scratch_root = rank0
        try:
            evs = faults.load_events("rankdeath")
        finally:
            settings.scratch_root = saved
        assert any(ev["kind"] == "exchange_timeout" for ev in evs), evs

        em, got = _run_reads(dampr_tpu_torch.Dampr, settings, rank0,
                             "rankdeath", resume="auto")
        kinds = [s["kind"] for s in em.stats]
        assert any(k.startswith("resumed-") for k in kinds), kinds
        shuffle = (em.stats().get("plan") or {}).get("shuffle") or {}
        degraded = [d for d in shuffle.get("targets") or ()
                    if "fault-history" in (d.get("reason") or "")]
        assert degraded and all(d["target"] == "host" for d in degraded)
        em.delete()
        cold_em, cold = _run_reads(dampr_tpu_torch.Dampr, settings,
                                   str(tmp_path / "cold"), "cold")
        ref_em, ref = _run_reads(dampr_tpu.Dampr, ref_settings,
                                 str(tmp_path / "ref"), "cold")
        assert got == cold == ref
