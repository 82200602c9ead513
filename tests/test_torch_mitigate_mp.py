"""Live straggler mitigation on the port's two-process gloo mesh.

The port version of ``tests/test_mitigate_mp.py``, the same chaos run:
rank 1 is slowed at every exchange step for a bounded window (the fault
grammar's windowed slowness, ``exchange_step:rank=1,sleep_ms=...,
duration_ms=...``), and

- the controller engages after ``speculate_after_steps`` late windows
  (the ranks' entry times shared over an all_gather after each window,
  on the clock handshake's anchor);
- engaged windows are skipped, with probes on the set cadence, and every
  delivered window equals its input byte for byte;
- once the slow window ends the probes turn healthy and the mitigation
  disengages; the collectives resume;
- both ranks' controllers walk the same state machine, and the JAX
  package's controller, fed the observations the port's saw, reaches
  the same decisions and summary.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLOW_MS = 250
DURATION_MS = 2500

_WORKER = textwrap.dedent("""
    import json, os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, @ROOT@)
    import numpy as np
    from dampr_tpu_torch import faults, settings
    settings.device = "cpu"
    settings.mesh_devices = "cpu*4"
    settings.scratch_root = os.path.join(
        os.environ["MIT_SCRATCH"], "rank%d" % pid)
    from dampr_tpu_torch.parallel import mesh as M
    M.GROUP_TIMEOUT_FLOOR_S = 60  # the gloo group's timeout
    M.init_distributed("localhost:%s" % port, 2, pid)
    from dampr_tpu_torch.parallel import exchange as px
    from dampr_tpu_torch.parallel import mitigate

    mesh = M.data_mesh()
    rng = np.random.RandomState(0)
    blobs = {(s, d): rng.randint(0, 256, size=2048).astype(
                 np.uint8).tobytes()
             for s in range(8) for d in range(8) if s != d}
    assert px.mesh_blob_exchange(mesh, blobs) == blobs  # warm

    # window skipping needs the bounded-collective regime
    settings.exchange_timeout_ms = 60000
    ctl = mitigate.MitigationController(
        run_name="mitmp", threshold=1.5, after=2, probe_every=2)
    assert ctl.skip_safe
    seen = []
    observe = ctl.observe_window

    def recording(lateness, fault_counts=None):
        seen.append(["obs", {str(r): v for r, v in lateness.items()},
                     {str(r): v for r, v in (fault_counts or {}).items()}])
        return observe(lateness, fault_counts=fault_counts)

    ctl.observe_window = recording
    use = ctl.use_collective

    def recording_use():
        answer = use()
        seen.append(["use", answer])
        return answer

    ctl.use_collective = recording_use
    mitigate.start(ctl)
    faults.configure(
        "exchange_step:rank=1,sleep_ms=@SLOW_MS@,every=1,"
        "duration_ms=@DURATION_MS@,times=1000")
    engaged_seen = False
    skipped = 0
    for w in range(60):
        out = px.mesh_blob_exchange(mesh, blobs)
        assert out == blobs, "window %d not byte-identical" % w
        engaged_seen = engaged_seen or ctl.engaged
        skipped += bool(px.last_info.get("skipped"))
        # the controllers' state is shared, so both ranks leave together
        if ctl.disengagements >= 1 and w >= 6:
            break
    for _ in range(2):
        assert px.mesh_blob_exchange(mesh, blobs) == blobs
        assert not px.last_info.get("skipped")
    s = ctl.summary()
    s["engaged_seen"] = engaged_seen
    s["skipped_windows_seen"] = skipped
    mitigate.stop(ctl)
    print("MITSEEN " + json.dumps(seen), flush=True)
    print("MITSUMMARY " + json.dumps(s, sort_keys=True), flush=True)
""").replace("@ROOT@", repr(ROOT)).replace(
    "@SLOW_MS@", str(SLOW_MS)).replace("@DURATION_MS@", str(DURATION_MS))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tagged(out, tag):
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert lines, out[-2000:]
    return json.loads(lines[-1].split(" ", 1)[1])


class TestLiveMitigation2Proc:
    def test_engage_skip_probe_disengage_byte_identical(self, tmp_path):
        from dampr_tpu.parallel import mitigate as ref_mitigate

        port = _free_port()
        env = dict(os.environ, MIT_SCRATCH=str(tmp_path / "scratch"))
        script = str(tmp_path / "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        procs = [subprocess.Popen(
            [sys.executable, script, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=150))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, (rank, out[-2000:], err[-4000:])
        summaries = [_tagged(out, "MITSUMMARY") for out, _e in outs]
        for rank, s in enumerate(summaries):
            assert s["engaged_seen"] and s["engagements"] >= 1, (rank, s)
            assert s["disengagements"] >= 1, (rank, s)
            assert s["windows_skipped"] >= 1, (rank, s)
            # every window the controller skipped delivered as skipped
            assert s["skipped_windows_seen"] == s["windows_skipped"]
            assert s["straggler_rank"] == 1, (rank, s)
            assert not s["engaged"], (rank, s)
        keys = ("engagements", "disengagements", "windows_skipped",
                "observations", "straggler_rank")
        assert ({k: summaries[0][k] for k in keys}
                == {k: summaries[1][k] for k in keys}), summaries

        # the JAX package's controller, fed what rank 0's saw, decides
        # the same at every call
        seen = _tagged(outs[0][0], "MITSEEN")
        assert seen == _tagged(outs[1][0], "MITSEEN")
        ref = ref_mitigate.MitigationController(
            threshold=1.5, after=2, probe_every=2, skip_safe=True)
        for call in seen:
            if call[0] == "obs":
                ref.observe_window(
                    {int(r): v for r, v in call[1].items()},
                    fault_counts={int(r): v for r, v in call[2].items()})
            else:
                assert ref.use_collective() == call[1]
        want = ref.summary()
        got = dict(summaries[0])
        for k in ("engaged_seen", "skipped_windows_seen"):
            got.pop(k)
        assert got == want
