"""Per-job worker: ``python -m dampr_tpu_torch.serve.worker <job_dir>``.

Port of ``dampr_tpu/serve/worker.py``.  One job = one process = one run
scope: a poison record, a per-job timeout, a client's cancel or an
operator's SIGTERM all land on this process.  The fault layer classifies
and retries inside it (``resume="auto"``), the runner's SIGTERM handler
takes the failed run's path (device lanes released, a schema-valid
``crashdump.json``, exit 143), and the daemon only reaps an exit code.
On a card, each worker owns its CUDA context, its HBM budget and its
loaded kernel libraries; its exit frees all of them.

Contract with the daemon (every path inside ``job_dir``):

- ``job.json`` (read): run name, resume mode, the daemon's options;
- ``payload.bin`` (read): the :mod:`.wire` envelope;
- ``result.pkl`` (written on success, atomically): the pickled list of
  the output's ``(key, value)`` records, the bytes the daemon streams
  back verbatim to every client of this run;
- ``result.json`` (written on success): wall seconds, record count, the
  run's ``reuse`` section, the trace and stats paths, the device and
  this process's pid;
- ``error.json`` (written on failure, best effort): the classified error,
  the device and the pid.

The environment is the daemon's doing (``daemon._spawn``): the shared
scratch root and cache directory, the daemon's live device,
``DAMPR_TPU_TORCH_SERVE_ACTIVE=1`` (which resolves ``settings.reuse``
"auto" ON) and a per-job trace directory.  The device is resolved before
anything runs: a worker told ``cuda`` on a host without a visible card
fails its job with a classified error and never runs on the CPU.
"""

import json
import os
import pickle
import sys
import time


def _write_json(path, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, default=str)
    os.replace(tmp, path)


def run_job(job_dir):
    """Execute the job under ``job_dir``; returns the process exit code."""
    with open(os.path.join(job_dir, "job.json")) as f:
        spec = json.load(f)
    with open(os.path.join(job_dir, "payload.bin"), "rb") as f:
        payload = f.read()

    from . import wire
    from .. import dampr as _dampr
    from .. import settings

    started = time.time()
    try:
        # the card (or the CPU the daemon was told to use) before the plan:
        # a missing card fails the job here, never falls back
        settings.resolve_device()
        graph, source = wire.decode(payload)
        handle = _dampr.PBase(source, _dampr.Dampr(graph))
        kwargs = {}
        resume = spec.get("resume", "auto")
        if resume:
            kwargs["resume"] = resume
        em = handle.run(name=spec["run_name"], **kwargs)
        records = list(em.dataset.read())
        tmp = os.path.join(job_dir, "result.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(records, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(job_dir, "result.pkl"))
        summary = em.stats() or {}
        _write_json(os.path.join(job_dir, "result.json"), {
            "wall_seconds": round(time.time() - started, 6),
            "records": len(records),
            "reuse": summary.get("reuse"),
            "trace_file": summary.get("trace_file"),
            "stats_file": summary.get("stats_file"),
            "run_name": spec["run_name"],
            "device": str(settings.device),
            "pid": os.getpid(),
        })
        return 0
    except BaseException as e:
        from .. import faults as _faults

        try:
            import traceback

            _write_json(os.path.join(job_dir, "error.json"), {
                "type": type(e).__name__,
                "message": str(e)[:2000],
                "kind": _faults.classify(e),
                "device": str(settings.device),
                "pid": os.getpid(),
                "wall_seconds": round(time.time() - started, 6),
                "traceback": traceback.format_exc()[-4000:],
            })
        except Exception:
            pass
        if isinstance(e, SystemExit):
            raise  # the runner's SIGTERM path already chose the code
        if isinstance(e, KeyboardInterrupt):
            return 130
        return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m dampr_tpu_torch.serve.worker <job_dir>",
              file=sys.stderr)
        return 2
    return run_job(argv[0])


if __name__ == "__main__":
    sys.exit(main())
