"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix,
pipeline, reference and metric readers are found by name
(:mod:`portbench.registry`).  A run:

1. checks the cards (``torch.cuda``) and that ``dampr_tpu_torch`` is the
   checkout's own, and prints the host's affinity, load and the card's
   clocks and power limit on standard error;
2. has the traffic's maker (``makers/<maker>.py``) make the data from
   ``--seed`` under ``$TMPDIR/portbench/<cell>/`` and reads each file of it
   once, so that it sits in the page cache; its time is printed on a line
   of its own and left out of ``setup_s``;
3. pins the port's settings from the configuration's file (parallelism,
   lowering, no history, no cache, no autotune), and runs one warm-up
   job: set-up ends there;
4. runs jobs back to back, unnamed, until ``--seconds`` have elapsed and
   the running job has finished (:mod:`portbench.window`); with
   ``--trace 1`` under ``torch.profiler`` and the port's tracer;
5. once the window has closed and the program's state is freed, holds
   every job's output against the plain reference, row by row, exactly;
6. prints the compared numbers with their limits on standard error and,
   as the last line of standard output, one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

Each job's wall and plan, and the data's sizes and SHA-256, go into the
run's file (``--run-file``, by default
``$TMPDIR/portbench/runs/<cell>-s<seed>-t<trace>.json``).
"""

import argparse
import gc
import glob
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from portbench import check, corpus, registry, timeline, window
from portbench.peaks import hbm_bytes_per_s

#: Top-level module names that may not be loaded when the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "dampr_tpu")

#: Directories of the program's build and kernel caches, inside the
#: checkout at fixed paths.
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton"}


#: Whole jobs of the cell's own shape that set-up runs before the window.
WARMUP_JOBS = 1


class Failure(Exception):
    """A run that cannot give a result (exit code 2, nothing printed)."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def process_start_wall():
    """The wall-clock time this process started (``/proc``, 10 ms)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def written_bytes():
    """Bytes this process has written: ``wchar`` (every ``write``) and
    ``write_bytes`` (sent to storage), from ``/proc/self/io``."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def rss_bytes():
    """The process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def maxrss_bytes():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class Marks(object):
    """Set-up's steps: seconds since the process started, and the resident
    set then, for the run's file."""

    def __init__(self, t_proc):
        self.t_proc = t_proc
        self.steps = []

    def __call__(self, name):
        self.steps.append({"step": name,
                           "s": round(time.time() - self.t_proc, 4),
                           "rss_mb": round(rss_bytes() / 1e6, 1),
                           "maxrss_mb": round(maxrss_bytes() / 1e6, 1)})


class GcTimer(object):
    """Seconds the cyclic garbage collector ran, from ``gc.callbacks``."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = 0
        self._t = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.collections += 1
            self._t = None

    def close(self):
        gc.callbacks.remove(self._cb)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_line(cuda):
    """The host's affinity and load, and the card's clocks and limit."""
    out = {"affinity_cpus": len(os.sched_getaffinity(0)),
           "loadavg": os.getloadavg()}
    if cuda:
        try:
            q = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                 "clocks.max.sm,clocks.mem,temperature.gpu",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20)
            out["nvidia_smi"] = q.stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out["nvidia_smi"] = "unread: {}".format(e)
    return out


def checked_jobs(policy, seed, first=8):
    """Which window jobs keep their output for the check: ``"all"``, or
    ``k`` job indices drawn from the seed among the first ``first`` (a
    fixed number, so that outputs held in memory until the window closes
    weigh the same in every run, whatever its number of jobs)."""
    if policy == "all":
        return lambda i: True
    picked = set(corpus._seed_rng(seed).choice(first, size=int(policy),
                                               replace=False).tolist())
    return lambda i: i in picked


def plan_of(stats):
    device = stats.get("device", {})
    plan = stats.get("plan", {})
    return {"lowered_stages": device.get("device_stages"),
            "handoff_edges": device.get("handoff_edges"),
            "n_partitions": stats.get("n_partitions"),
            "stages": plan.get("stages_after")}


class Context(object):
    """What a metric reader reads (see ``metrics/``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--run-file", default=None,
                   help="where to write each job's wall and plan")
    return p.parse_args(argv)


def _pin_settings(settings, config, scratch, device):
    """The configuration's settings, and the run's scratch root."""
    for key, value in config["settings"].items():
        if not hasattr(settings, key):
            raise Failure("config {} sets {!r}, which dampr_tpu_torch."
                          "settings does not have".format(config["name"],
                                                          key))
        setattr(settings, key, value)
    settings.scratch_root = scratch
    if device is not None:  # a run on the CPU: the lowered path forced
        settings.device = device
        settings.lower = "on"


def _profiler(cuda):
    if not cuda:
        return None
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def run(argv=None, root=registry.ROOT, device=None):
    """One run; returns the result dict.  ``device`` (tests only) runs on
    that torch device with no look for a card."""
    t_proc = process_start_wall()
    marks = Marks(t_proc)
    args = _parse(argv)
    bench = registry.Bench(root)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    pipe = bench.module("pipelines", cell["config"])
    ref = bench.module("reference", cell["config"])
    entries = bench.metrics(args.workload, args.trace)
    readers = {m["name"]: bench.module("metrics", m["name"])
               for m in entries}
    cuda = device is None

    import torch

    marks("import torch")
    if cuda:
        if not torch.cuda.is_available():
            raise Failure("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise Failure("the cell asks for {} card(s); {} visible".format(
                cell["chips"], torch.cuda.device_count()))
        spec = importlib.util.find_spec("dampr_tpu_torch")
        origin = os.path.realpath(spec.origin) if spec and spec.origin \
            else None
        if origin is None or not origin.startswith(
                os.path.realpath(root) + os.sep):
            raise Failure("dampr_tpu_torch is not the checkout's own: "
                          "{}".format(origin))
        for var, sub in CACHE_ENV.items():
            os.environ[var] = os.path.join(root, "portbench", "_cache", sub)
    for var in [v for v in os.environ if v.startswith("DAMPR_TPU_TORCH_")]:
        del os.environ[var]
    log("host " + json.dumps(host_line(cuda)))

    work = os.path.join(tempfile.gettempdir(), "portbench", args.workload)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "out"))
    try:
        return _run(args, bench, cell, config, traffic, pipe, ref, entries,
                    readers, cuda, device, work, marks, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, config, traffic, pipe, ref, entries, readers,
         cuda, device, work, marks, torch):
    t0 = time.time()
    made = bench.maker(traffic).make(traffic, args.seed, work, bench)
    maker_s = time.time() - t0
    inputs = made["input"]
    files = inputs if isinstance(inputs, dict) else {"input": inputs}
    sha256 = {name: corpus.read_once(p)[1] for name, p in files.items()}
    nbytes, truth = made["bytes"], made["truth"]
    chunk = corpus.chunk_size(made["stored_bytes"], config["chunks"])
    corpus_s = time.time() - t0
    about = made.get("about", {})
    log("corpus {} bytes stored as {} bytes ({}), {} chunks of {} bytes, "
        "made in {:.3f} s, {:.3f} s with the read".format(
            nbytes, made["stored_bytes"], json.dumps(about),
            config["chunks"], chunk, maker_s, corpus_s))
    marks("corpus")

    from dampr_tpu_torch import settings

    _pin_settings(settings, config, os.path.join(work, "scratch"), device)
    settings.resolve_device()
    if cuda:
        torch.zeros(1, device=settings.device)  # the CUDA context
    marks("import dampr_tpu_torch, CUDA context")
    gct = GcTimer()
    keep = checked_jobs(config.get("check_jobs", "all"), args.seed)

    def job(tag):
        def one(i):
            out = os.path.join(work, "out", "{}-{}".format(tag, i))
            gc0, cpu0 = gct.seconds, time.process_time()
            output, stats = pipe.job(inputs, chunk, out)
            dev = stats.get("device", {})
            if tag != "warm" and not keep(i):
                output = None
            return {"output": output, "stats": stats, "plan": plan_of(stats),
                    "phases": dict(dev.get("host_phase_seconds") or {},
                                   handoff=dev.get("handoff"),
                                   devtime=stats.get("devtime"),
                                   stages=[round(st.get("seconds", 0), 4)
                                           for st in stats.get("stages", ())]),
                    "gc_s": gct.seconds - gc0,
                    "cpu_s": time.process_time() - cpu0,
                    "rss_mb": rss_bytes() / 1e6}
        return one

    warm = []
    for i in range(WARMUP_JOBS):
        a = time.perf_counter()
        warm.append(job("warm")(i))
        warm[-1]["wall"] = time.perf_counter() - a
        marks("warm-up job {}".format(i))
    if cuda:
        torch.cuda.synchronize()
    gc.collect()

    prof = None
    if args.trace:
        settings.trace = settings.profile = True
        settings.trace_dir = os.path.join(work, "traces")
        prof = _profiler(cuda)
    w_start = time.time()
    setup_s = w_start - marks.t_proc - corpus_s
    start, end, walls, jobs = window.run_window(job("win"), args.seconds)
    if cuda:
        torch.cuda.synchronize()
    w_end = w_start + (end - start)
    maxrss = maxrss_bytes()
    gct.close()
    mem_peak = (max(torch.cuda.max_memory_reserved(d)
                    for d in range(cell["chips"])) if cuda else 0)
    tl = None
    if prof is not None:
        prof.stop()
        trace_path = os.path.join(work, "profile.json")
        prof.export_chrome_trace(trace_path)
        del prof
        spans = []
        for p in glob.glob(os.path.join(work, "traces", "**", "trace.json"),
                           recursive=True):
            spans.extend(timeline.host_spans(timeline.load(p)))
        tl = timeline.reduce(
            timeline.device_events(timeline.load(trace_path)),
            w_start * 1e6, w_end * 1e6, spans)
        os.remove(trace_path)
    settings.trace = settings.profile = False
    for j, wall in zip(jobs, walls):
        j["wall"] = wall
        j["bytes"] = nbytes

    # the window has closed: free the program's state, then check
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = ref.expected(*truth)
    all_jobs = warm + jobs
    for j in all_jobs:
        j["check"] = (None if j["output"] is None else
                      check.mismatches(ref.load(j["output"]), want))
        j["output"] = None
    shutil.rmtree(os.path.join(work, "out"), ignore_errors=True)
    checked = [j for j in all_jobs if j["check"] is not None]
    failed = sum(1 for j in jobs if j["check"] and check.total(j["check"]))
    plans = [j["plan"] for j in all_jobs]
    if any(p != plans[0] for p in plans):
        log("plan differs between jobs: " + json.dumps(plans))

    ctx = Context(jobs=jobs, window_s=end - start,
                  total_bytes=float(nbytes * len(jobs)),
                  setup_s=setup_s, cold_job_s=warm[0]["wall"],
                  maxrss_bytes=maxrss, timeline=tl,
                  work=ref.work(*truth) if args.trace
                  else None,
                  hbm_bytes_per_s=(hbm_bytes_per_s(
                      torch.cuda.get_device_name(0)) if cuda else None))
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    run_file = args.run_file or os.path.join(
        os.path.dirname(work), "runs", "{}-s{}-t{}.json".format(
            args.workload, args.seed, args.trace))
    os.makedirs(os.path.dirname(os.path.abspath(run_file)), exist_ok=True)
    keep = ("wall", "plan", "check", "gc_s", "cpu_s", "rss_mb", "phases")
    with open(run_file, "w") as f:
        json.dump({"workload": args.workload, "seed": args.seed,
                   "trace": args.trace, "setup_s": setup_s,
                   "corpus_s": corpus_s, "maker_s": maker_s,
                   "setup_steps": marks.steps,
                   "window_s": end - start, "corpus_bytes": nbytes,
                   "stored_bytes": made["stored_bytes"],
                   "chunk_size": chunk, "corpus_sha256": sha256,
                   "corpus_about": about,
                   "warmup": [{k: j[k] for k in keep} for j in warm],
                   "jobs": [{k: j[k] for k in keep} for j in jobs],
                   "written": written_bytes(), "maxrss_bytes": maxrss,
                   "metrics": metrics, "timeline": tl,
                   "last_stats": jobs[-1]["stats"]}, f, indent=1,
                  default=str)
    log("job walls (s): warm-up {} window {}".format(
        [round(j["wall"], 4) for j in warm], [round(w, 4) for w in walls]))

    checks = {"{}_rows".format(k): {
        "value": sum(j["check"][k] for j in checked), "limit": 0}
        for k in ("missing", "extra", "wrong")}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": mem_peak}
    if tl is not None:
        dev["busy_s"] = tl["busy_s"]
        dev["window_s"] = tl["window_s"]
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if tl is not None:
        result["breakdown"] = {"device_ops": tl["device_ops"],
                               "idle_gaps": tl["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None):
    try:
        result = run(argv)
    except Failure as e:
        log("portbench: " + str(e))
        return 2
    found = forbidden_modules()
    if found:
        log("portbench: loaded in this process once the window closed: "
            + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        log("check {} {} limit {}".format(name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
