"""Configuration for dampr_tpu_torch: the knobs the ported slice reads.

Same "assign a module attribute" ergonomics as ``dampr_tpu.settings``; the
environment overrides carry their own ``DAMPR_TPU_TORCH_`` prefix so the
two packages can be configured independently in one process.

The device is explicit.  :data:`device` names the ``torch.device`` every
device stage and kernel runs on ("cuda" by default, "cpu" in the CPU
tests).  Nothing falls back from a missing card to the CPU:
:func:`resolve_device` raises when CUDA is asked for and absent.
"""

import multiprocessing
import os
import tempfile

#: Host worker threads for a stage's jobs.
max_processes = multiprocessing.cpu_count()

#: Number of shuffle partitions.
partitions = 64

#: Records per host block built from per-record mappers.
batch_size = 65536

#: Byte budget for RAM-resident blocks; over it, the oldest unpinned
#: blocks spill to disk under :data:`scratch_root` (chunked frame files,
#: :mod:`.io`).
max_memory_per_stage = int(os.environ.get(
    "DAMPR_TPU_TORCH_MEMORY_BUDGET", str(512 * 1024 * 1024)))

#: Byte-scanning mappers read chunks in line-aligned windows of this size.
scan_window_bytes = 256 * 1024 ** 2

#: Where spilled blocks go (under the process temp dir by default).
scratch_root = os.environ.get("DAMPR_TPU_TORCH_SCRATCH") or os.path.join(
    tempfile.gettempdir(), "dampr_tpu_torch")

#: Partition size (bytes) above which a single-input reduce streams a k-way
#: merge over its hash-sorted runs instead of materializing the partition
#: (groups then arrive in hash order), and a two-input join streams a
#: hash-ordered merge join.  None = :data:`max_memory_per_stage`.
streaming_reduce_threshold = None

#: Most first-level sorted runs the final read merges directly; past it,
#: runs merge in streamed file -> file generations until the count fits.
#: The planner also clamps it so one window (plus its readahead) per run
#: fits the memory budget.
merge_fanin = int(os.environ.get("DAMPR_TPU_TORCH_MERGE_FANIN", "512"))

#: Background spill writer threads (:class:`.io.writer.SpillWriterPool`):
#: spills queue onto them, so a registering job does not wait on the
#: codec and the disk.  0 = synchronous spills on the registering thread.
spill_write_threads = int(os.environ.get("DAMPR_TPU_TORCH_SPILL_WRITERS",
                                         "2"))

#: The torch device of every device stage and kernel launch.
device = os.environ.get("DAMPR_TPU_TORCH_DEVICE", "cuda")

#: Keyed batch kernels (hash, sort, segment fold) may run on :data:`device`;
#: False keeps them all on host numpy.
use_device = os.environ.get("DAMPR_TPU_TORCH_USE_DEVICE", "1") not in (
    "0", "false")

_MIN_BATCH_FLOOR = 4096

#: Seed of ``sample()``'s per-thread RNGs (re-derived at each run start):
#: sampled pipelines reproduce exactly when the job -> thread assignment
#: does (serial runs).  None keeps them seeded from the OS.
seed = (int(os.environ["DAMPR_TPU_TORCH_SEED"])
        if os.environ.get("DAMPR_TPU_TORCH_SEED") else None)


def resolve_device():
    """The configured ``torch.device``; raises when it is CUDA and no card
    is visible (never a silent CPU run)."""
    import torch

    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dampr_tpu_torch.settings.device is {!r} but "
            "torch.cuda.is_available() is False; set device='cpu' (or "
            "DAMPR_TPU_TORCH_DEVICE=cpu) to run on the CPU".format(device))
    return d


def _device_type():
    return str(device).split(":")[0]


#: The mesh axis name (``dampr_tpu.settings.mesh_axis``).
mesh_axis = "shards"

#: The shards of the mesh (:mod:`.parallel.mesh`), in order: a string of
#: comma-separated devices, each with an optional ``*n`` repeat
#: (``"cpu*8"``, ``"cuda:0*4"``, ``"cuda:0,cuda:1"``), or a list of
#: devices.  One device may be named more than once.  None (the default)
#: is every visible card, or :data:`device` when that is the CPU.  A rig
#: for tests and the smoke script, not a feature: it is how an 8-shard
#: mesh runs on the CPU (the JAX package's tests force 8 virtual CPU
#: devices) and a 4-shard mesh on one card.  A ``cuda`` shard with no
#: card raises; it never runs on the CPU.
mesh_devices = os.environ.get("DAMPR_TPU_TORCH_MESH_DEVICES") or None


def _mesh_entries():
    """The unresolved mesh device names (see :data:`mesh_devices`)."""
    spec = mesh_devices
    if spec is None:
        if _device_type() == "cpu":
            return [str(device)]
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return ["cuda:{}".format(i) for i in range(n)] or [str(device)]
    if isinstance(spec, str):
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, times = part.partition("*")
            out.extend([name.strip()] * (int(times) if times else 1))
        return out
    return [str(d) for d in spec]


def mesh_device_list():
    """The mesh's shards as resolved ``torch.device``s; raises for a
    ``cuda`` shard with no such card (never a silent CPU run)."""
    import torch

    out = []
    for name in _mesh_entries():
        d = torch.device(name)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "mesh shard {!r} names a card but "
                    "torch.cuda.is_available() is False; set mesh_devices "
                    "(DAMPR_TPU_TORCH_MESH_DEVICES) to CPU shards to run "
                    "on the CPU".format(name))
            index = torch.cuda.current_device() if d.index is None \
                else d.index
            if index >= torch.cuda.device_count():
                raise RuntimeError("mesh shard {!r}: only {} card(s) "
                                   "visible".format(
                                       name, torch.cuda.device_count()))
            d = torch.device("cuda", index)
        out.append(d)
    if not out:
        raise ValueError("mesh_devices names no device")
    return out


def device_count_for_auto():
    """Shards of the global mesh for "auto" mesh decisions: the length of
    :data:`mesh_devices` (1 on one card or the CPU by default), times the
    ranks once a process group is up (every rank names its own local
    shards), counted without resolving a device."""
    from .parallel import mesh as _mesh

    n = len(_mesh_entries())
    if _mesh.is_initialized():
        n *= _mesh.rank_info()[1]
    return n


def use_device_for(n):
    """Device-dispatch decision for an n-record keyed batch: at least 4096
    records on the CPU device, 65536 on a card (below that a launch and a
    copy cost more than the numpy pass)."""
    if not use_device:
        return False
    return n >= (_MIN_BATCH_FLOOR if _device_type() == "cpu" else 1 << 16)


#: Device lowering of scanner map -> sum fold stages (:mod:`.plan.lower`):
#: "on"/"1" force it, "off"/"0" disable it, "auto" enables it iff
#: :data:`device` is CUDA.  Forcing it with device="cpu" runs the same
#: torch program through the kernels' plain versions (the CPU test leg).
lower = os.environ.get("DAMPR_TPU_TORCH_LOWER", "auto")


def lower_enabled():
    s = str(lower).lower()
    if s in ("on", "1", "true", "yes"):
        return True
    if s in ("off", "0", "false", "no"):
        return False
    return _device_type() == "cuda"


#: Tokens per device program dispatch (padded to a power of two).
lower_batch = int(os.environ.get("DAMPR_TPU_TORCH_LOWER_BATCH",
                                 str(1 << 18)))


def lower_forced():
    """Was lowering forced on ("on"/"1")?  A forced switch wins over the
    run-history placement floor (``plan.lower.LOWER_MIN_RECORDS``): only
    "auto" places stages from history."""
    return str(lower).lower() in ("on", "1", "true", "yes")



#: Device bytes the HBM tier may keep resident between a map and the fold
#: that consumes its output (:class:`.storage.RunStore`); over it, the
#: oldest device refs offload to host (the first spill step, before
#: disk).  "auto" is 1 GiB when :data:`device` is CUDA and 0 on the CPU;
#: 0 disables the tier.
hbm_budget = os.environ.get("DAMPR_TPU_TORCH_HBM_BUDGET", "auto")


def effective_hbm_budget():
    if isinstance(hbm_budget, int):
        return hbm_budget
    s = str(hbm_budget).lower()
    if s != "auto":
        return int(s)
    return 1 << 30 if _device_type() == "cuda" else 0


#: The device-resident handoff (:mod:`.ops.handoff`): a lowered scanner
#: map whose consumer is a device-lowered associative fold keeps its counts
#: on the device from its batches to the fold's final fetch.  "on"/"off"
#: force it; "auto" follows lowering where the HBM tier has a budget or
#: lowering was forced (on the CPU device memory is host memory), but an
#: explicit ``hbm_budget = 0`` declines it.
handoff = os.environ.get("DAMPR_TPU_TORCH_HANDOFF", "auto")


def handoff_forced():
    """Was the handoff forced on?  Then no run history prices the edge
    (:func:`.plan.lower.handoff_analyze`)."""
    return str(handoff).lower() in ("on", "1", "true", "yes")


def handoff_enabled():
    s = str(handoff).lower()
    if s in ("off", "0", "false", "no"):
        return False
    if s in ("on", "1", "true", "yes"):
        return True
    if str(hbm_budget).lower() != "auto" and effective_hbm_budget() == 0:
        return False
    return lower_enabled() and (effective_hbm_budget() > 0
                                or lower_forced())


def effective_handoff_budget():
    """Device bytes the handoff may keep resident: the HBM budget where it
    is funded, else (forced legs on the CPU) the stage memory budget."""
    b = effective_hbm_budget()
    if b > 0:
        return b
    if handoff_enabled():
        return max_memory_per_stage
    return 0


def _env_flag(name, default="0"):
    return os.environ.get(name, default).lower() not in (
        "0", "false", "no", "off", "")


#: Capacity slack of the keyed fold's per-destination buffers
#: (:func:`.parallel.shuffle.mesh_keyed_fold`: ``ceil(N / D) * factor``
#: rows per (source, destination); an overflow doubles it and reruns).
shuffle_capacity_factor = 1.5

#: Route associative sum/min/max reduces through the mesh keyed fold
#: (local fold -> all_to_all -> final fold): "auto" when the mesh has
#: more than one shard or the reduce reads device refs, "on", "off".  The
#: host path takes over wherever exactness needs it (object or float
#: values, a running sum past int64, a 64-bit key collision).
mesh_fold = os.environ.get("DAMPR_TPU_TORCH_MESH_FOLD", "auto")

#: Route the general shuffle (non-associative group_by reduces, joins,
#: sort_by's range read) through the mesh byte exchange
#: (:mod:`.parallel.exchange`): partition ``pid`` lands on shard
#: ``pid % D``.  "auto" when the mesh has more than one shard, "on",
#: "off".  ``mesh_fold`` takes precedence where it applies.
mesh_exchange = os.environ.get("DAMPR_TPU_TORCH_MESH_EXCHANGE", "auto")

#: Peak in-flight device bytes of one exchange step (send and delivered
#: buffers, :func:`.parallel.replan.step_inflight_bytes`): every window
#: runs as a schedule of chunked steps that each fit it.
exchange_hbm_budget = int(os.environ.get(
    "DAMPR_TPU_TORCH_EXCHANGE_HBM", str(64 * 1024 ** 2)))

#: An explicit cap (bytes) on one piece of the exchange schedule, below
#: what the budget allows; 0 derives it from the budget.
exchange_chunk_bytes = int(os.environ.get("DAMPR_TPU_TORCH_EXCHANGE_CHUNK",
                                          "0"))

#: Recorded shuffle input under which "auto" keeps a stage on the host
#: shuffle (:func:`.plan.cost.shuffle_choice`); explicit modes win.
exchange_min_bytes = int(os.environ.get(
    "DAMPR_TPU_TORCH_EXCHANGE_MIN_BYTES", str(4 * 1024 ** 2)))

#: Deadline (ms) of one exchange step; 0 = none.  A step past it flushes
#: the flight recorder, records an ``exchange_timeout`` fault event (the
#: next run under the name keeps that stage on the host shuffle) and
#: exits the process with 70.
exchange_timeout_ms = int(os.environ.get(
    "DAMPR_TPU_TORCH_EXCHANGE_TIMEOUT_MS", "0"))

#: Straggler mitigation (:mod:`.parallel.mitigate`): "on" starts a
#: controller per run that turns the live skew signal into action: work
#: stealing and speculative re-execution of straggler jobs on the host
#: path, skipped collective windows while a rank is persistently late at
#: exchange steps, and a sticky partition-share down-weight for a rank
#: that stays pathological.  "off" (the default) is one None-check per
#: site.
mitigate = os.environ.get("DAMPR_TPU_TORCH_MITIGATE", "off")


def mitigate_enabled():
    return str(mitigate).lower() in ("on", "1", "true", "yes")


#: The mitigation's one ratio: a rank whose step-entry lateness is at
#: least this multiple of the other ranks' mean (plus a 20 ms jitter
#: floor) counts as pathological, and a host job running this multiple
#: of the median completed job becomes a speculation candidate.
speculate_threshold = float(os.environ.get(
    "DAMPR_TPU_TORCH_SPECULATE_THRESHOLD", "1.5"))

#: Consecutive pathological windows before the mitigation engages (and
#: healthy probes before it disengages); twice as many escalate to the
#: sticky down-weight.
speculate_after_steps = int(os.environ.get(
    "DAMPR_TPU_TORCH_SPECULATE_AFTER", "3"))

#: While engaged, every this-many skipped windows one runs through the
#: mesh as a probe of the skew; 0 keeps the degrade for the run.
mitigate_probe_windows = int(os.environ.get(
    "DAMPR_TPU_TORCH_MITIGATE_PROBE", "4"))

#: How long (ms) rank 0 of a traced multi-process run waits at finalize
#: for its siblings' artifacts before it merges the fleet timeline
#: (:mod:`.obs.fleet`) with what landed; 0 skips the merge at finalize
#: (``cli stats --fleet`` merges afterwards).
fleet_wait_ms = int(os.environ.get("DAMPR_TPU_TORCH_FLEET_WAIT_MS",
                                   "10000"))

#: Coded aggregation over the byte exchange: "camr" folds each window's
#: blocks per destination partition under the stage's associative op
#: before they cross (integer lanes for sums, numeric for min/max);
#: "off" ships them raw.
exchange_coding = os.environ.get("DAMPR_TPU_TORCH_EXCHANGE_CODING", "off")


def exchange_coding_enabled():
    return str(exchange_coding).lower() in ("camr", "on", "1", "true")


#: Per-route compression of the exchange's blobs: "auto" (zstd, then lz4,
#: else raw), a codec name, or "off".
exchange_codec = os.environ.get("DAMPR_TPU_TORCH_EXCHANGE_CODEC", "auto")


#: Static pipeline analysis (:mod:`.analyze`): UDF purity and determinism
#: verdicts from bytecode, the pickle probe, fold associativity, and the
#: traceability probe that certifies numeric ``map``/``filter`` chains as
#: device lane programs.  On (the default), every run's plan report
#: carries an ``analysis`` section, fusion declines to fuse across an
#: evidence-impure UDF, and a certified chain lowers to the device.  Off
#: (``DAMPR_TPU_TORCH_ANALYZE=0``), each hook is one flag check and plans
#: and results are those of an engine without the analyzer.
analyze = _env_flag("DAMPR_TPU_TORCH_ANALYZE", "1")


#: Sorted-run mode for map outputs no reduce consumes (external sorts):
#: each job registers its chunk as one key-sorted run and the final read
#: merges the runs.  "auto" enables it; "off" hash-fans every map output
#: (which lets an unfused map -> map edge stream, :mod:`.plan.pipeline`).
sort_runs = "auto"


def sort_runs_enabled():
    return str(sort_runs).lower() not in ("off", "0", "false", "no")


#: Run-history corpus (:mod:`.obs.history`): every finalized named run
#: appends one compact record to ``<scratch_root>/<run>/history.jsonl``,
#: kept to this many entries; 0 writes none.
history_entries = 64

#: Only the newest this-many shape-matching records feed the history
#: medians and the handoff pricing.
history_window = 8

#: History-driven sizing (:mod:`.plan.cost`): a named run whose plan
#: matches earlier runs' shapes takes its partition count, per-stage
#: ``batch_size`` and reducer width from their measurements.
plan_adapt = True

#: Reduce-input bytes one adapted partition should carry.
plan_partition_bytes = 32 * 1024 ** 2

#: Bytes an adapted map-output block should hold when history shows fat
#: records.
plan_block_bytes = 8 * 1024 ** 2

#: The learned per-operator cost model (:mod:`.plan.model`): "auto" fits
#: per-class throughput over the corpus and may override the median
#: sizing; "off" records the kill switch and leaves the median decisions.
cost_model = "auto"


def cost_model_enabled():
    return str(cost_model).lower() not in ("0", "false", "no", "off")


#: Closed-loop autotuning for the bench (:mod:`.obs.autotune`): "on"
#: turns the bench's warm trials into an in-process session that re-runs
#: the pipeline under model- and playbook-suggested knob vectors, keeps
#: the fastest byte-identical one and persists it (``tuned.json`` plus
#: the winner run's corpus record).  The subprocess form is ``python -m
#: dampr_tpu_torch.cli doctor RUN --autotune -- CMD ...``.  "off" runs
#: one configuration.
autotune = os.environ.get("DAMPR_TPU_TORCH_AUTOTUNE", "off")


def autotune_enabled():
    return str(autotune).lower() in ("on", "1", "true", "yes")


#: Measured executions one autotune session may run, trial 0 (the
#: incoming configuration) included.
autotune_trials = int(os.environ.get("DAMPR_TPU_TORCH_AUTOTUNE_TRIALS",
                                     "4"))

#: Measurements an operator class needs before its fit takes part.
cost_model_min_points = 3

#: Least predicted (or measured) fractional gain before a model choice
#: overrides the static or median one.
cost_model_margin = 0.02

#: Streamed stage edges (:mod:`.plan.pipeline`): "auto" lets the runner
#: dissolve the barrier on edges the plan marks ``streamed`` (early folds
#: of map -> keyed sum/min/max, unfused map -> map chains); "off" runs
#: every stage behind its barrier.  Results are equal either way, and the
#: decisions are reported in both modes.
pipeline = os.environ.get("DAMPR_TPU_TORCH_PIPELINE", "auto")


def pipeline_enabled():
    return str(pipeline).lower() not in ("off", "0", "false", "no")


#: Bytes of finished map output an early-fold queue may hold before the
#: publishing thread waits; 0 = a quarter of the run's memory budget.
pipeline_queue_bytes = int(os.environ.get("DAMPR_TPU_TORCH_PIPELINE_QUEUE",
                                          "0"))


#: When set, every run is wrapped in ``torch.profiler.profile`` (CPU
#: activity, plus CUDA on a CUDA run) and its Chrome trace is exported
#: under this directory: the card's kernel and copy timeline.  A CUDA run
#: whose profiler cannot record the card raises.
profile_dir = os.environ.get("DAMPR_TPU_TORCH_PROFILE_DIR") or None

#: Run-scoped engine tracing (:mod:`.obs`): spans at the engine's
#: boundaries, persisted as ``trace.json`` (Chrome trace events, for
#: Perfetto) and ``stats.json`` under ``<trace_dir or scratch_root>/
#: <run>/trace/``.  Off, each span site is one ``None`` check.
trace = _env_flag("DAMPR_TPU_TORCH_TRACE")

#: Root of the trace artifacts; None puts them under :data:`scratch_root`.
trace_dir = os.environ.get("DAMPR_TPU_TORCH_TRACE_DIR") or None

#: Per-operator profiler (:mod:`.obs.profile`): ``stats()["profile"]``
#: attributes each stage's job time to the user ops it was fused from,
#: and a lowered stage's device work to build/h2d/compute/d2h.
profile = _env_flag("DAMPR_TPU_TORCH_PROFILE")

#: Cadence (ms) of the metrics plane's sampler (:mod:`.obs.metrics`,
#: :mod:`.obs.sampler`); 0 = off unless a traced or progress run needs it
#: (:func:`effective_metrics_interval_ms`).
metrics_interval_ms = int(os.environ.get("DAMPR_TPU_TORCH_METRICS_MS", "0"))

#: One live progress line per stage on stderr (:mod:`.obs.progress`);
#: implies the metrics plane.
progress = _env_flag("DAMPR_TPU_TORCH_PROGRESS")

#: Floor of the structured event log ``events.jsonl`` (:mod:`.obs.log`):
#: debug/info/warn/error; "" writes none (traced runs stream at info).
log_level = os.environ.get("DAMPR_TPU_TORCH_LOG", "").strip().lower()


def effective_metrics_interval_ms():
    """The sampling cadence in force: the explicit setting, else 100 ms
    for a traced or progress run (a traced run's crashdump carries recent
    samples) or one with a live endpoint (:data:`metrics_port`: a scraper
    must see moving gauges), else 0 (no registry, no sampler thread)."""
    if metrics_interval_ms > 0:
        return metrics_interval_ms
    if trace or progress or metrics_port > 0:
        return 100
    return 0


def effective_log_level():
    """The event log's floor in force: :data:`log_level`, else ``info``
    for a traced run, else "" (no ``events.jsonl``)."""
    if log_level:
        return log_level
    if trace:
        return "info"
    return ""


#: Regression sentry (:mod:`.obs.sentry`): how many earlier points of the
#: same plan fingerprint the newest telemetry point is judged against
#: (at least 3 needed).  0 turns the finalize-time check off (the sentry
#: CLI still works with an explicit ``--window``).
sentry_window = int(os.environ.get("DAMPR_TPU_TORCH_SENTRY_WINDOW", "8"))

#: Robust z-score past which the sentry flags a metric: its distance from
#: the window's median in scaled MADs, in the metric's bad direction.
sentry_mad_threshold = float(os.environ.get("DAMPR_TPU_TORCH_SENTRY_MAD",
                                            "3.5"))

#: Refresh interval (ms) of the live dashboard (:mod:`.obs.top`).
top_refresh_ms = int(os.environ.get("DAMPR_TPU_TORCH_TOP_REFRESH_MS",
                                    "1000"))


# -- faults, retries and resume (:mod:`.faults`, :mod:`.resume`) -----------

#: Per-job retry budget: a failing map, reduce or sink job re-executes up
#: to this many times before the run fails with the original error.
#: Retries are classified (:func:`.faults.classify`): transient failures
#: (flaky I/O) back off exponentially with jitter, deterministic ones
#: retry at once, fatal ones (``MemoryError``, kills) never.  0 = fail
#: fast.
job_retries = int(os.environ.get("DAMPR_TPU_TORCH_JOB_RETRIES", "0"))

#: In-place retry budget for transient spill I/O (frame writes and reads,
#: checkpoint persistence), absorbed inside the I/O layer.
io_retries = int(os.environ.get("DAMPR_TPU_TORCH_IO_RETRIES", "2"))

#: Base and cap (ms) of the full-jitter exponential backoff: each delay is
#: uniform over [0, min(cap, base * 2^attempt)].
retry_backoff_ms = int(os.environ.get("DAMPR_TPU_TORCH_RETRY_BACKOFF_MS",
                                      "50"))
retry_backoff_max_ms = 5000

#: Poison-record quarantine budget: > 0 bisects a deterministically
#: failing batch on the batched record path and lands up to this many
#: offending records in ``<scratch_root>/<run>/quarantine.jsonl`` instead
#: of failing the run.  0 = fail fast.
max_quarantined = int(os.environ.get("DAMPR_TPU_TORCH_MAX_QUARANTINED",
                                     "0"))

#: Whole-run retry budget of ``run(resume="auto")``: a failed run
#: re-executes from its last durable checkpoint up to this many times.
run_retries = 1

#: The fault-injection plan (:mod:`.faults`): a seeded schedule of fault
#: sites and firing rules, e.g. ``"spill_write:p=0.01;fold:nth=3;seed=7"``
#: (``DAMPR_TPU_TORCH_FAULTS``, the chaos harness's interface).  None =
#: injection off: every site is one ``None`` check.
faults = os.environ.get("DAMPR_TPU_TORCH_FAULTS") or None


# -- the cross-run cache (:mod:`.plan.reuse`) -------------------------------

#: The shared, content-addressed stage cache: a stage output whose whole
#: producing prefix (stage structure chained with the inputs' content
#: signatures) was published before mounts the cached partition frames
#: instead of recomputing, and append-only input growth re-runs only the
#: new files.  "auto" resolves OFF in ordinary processes and ON inside a
#: serve-daemon worker (:data:`serve_active`); "0"/"off" keeps the cache
#: out of the path, in the daemon too.  Results are equal either way.
reuse = os.environ.get("DAMPR_TPU_TORCH_REUSE", "auto")


def reuse_enabled():
    v = str(reuse).lower()
    if v in ("on", "1", "true", "yes"):
        return True
    if v in ("off", "0", "false", "no"):
        return False
    return bool(serve_active)  # "auto": ON inside serve-daemon workers


#: Byte budget of the shared cache directory: a publish past it evicts
#: the least recently consumed whole entries under the store's flock.
#: Mounted runs are immune (they hardlink the frames into their own
#: scratch before reading).
reuse_budget_bytes = int(os.environ.get("DAMPR_TPU_TORCH_REUSE_BUDGET",
                                        str(2 * 1024 ** 3)))

#: The shared cache directory; empty resolves to
#: ``<scratch_root>/reuse-cache`` at use time.
reuse_dir = os.environ.get("DAMPR_TPU_TORCH_REUSE_DIR", "")

#: Content-signature window (bytes): input files are hashed in windows of
#: this size, so append-only growth shows as a signature whose files
#: extend a cached one's.
reuse_chunk_bytes = int(os.environ.get("DAMPR_TPU_TORCH_REUSE_CHUNK",
                                       str(16 * 1024 ** 2)))


# -- the live metrics endpoint (:mod:`.obs.serve`) ----------------------------

#: When > 0, every run serves ``/metrics`` (Prometheus text of the live
#: registry, rank-labelled) and ``/healthz`` on this port (plus the rank)
#: while it is in flight, and samples its gauges every 100 ms.  0 serves
#: nothing.
metrics_port = int(os.environ.get("DAMPR_TPU_TORCH_METRICS_PORT", "0"))


# -- the serve daemon (:mod:`.serve`) -----------------------------------------

#: Daemon HTTP port; a busy port probes upward, 0 asks the OS for one.
serve_port = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_PORT", "9400"))

#: Daemon bind address.  Loopback by default: the wire is pickle, so the
#: protocol trusts its clients.
serve_host = os.environ.get("DAMPR_TPU_TORCH_SERVE_HOST", "127.0.0.1")

#: Concurrent job slots: worker subprocesses the daemon runs at once.
serve_workers = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_WORKERS", "2"))

#: Per-tenant admission budget: estimated input bytes a tenant's queued
#: and running jobs may reserve; past it a submission is rejected
#: (``budget``).  A finished or cancelled job releases its reservation.
serve_tenant_budget = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_BUDGET",
                                         str(2 * 1024 ** 3)))

#: Deficit-round-robin quantum (bytes a tenant earns per round).
serve_quantum = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_QUANTUM",
                                   str(64 * 1024 ** 2)))

#: Per-tenant queue depth; past it a submission is rejected
#: (``queue-full``).
serve_queue_depth = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_QUEUE_DEPTH",
                                       "16"))

#: Per-job wall-clock timeout (ms): past it the daemon SIGTERMs the job's
#: worker (its crashdump path), then SIGKILLs it.  0 = none.
serve_job_timeout_ms = int(os.environ.get(
    "DAMPR_TPU_TORCH_SERVE_JOB_TIMEOUT_MS", "600000"))

#: Graceful-drain deadline (ms) on SIGTERM or ``POST /drain``.
serve_drain_ms = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_DRAIN_MS",
                                    "30000"))

#: Whether workers run traced, so a killed or failed job leaves a
#: schema-valid ``crashdump.json`` under its job directory.
serve_trace = _env_flag("DAMPR_TPU_TORCH_SERVE_TRACE", "1")

#: Terminal job records (and their directories) the daemon keeps.
serve_jobs_keep = int(os.environ.get("DAMPR_TPU_TORCH_SERVE_JOBS_KEEP",
                                     "256"))

#: Daemon state directory; empty resolves to ``<scratch_root>/serve``.
serve_dir = os.environ.get("DAMPR_TPU_TORCH_SERVE_DIR", "")

#: Set by the daemon in every worker's environment: how
#: :func:`reuse_enabled` resolves "auto" ON inside served jobs only.  Not
#: an operator knob.
serve_active = _env_flag("DAMPR_TPU_TORCH_SERVE_ACTIVE")
