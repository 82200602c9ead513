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
merge_fanin = 512

#: Background spill writer threads (:class:`.io.writer.SpillWriterPool`):
#: spills queue onto them, so a registering job does not wait on the
#: codec and the disk.  0 = synchronous spills on the registering thread.
spill_write_threads = 2

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
hbm_budget = "auto"


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
handoff = "auto"


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
pipeline = "auto"


def pipeline_enabled():
    return str(pipeline).lower() not in ("off", "0", "false", "no")


#: Bytes of finished map output an early-fold queue may hold before the
#: publishing thread waits; 0 = a quarter of the run's memory budget.
pipeline_queue_bytes = 0


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
    samples), else 0 (no registry, no sampler thread)."""
    if metrics_interval_ms > 0:
        return metrics_interval_ms
    if trace or progress:
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
