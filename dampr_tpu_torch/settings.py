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
    """Was lowering forced on ("on"/"1")?"""
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
