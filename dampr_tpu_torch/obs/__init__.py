"""Observability: run-scoped trace spans, per-run metrics, a structured
event log, a flight recorder, the per-operator profiler and the
critical-path analysis.  The port of ``dampr_tpu/obs`` for one process on
one card.

Enable with ``settings.trace = True`` (env ``DAMPR_TPU_TORCH_TRACE=1``).
Off — the default — every instrumentation site costs one module-global
``None`` check (the hot loops hoist it to one per job), no thread of
this layer starts and no file is written.  On, each run records spans at
the engine's boundaries and persists, under ``<scratch_root>/<run>/
trace/`` (``settings.trace_dir`` overrides the root), the JAX package's
two artifacts in its layout and schema:

**trace.json — the timeline.**  Chrome trace-event JSON, for Perfetto
(https://ui.perfetto.dev) or chrome://tracing.  Lanes (``tid`` +
``thread_name`` metadata) are the engine's threads: one track per map
slot (pool worker), overlap producer, writer-pool thread, reduce worker
and merge generation.  Span categories (event ``cat``), all from the
closed set of ``docs/trace_schema.json``:

- ``stage`` / ``job`` — one span per stage on the ``stages`` lane; one per
  job on its worker's lane;
- ``codec`` — one span per produced window (scan, tokenize) on its
  producer's lane; the lowered sink's host scan and bootstrap;
- ``fold`` — map-side partial/final folds, the device fold's fetch;
- ``stall`` — a fold consumer blocked on its producer (the per-slot view
  of devtime's ``codec_wait``);
- ``device`` — the lowered sink's batch dispatch and drain;
- ``handoff`` — table-program dispatches, degrades, the registration of
  a job's device refs;
- ``collective`` — the single-device keyed fold;
- ``hbm`` / ``spill`` / ``spill_queue`` / ``io_wait`` — HBM puts and
  offloads; spill writes (on the writer pool's lanes), a queued write's
  wait, writer backpressure and read waits;
- ``merge`` — merge generations, streamed merge runs, compactions;
- ``retry`` — the JAX package's job retries (none yet: retries are a
  later slice).

**stats.json — the summary** (schema ``dampr-tpu-stats/1``), returned
in-memory from every run, traced or not, as ``em.stats()``: per-stage
``records_in/out``, ``bytes_in/out``, spills and merges; the ``devtime``
buckets (:mod:`dampr_tpu_torch.ops.devtime`); ``overlap``, ``io``,
``store``, ``mesh`` (one device: no folds across devices), ``device``
(the port's kernel launches and host phases beside the JAX keys);
``trace_file`` / ``stats_file`` (None untraced).  A traced run adds
``metrics``, ``log``, ``spans`` and ``critpath``; a profiled run
``profile``; a failed one ``crashdump_file``.

**The metrics plane** (``settings.metrics_interval_ms``; traced runs
sample at 100 ms): the registry (:mod:`.metrics`) and its sampler thread
(:mod:`.sampler`), alive exactly as long as the run, snapshot the store's
residency and budget occupancy, the writer pool's queue, the overlap
slots, HBM residency and the throughput counters into series that
``trace.json`` carries as counter tracks; :mod:`.progress` prints a live
line per stage (``settings.progress``).

**The flight recorder** (:mod:`.flightrec`): a bounded ring of recent
spans, samples and WARN+ log records, flushed on the failure path to
``<run>/trace/crashdump.json``, a schema-valid mini-trace.

**The structured log** (:mod:`.log`, ``settings.log_level``): coded
events in ``<run>/trace/events.jsonl``.

**The diagnosis layer**: the per-operator profiler (:mod:`.profile`,
``settings.profile``) attributes fused-stage time to the user's ops and
a lowered stage's device work to build/h2d/compute/d2h; the
critical-path analysis (:mod:`.critpath`) names each stage's bounding
resource from the span timeline.

These spans are host-side: the card's own timeline (kernels, copies,
their gaps) comes from the escape hatch ``settings.profile_dir``, which
wraps the run in ``torch.profiler.profile`` (CPU, plus CUDA on a CUDA
run) and exports its Chrome trace there.  Its clock is the profiler's,
not the tracer's; nothing here merges the two.

Layering: :mod:`.trace` is the span recorder; :mod:`.metrics` the
registry; :mod:`.sampler`, :mod:`.progress` and :mod:`.flightrec`
consume it; :mod:`.export` serializes; ``MTRunner.run`` owns the
lifecycle (start, summary either way, files for traced runs).
"""

from .trace import Tracer, complete, enabled, instant, now, span  # noqa: F401
from . import export  # noqa: F401
from . import metrics  # noqa: F401
