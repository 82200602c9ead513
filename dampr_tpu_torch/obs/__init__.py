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
  job on its worker's lane (args ``job``, the job's index in its stage,
  and ``stage``, the stage id);
- ``codec`` — one span per produced window (scan, tokenize) on its
  producer's lane (arg ``job``: the job it feeds); the lowered sink's
  host scan (``sink-scan``), padded batch (``sink-pad``) and bootstrap;
- ``fold`` — map-side partial/final folds, the device fold's work
  (``device-fold``) and fetch, the lowered sink's decode of a drained
  batch (``sink-decode``);
- ``stall`` — a fold consumer blocked on its producer (the per-slot view
  of devtime's ``codec_wait``);
- ``device`` — the lowered sink's batch dispatch (``map-fold``) and wait
  (``drain``); each keyed batch op's device call (``keyed-fnv_lanes``,
  ``keyed-mix_int``, ``keyed-hash_sort``, ``keyed-segment_fold``);
- ``handoff`` — table-program dispatches (``table-probe``) and waits
  (``table-drain``), the sink's host work into the vocabulary
  (``absorb``), degrades, the registration of a job's device refs;
- ``collective`` — the mesh keyed fold, its global sums and the byte
  exchange's windows;
- ``exchange`` — the byte exchange's steps (``h2d``, ``step``, ``d2h``);
- ``hbm`` / ``spill`` / ``spill_queue`` / ``io_wait`` — HBM puts and
  offloads; spill writes (on the writer pool's lanes), a queued write's
  wait, writer backpressure and read waits;
- ``merge`` — merge generations, streamed merge runs, compactions;
- ``retry`` — the JAX package's job retries (none yet: retries are a
  later slice).

Every span carries ``cpu`` in its args: the seconds of its interval its
thread spent on a core (``time.thread_time``, read inside the wall reads,
so it never exceeds ``dur``; two more clock reads a span, while tracing
only); the rest the thread waited, for the interpreter lock, another
lock, a core or the card.  A ``complete`` span whose start was stamped on
another thread carries none.  ``otherData`` adds ``lane_native_tid`` and
``lane_thread_ident``: each ``tid``'s OS thread id
(``threading.get_native_id``) and thread ident (``threading.get_ident``,
the pthread id), so a ``torch.profiler`` trace joins the lane that made
its host-side events (a CUDA-only profiler stamps its runtime events with
the ident's low 32 bits read as a signed int32, in magnitude; one with
CPU activity stamps its CPU ops with the OS thread id); and
``wall_start_err_us``, the width of the narrowest of three
``perf_counter`` brackets around the ``wall_start`` read: how far a span's
wall time (``wall_start`` + ``ts``) may be off.

**stats.json — the summary** (schema ``dampr-tpu-stats/1``), returned
in-memory from every run, traced or not, as ``em.stats()``: per-stage
``records_in/out``, ``bytes_in/out``, spills and merges; the ``devtime``
buckets (:mod:`dampr_tpu_torch.ops.devtime`); ``overlap``, ``io``,
``store``, ``mesh`` (one device: no folds across devices), ``device``
(the port's kernel launches and host phases beside the JAX keys);
``trace_file`` / ``stats_file`` (None untraced).  A traced run adds
``metrics``, ``log``, ``spans`` and ``critpath``; a profiled run
``profile``; a failed one ``crashdump_file``.  ``spans`` gives each
category its ``count``, ``seconds``, ``cpu_seconds`` and self time,
``self_seconds`` and ``self_cpu_seconds``: a span's interval (and cpu)
less what the child spans recorded by the same thread cover (nesting
follows the recording thread, not the lane).  A traced or profiled run
adds ``device.host_phase_cpu_seconds`` (the sink phases' thread CPU,
keyed as ``host_phase_seconds``), ``cpu_seconds`` in each
``device.keyed`` op and in each profiler op.

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

**The live endpoint** (:mod:`.serve`, ``settings.metrics_port``):
``/metrics`` (:mod:`.promtext`) and ``/healthz`` while a run is in
flight; the bound port lands in ``stats()["endpoint"]``.
:mod:`.timeseries` keeps one compact point per served job for trending.

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
