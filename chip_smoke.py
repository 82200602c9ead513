#!/usr/bin/env python3
"""Smoke test of dampr_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--mb 128] [--seed 1234] [--reps 20] [--ooc-mb 128]

Run from the repository root on a machine with an NVIDIA card (Hopper:
the kernels build for sm_90a).  Phases, each of which must pass:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main path from ``dampr_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and report the build time;
3. K1 (FNV) against its plain torch version, bit for bit, in both its
   entries (the hash lanes, and the sort keys with and without lines) at
   the main path's shapes ([2^18, 16], [2^18, 32], the corpus batch) and
   on ragged lengths, high bytes, empty rows and unaligned bases;
4. K2 (segmented fold) against its plain torch version, bit for bit, in
   both its entries (``segfold_sorted``'s contract, and the token fold's
   gather entry with and without dedup) at N = 2^18, ragged N, tile edges
   (512k - 1, 512k, 512k + 1), one segment over every tile of N = 2^22,
   an all-invalid tail, single-element segments and rows that collide
   (at L = 8, 13 and 16); every case runs 100 times, since a look-back
   race would show only sometimes;
5. ``token_fold`` with the kernels against ``token_fold`` with the plain
   versions: all six outputs equal, with and without per-line dedup (the
   corpus batch built as the sink builds it: compact upload, row builder);
   the row builder (``csrc/fnv.cu``'s ``dampr_rows``) against its plain
   version, bit for bit, at 2^18 rows with L = 32 and 256, with and
   without lines, and timed there (the ``rows at`` lines; the kernels
   line's ``rows`` entry);
   then the handoff's table program (``csrc/handoff.cu``, B4) against its
   plain version, bit for bit (``acc``, ``miss``, ``n_miss``), in its three
   variants (+1 a hit; per-line dedup through the 16-token window and
   through the sort), each case 20 times: the corpus batch against the
   corpus's own vocabulary, random batches of 2^18 rows at L = 8, 16 and
   256, duplicate h1 lanes, h1 collisions with other bytes, Lcap > L and
   Lcap < L, an empty table and an all-miss batch;
6. times of each kernel, its plain version and the program at the main
   path's batch (the corpus batch, N = 2^18, L = 8) and at N = 2^22:
   ``ms`` per call, wrapper included (CUDA events around one call);
   ``device_ms``, the card's time alone (the stream sleeps while the host
   queues the calls, then events time them back to back; the profiler's
   kernel time beside it where it shows one); ``host_ms``, the host's
   cost to queue one call; each beside the least time the card could
   take (bytes over 3.35 TB/s, operations over the peak rate);
7. the main path end to end on a ``--mb`` corpus made from ``--seed``
   (the TF-IDF benchmark's generator): DocFreq and TokenCounts through
   ``Dampr.text(...).custom_mapper(...).fold_values(operator.add)``, held
   exactly against a pure-Python Counter oracle, plus a ``sink_tsv``
   readback; launch counters are zeroed just before and read just after,
   and every kernel must have launched;
8. ``tfidf``: the TF-IDF benchmark's pipeline verbatim
   (``bench_tfidf.py:135-147``: DocFreq -> ``fold_values`` ->
   ``cross_right(docs.len(), idf, memory=True)`` -> ``sink_tsv``) on the
   same corpus, every sink line byte-equal to
   ``"{w}\t{df}\t{log(1 + lines / df)}"`` from the oracle; the DocFreq
   stage must lower, both kernels must launch in this run, and DocFreq
   and ``len()`` must share one window pass over every chunk of the
   corpus (one scan-shared group of two stages, every chunk windowed);
   then ``handoff``: the same pipeline with ``settings.handoff`` "off" and
   "auto", one ``handoff`` JSON line each (seconds, the sink's host phase
   seconds, copies, the handoff's counters, table and classic batches and
   misses, device folds, launches in all and in the reduce stages), both
   equal to the oracle and each other, the auto run with a device edge,
   table batches, the table program launched and the fold reading device
   refs; DocFreq under a 16 KiB device budget (it must degrade, exactly);
   and a DocFreq run made to fail mid-map after a job registered its
   device refs (every store must end with no device bytes charged, and
   ``torch.cuda.memory_allocated()`` no higher than before the run); and
   one finalized ref offloaded (the card must get back its lanes' bytes);
   then ``obs``: (a) the same pipeline untraced, then with
   ``settings.trace`` and ``settings.profile`` on: sink lines equal the
   oracle, copies and every kernel's launches equal in the two runs;
   ``trace.json`` passes ``tools/validate_trace.py`` with the span
   categories ``stage,job,codec,fold,device,handoff`` and the counter
   series ``store.resident_bytes,store.hbm_bytes``; ``stats.json`` equals
   ``em.stats()``; the critical path names a run verdict; the DocFreq
   stage's profile has device sub-phases (one ``obs`` line: both walls,
   their ratio, the devtime buckets, the stall fraction); (b) the traced
   pipeline under ``settings.profile_dir``: from ``torch.profiler``'s
   Chrome trace, the card's busy share (the union of kernel and copy
   intervals over the run's wall window), the top 5 device operations and
   the 5 longest idle gaps with the port's host spans inside each (both
   clocks mapped to the wall clock: ``card_timeline``), and the
   profiler's K1/K2/B4 kernels, with its launch calls whose kernel record
   kineto dropped, accounting for the launch counters; (c) a traced
   DocFreq run failed mid-map as above leaves a ``crashdump.json`` that
   validates, and ``memory_allocated()`` reads the same before and after;
9. ``joins``: (a) the TokenCounts and DocFreq fold outputs of the corpus,
   each filtered by its count, joined by word (inner, left, outer) against
   a dict oracle; (b) 2^20 and 2^19 seeded integer keys (half shared,
   repeated) grouped into 4 partitions, so each side's GroupedView sorts
   more than 65,536 records on the card, joined three ways against a
   dict oracle, and ``len()`` against ``len(list)``;
10. ``wc``: ``examples/wc.py``'s pipeline (``flat_map(line.split())`` ->
    ``fold_by(word, lambda x, y: x + y, value=1)``) on the same corpus in
    8 chunks, every ``(word, count)`` against a ``split()`` Counter; the
    plan must fuse the chain into one executed map stage, and K1's lanes
    entry (the map-side combine hashes each 65,536-word block on the card)
    must launch in the run; then one chunk's job, phase by phase, on one
    thread (``read_lists``, each op's batch, block building, the key
    encoding, K1 with its copies, the sort, the Python fold);
11. ``word_stats``: ``examples/word_stats.py``'s four outputs in one
    ``Dampr.run`` on a ``--ws-mb`` corpus from the same generator and seed,
    each against values computed from its ``split()`` Counter
    (``top_words``' records that tie on their count compared as
    multisets); its line lists each ``Rekey`` stage's jobs and seconds
    (the tiny-input collapse runs those over ``top_words`` as one job);
    then a run with the collapse off (``runner.SMALL_STAGE_BYTES = 0``),
    its outputs equal, and a ``word_stats-ab`` line with both runs'
    seconds and kernel launches, in all and in the reduce stages (the
    tiny folds with the collapse on), counts zeroed before each run;
12. ``ooc``, the out-of-core tier, four runs, each printing an ``ooc`` JSON
    line (budget, partitions, chunk, seconds, MB/s, spills, the ``io``
    section, merge generations, streamed reduces, kernel launches):
    ``ooc-sort``, ``benchmarks/sort_bench.py``'s external sort
    (``ParseNumbers`` -> ``checkpoint(force=True)`` -> ``read()``) of
    ``--ooc-mb`` MiB of random int64 lines (its generator, seed 7) under a
    quarter of that as the budget, once in 8 chunks (8 sorted runs, no
    merge generation) and once in 32 chunks with ``merge_fanin = 4``
    (merge generations), each against ``np.sort`` of the keys written;
    ``ooc-fold``, ``fold_by(line, 1, add)`` over the first eighth of those
    lines (nearly every line distinct) in 8 partitions under a 32nd as the
    budget, against a Counter; ``ooc-join``, inner and left joins of that
    fold against the lines of the first 32nd, a streaming merge join on
    both sides, against dict joins; ``ooc-tfidf``, the ``tfidf`` phase's
    pipeline with the DocFreq map output spilling and every fold partition
    over the streaming threshold, its sink lines equal to the ``tfidf``
    phase's and the oracle's (``settings.handoff`` "off" there: the run
    measures the spill path, which the handoff would bypass);
13. ``ingest``, compressed taps, two ``ingest`` JSON lines: (a) the
    ``tfidf`` pipeline over a BGZF copy of the corpus that the script
    writes (65,280-byte members with the htslib ``BC`` subfield, lines
    crossing member boundaries, and the EOF member) in 8 member-aligned
    chunks, lowering on; its sink lines must equal the ``tfidf``
    phase's and the oracle's, K1 and K2 must launch, DocFreq and
    ``len()`` must form one scan-shared group over every chunk (a BGZF
    chunk streams no bytes, so its members share one read of the
    inflated chunk rather than one window pass; the line reports the
    group's ``windowed`` count), and
    the overlap executor's peak of bytes in flight must be above 0 and
    within the memory budget, with none left at the end; (b) DocFreq over
    a plain (one-member) gzip of the corpus's first 16 MB, read as one
    chunk, against the oracle of those lines;
14. ``analyze``, the static analyzer and the certified lane chain (B11):
    (a) 2^22 seeded int64 values in [-2^40, 2^40) through ``map(x * 3 +
    1) . filter(x % 2 == 0) . fold_by(x % 4096, add)`` in 8 partitions,
    planned as the JAX package plans it (one certified ``ValueMap .
    Filter . Rekey`` stage on the device, a device sum fold), with the
    analyzer on (the lane program: every batch dispatched to the card and
    verified, none mismatched, each job's first batch diff-checked
    against the per-record chain) and off (the per-record path), both
    equal to a numpy oracle, then traced (the ``numeric-chain`` spans'
    seconds); B11 timed at one 65,536-lane batch; (b) 2^22 seeded float64
    values through ``map(v * 0.5 + 3.0) . filter(v > 10.0)``, on and off,
    exact; (c) ``python -m dampr_tpu_torch.analyze.lint --json`` over a
    module building the port's ``wc``, ``word_stats`` and TF-IDF
    pipelines: no error, no warning, and the report passes
    ``tools/validate_lint.py``.  The ``tfidf`` and ``wc`` runs' plan
    reports carry the analyzer's section, with no error and no warning;
15. ``adapt``, the run-history corpus and the adaptive plan, under a
    scratch root of its own: (a) the ``tfidf`` pipeline three times under
    one run name, ``settings.handoff`` "auto" (an empty corpus), "off",
    "auto": every sink line equal to the oracle, one ``adapt-tfidf`` line
    per run (seconds, the handoff edges with their kind and reason,
    ``device_fraction``, the adaptive and cost sections, the launches),
    the "off" run's ``device_fraction`` above 0, and the third run's edge
    the decision of ``plan.model.price_handoff`` over the two records
    before it (an ``adapt-price`` line), the corpus holding three
    records; (b) DocFreq over the first 16 MB twice under one name,
    ``n_partitions`` not pinned: the second run adapts (``adapt-size``);
    (c) with lowering off, a ``wc``-shaped count
    (``fold_by(word, binop=operator.add, value=1)``: an ``early_fold``
    edge) and an unfused map -> map chain (an impure UDF; sorted runs
    off) over the same 16 MB, each with ``settings.pipeline`` "auto" and
    "off": equal records, equal to a ``split()`` Counter and the line
    lengths, the auto runs' edges executed (``adapt-stream`` lines with
    the folder's fold, overlap and stall seconds); (d) ``explain()`` of
    the TF-IDF and ``wc`` plans under their names launches no kernel and
    leaves the corpora as they were (``adapt-explain``: line counts);
16. ``faults``, faults, retries and resume (:func:`phase_faults`), one
    ``faults`` JSON line a run (seconds, the ``faults`` section, restored
    and persisted stages, checkpoint bytes, copies, launches,
    ``memory_allocated()`` before and after): a retried table-mode job
    (``faults-retry``), absorbed spill I/O faults (``faults-io``), a
    ``resume=True`` run failed after DocFreq's checkpoint and resumed
    twice (``faults-resume-fail``, ``faults-resume``,
    ``faults-resume-again``), ``resume="auto"`` through a transient fault
    (``faults-auto``) and the cost of checkpointing (``faults-cost``),
    every sink line equal to the oracle;
17. ``mesh``, the mesh in one process (:func:`phase_mesh`) on 4 shards
    of the card (``settings.mesh_devices = "cuda:0*4"``): TF-IDF with
    ``mesh_fold = "on"`` (sink lines equal the ``tfidf`` phase's, 4
    devices in ``stats()["mesh"]``, K2 launched in the fold) and at D = 1
    (over every card too where more than one is visible); the keyed fold
    (B7) of the corpus's DocFreq lanes at the default capacity and at
    1/1000 (the retry runs), exact against the D = 1 fold and the
    oracle; a non-associative group_by, an inner and a left join and a
    sort_by over the 16 MB head through the byte exchange (B8), each
    equal to its mesh-off run, once more under a 256 KiB budget; the
    rings (B9) and 20 SGD steps (B10) at D = 4 against plain torch and
    D = 1; one ``mesh-programs`` line (B7-B10 timed, launches, bounds);
18. ``fleet``, the mesh across processes (:func:`phase_fleet`): two rank
    processes on the card, each naming 2 shards of it (a global mesh of
    4), a gloo process group between them, over the 16 MB head: TF-IDF
    through the mesh fold (sink lines equal the one-process run's, K2
    launched on each rank), group_by, the joins and sort_by through the
    byte exchange (also under a 256 KiB budget), a rank killed
    mid-exchange (its peer's watchdog aborts within twice the deadline,
    both crashdumps valid, a ``resume="auto"`` rerun exact), the straggler
    mitigation engaging and disengaging exactly, and rank 0's fleet merge
    naming the straggler; one ``fleet`` JSON line;
19. ``serve``, the serve daemon and the cross-run cache
    (:func:`phase_serve`): ``python -m dampr_tpu_torch.serve.daemon`` as
    its own process (2 worker slots, its own scratch root and cache
    directory), each job in a worker process on the card, one ``serve``
    JSON line per step (walls, the reuse counters, the worker's launches,
    batches and copies, bytes published and mounted): ``serve-cold``
    (tenant A's TF-IDF through ``idf``, read back: equal to the ``tfidf``
    phase and the oracle, K1/K2/B4 launched in the worker, stages
    published), ``serve-hit`` (tenant B's same plan: a hit, no batch, no
    launch), ``serve-coalesce`` (two tenants, one run, one job
    directory), ``serve-concurrent`` (TF-IDF and TokenCounts, cache off,
    alone and at once on two workers), ``serve-incremental`` (8 files,
    then 9: DocFreq incremental, equal to a cold run), ``serve-cancel``
    (exit 143, a valid crashdump, the worker's context gone),
    ``serve-metrics`` and ``serve-overhead`` (the worker's start-up);
    the daemon's pid never holds a CUDA context
    (``nvidia-smi --query-compute-apps``, polled through the phase);
20. ``tooling``, the port's tools (:func:`phase_tooling`): ``python -m
    dampr_tpu_torch.cli bench`` in its own process on the card, traced,
    with autotune on and 3 trials, over the ``--mb`` corpus: its exact
    check against the single-core baseline, a lowered stage and a handoff
    edge, every trial byte-identical, ``tools/check_bench.py`` accepting
    the line, K1, K2 and B4 launched in the winning run; then ``stats
    --series --prom --log``, ``doctor --json`` (schema-valid) and
    ``history`` over those runs, each exit 0, ``sentry --strict`` exiting
    with its verdict (0, or 2 exactly when ``detect`` finds a
    regression); and ``top --once --json`` against a live TF-IDF run's
    metrics endpoint.

K1's lanes entry is also checked and timed at the ``wc`` batch shape (the
corpus's first 65,536 words, padded as the combine pads them).  Every
tolerance is exact: all outputs are integers, bytes or one float
division of equal integers.  The handoff is at its default (``auto``:
on, on the card) in every phase but ``ooc-tfidf`` and the ``handoff``
phase's "off" run.  Prints a
``{"kernels": [...]}`` JSON line second to last (``launches_faults``: the
retried TF-IDF run's; ``launches_serve``: the served cold run's, read
from the worker's ``stats.json``; ``launches_tooling``: the bench's
winning autotune trial's, from its ``stats.json``; ``launches_fleet``:
each rank's in the fleet phase's TF-IDF) and
``{"ok": true, "device": {...}}`` last; exits non-zero, printing no
result, if there is no card or any phase fails.
"""

import argparse
import collections
import json
import math
import operator
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
#: the non-tensor-core 32-bit vector rate, used for 32-bit integer ops.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

LOWER_BATCH = 1 << 18


def log(msg):
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def bound_ms(nbytes, nops):
    tb = nbytes / PEAK_BYTES_PER_S
    to = nops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(torch, fn, reps):
    """Median CUDA-event time of ``fn()`` over ``reps`` warm runs, each
    timed alone: the wrapper's host work before the launch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_split(torch, fn, reps):
    """``(device_ms, host_ms)`` per call of ``fn``.  The stream first
    sleeps (``torch.cuda._sleep``) long enough for the host to queue all
    ``reps`` calls behind it; events around those calls then time the
    card alone, and the host clock around the queueing (no synchronise
    inside) times the host alone.  A window counts only if the sleep
    outlasted the queueing, so the card never waited on the host inside
    it.  Otherwise either the sleep was short or the CUDA launch queue
    filled (a call of many launches) and the host waited on the card: the
    next try sleeps twice as long over half the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 50 * 1000 * 1000
    for _ in range(6):
        before = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        slept = before.elapsed_time(start)
        if slept > host_ms:
            return start.elapsed_time(end) / reps, host_ms / reps
        cycles *= 2
        reps = max(1, reps // 2)
    raise PhaseFailed("the stream woke before the host had queued the "
                      "timed calls")


def profiled_ms(torch, fn, reps, pattern):
    """Device time per call of the kernels whose name matches ``pattern``,
    from ``torch.profiler``'s ``key_averages()``; None where the profiler
    shows no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except RuntimeError as e:
        log("profiler unavailable: {}".format(e))
        return None
    total = 0.0
    for row in rows:
        if re.search(pattern, row.key):
            total += (getattr(row, "device_time_total", None)
                      or getattr(row, "cuda_time_total", 0.0))
    return total / 1e3 / reps if total > 0 else None


def timing(torch, fn, reps, pattern=None, launches=1):
    """Every time this script reports for one callable of about
    ``launches`` kernel launches a call (the queued window holds about
    500 launches, well inside the CUDA launch queue)."""
    out = {"ms": time_ms(torch, fn, reps)}
    out["device_ms"], out["host_ms"] = time_split(
        torch, fn, max(2, min(5 * reps, 500 // launches)))
    if pattern is not None:
        out["profiler_ms"] = profiled_ms(torch, fn, reps, pattern)
    return out


def make_corpus(path, mb, seed):
    """The TF-IDF benchmark's corpus generator (Zipf-ish text over a
    24k-word vocabulary, 8-12 tokens a line), made from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    vocab_n = 24000
    vocab = np.array(["w%04x" % i if i > 200 else "t%d" % i
                      for i in range(vocab_n)], dtype=object)
    probs = 1.0 / np.arange(1, vocab_n + 1) ** 1.1
    probs /= probs.sum()
    target = mb * 1024 ** 2
    written = 0
    with open(path, "w") as f:
        while written < target:
            ids = rng.choice(vocab_n, size=(20000,), p=probs)
            lens = rng.randint(8, 13, size=2000)
            pos = 0
            out = []
            for L in lens:
                out.append(" ".join(vocab[ids[pos:pos + L]]))
                pos += L
                if pos + 13 > len(ids):
                    break
            chunk = "\n".join(out) + "\n"
            f.write(chunk)
            written += len(chunk)
    return written


def _oracle_range(path, start, stop):
    """:func:`oracle` over the whole lines of bytes ``[start, stop)``."""
    import io

    rx = re.compile(r"[^\w]+")
    tc = collections.Counter()
    df = collections.Counter()
    wc = collections.Counter()
    n_lines = 0
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(stop - start)
    for line in io.StringIO(data.decode("utf-8"), newline=None):
        toks = [t for t in rx.split(line.rstrip("\n").lower()) if t]
        tc.update(toks)
        df.update(set(toks))
        wc.update(line.split())
        n_lines += 1
    return tc, df, n_lines, wc


#: Processes computing one oracle, each over its share of the lines.
ORACLE_WORKERS = 8


def oracle(path):
    """Pure-Python token counts, document frequencies (per line), the line
    count, and the ``split()`` word counts ``examples/wc.py`` computes:
    the lines cut into :data:`ORACLE_WORKERS` ranges at line ends, each
    counted by a fresh interpreter of its own (all started at once; none
    inherits this process's CUDA context), the counts summed."""
    import pickle

    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for i in range(1, ORACLE_WORKERS):
            f.seek(max(cuts[-1], i * size // ORACLE_WORKERS))
            f.readline()
            cuts.append(min(size, f.tell()))
    cuts.append(size)
    spans = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    if len(spans) < 2 or size < (1 << 20):
        return _oracle_range(path, 0, size)
    code = ("import pickle, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; pickle.dump(chip_smoke._oracle_range("
            "sys.argv[2], int(sys.argv[3]), int(sys.argv[4])), "
            "sys.stdout.buffer)")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, here, path, str(a), str(b)],
        stdout=subprocess.PIPE) for a, b in spans]
    parts = []
    for proc in procs:
        out, _err = proc.communicate()
        check(proc.returncode == 0, "an oracle worker failed")
        parts.append(pickle.loads(out))
    tc, df, n_lines, wc = parts[0]
    for ptc, pdf, pn, pwc in parts[1:]:
        tc.update(ptc)
        df.update(pdf)
        wc.update(pwc)
        n_lines += pn
    return tc, df, n_lines, wc


def exact(torch, a, b):
    """(equal, max |a - b|) of two integer/bool tensors."""
    if a.shape != b.shape:
        return False, float("inf")
    if a.numel() == 0:
        return True, 0.0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
    return d == 0, float(d)


def check_fnv(torch, fnv, dev, rng):
    """K1 vs its plain version, in both entries; returns the max abs error
    seen."""
    import numpy as np

    worst = 0.0

    def agree(name, got, want):
        nonlocal worst
        for g, w in zip(got, want):
            ok, err = exact(torch, g, w)
            worst = max(worst, err)
            check(ok, "fnv disagrees with its plain version: " + name)

    def both_entries(name, m, ln):
        agree(name, fnv.fnv(m, ln), fnv.fnv_reference(m, ln))
        agree(name + " (keys)", fnv.fnv_sort_keys(m, ln),
              fnv.fnv_sort_keys_reference(m, ln))
        li = torch.from_numpy(rng.randint(0, 2 ** 31, size=m.shape[0])
                              .astype(np.int32)).to(dev)
        agree(name + " (keys, lines)", fnv.fnv_sort_keys(m, ln, li),
              fnv.fnv_sort_keys_reference(m, ln, li))

    cases = []
    for n, L in ((1 << 18, 8), (1 << 18, 16), (1 << 18, 32)):
        lens = rng.randint(1, L + 1, size=n)
        lens[rng.rand(n) < 0.05] = 0
        cases.append(("random [{}, {}]".format(n, L),
                      rng.randint(0, 256, size=(n, L)), lens))
    cases.append(("high bytes", rng.randint(128, 256, size=(4099, 32)),
                  rng.randint(0, 33, size=4099)))
    cases.append(("empty rows", rng.randint(0, 256, size=(1000, 8)),
                  np.zeros(1000, dtype=np.int64)))
    cases.append(("lens past L and negative",
                  rng.randint(0, 256, size=(777, 24)),
                  rng.randint(-3, 40, size=777)))
    cases.append(("wide rows", rng.randint(0, 256, size=(33, 1024)),
                  rng.randint(0, 1025, size=33)))
    cases.append(("odd width", rng.randint(0, 256, size=(513, 13)),
                  rng.randint(0, 14, size=513)))
    cases.append(("ragged tile [1025, 8]", rng.randint(0, 256, size=(1025, 8)),
                  rng.randint(-1, 10, size=1025)))
    for name, mat, lens in cases:
        m = torch.from_numpy(mat.astype(np.uint8)).to(dev)
        ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
        both_entries(name, m, ln)
    # bases aligned to 8 and to 4 bytes but not 16: narrower loads
    for off, L in ((8, 16), (4, 8), (4, 32)):
        n = 5000
        flat = torch.from_numpy(rng.randint(0, 256, size=n * L + off)
                                .astype(np.uint8)).to(dev)
        m = flat[off:].view(n, L)
        check(m.data_ptr() % 16 == off, "the unaligned case is aligned")
        ln = torch.from_numpy(rng.randint(0, L + 1, size=n)
                              .astype(np.int32)).to(dev)
        both_entries("base aligned to {} at L = {}".format(off, L), m, ln)
    torch.cuda.synchronize()
    return worst


def sorted_case(torch, dev, rng, n, n_keys, n_invalid, max_v=9):
    """Lanes sorted by (inv, h1, h2) as the program produces them."""
    import numpy as np

    kh1 = rng.randint(-2 ** 31, 2 ** 31, size=n_keys).astype(np.int32)
    kh2 = rng.randint(-2 ** 31, 2 ** 31, size=n_keys).astype(np.int32)
    ids = np.sort(rng.randint(0, n_keys, size=n - n_invalid))
    h1 = np.concatenate([kh1[ids], np.zeros(n_invalid, np.int32)])
    h2 = np.concatenate([kh2[ids], np.zeros(n_invalid, np.int32)])
    inv = np.zeros(n, np.int32)
    inv[n - n_invalid:] = 1
    v = rng.randint(0, max_v + 1, size=n).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (h1, h2, v, inv)]


def gather_case(torch, lower, fnv, dev, rng, n, n_keys, L=8, zero_frac=0.05,
                dedup=True, collide=0.0):
    """The gather entry's inputs as token_fold builds them: random rows
    over ``n_keys`` distinct tokens, their sort keys and the sort.  A
    ``collide`` share of the rows then gets one byte changed after the
    hashing, so it differs from rows of the same keys: the collisions a
    real hash collision would give."""
    import numpy as np

    vlens = rng.randint(1, L + 1, size=n_keys).astype(np.int32)
    vocab = (rng.randint(0, 256, size=(n_keys, L))
             * (np.arange(L)[None, :] < vlens[:, None])).astype(np.uint8)
    ids = rng.randint(0, n_keys, size=n)
    lens = vlens[ids]
    lens[rng.rand(n) < zero_frac] = 0
    lines = np.sort(rng.randint(0, max(1, n // 10), size=n)).astype(np.int32)
    rows = vocab[ids]
    m = torch.from_numpy(rows).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    li = torch.from_numpy(lines).to(dev) if dedup else None
    low, high = fnv.fnv_sort_keys(m, ln, li)
    perm, shigh = lower.sort_segments(low, high)
    if collide:
        hit = np.flatnonzero(rng.rand(n) < collide)
        rows[hit, rng.randint(0, L, size=len(hit))] ^= 1
        m = torch.from_numpy(rows).to(dev)
    return perm, shigh, low, m, ln


REPEATS = 100


def check_segfold(torch, lower, fnv, segfold, dev, rng):
    """K2 vs its plain version in both entries, each case REPEATS times."""
    worst = 0.0

    def agree(name, run, want):
        nonlocal worst
        for _ in range(REPEATS):
            got = run()
            for g, w in zip(got, want):
                ok, err = exact(torch, g, w)
                worst = max(worst, err)
                check(ok, "segfold disagrees with its plain version: " + name)

    n = 1 << 18
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    distinct = torch.arange(n, dtype=torch.int32, device=dev)
    big = 1 << 22
    big_ones = torch.ones(big, dtype=torch.int32, device=dev)
    big_zeros = torch.zeros(big, dtype=torch.int32, device=dev)
    tile = segfold._TILE
    cases = [
        ("random N=2^18", sorted_case(torch, dev, rng, n, 20000, 1000)),
        ("ragged N", sorted_case(torch, dev, rng, 100003, 50000, 7)),
        ("one segment over many blocks", [zeros, zeros, ones, zeros]),
        ("one segment over every tile of N=2^22",
         [big_zeros, big_zeros, big_ones, big_zeros]),
        ("all-invalid tail",
         sorted_case(torch, dev, rng, n, 3000, n // 2)),
        ("all invalid", [zeros, zeros, ones, ones]),
        ("single-element segments", [distinct, distinct,
                                     torch.full_like(ones, 3), zeros]),
        ("one record", sorted_case(torch, dev, rng, 1, 1, 0)),
        ("tile edge", sorted_case(torch, dev, rng, 2049, 2049, 0)),
    ]
    for k in (1, 3, 64):
        for m in (tile * k - 1, tile * k, tile * k + 1):
            cases.append(("N = {}".format(m),
                          sorted_case(torch, dev, rng, m, max(1, m // 50),
                                      m // 7)))
    for name, lanes in cases:
        agree(name, lambda: segfold.segfold(*lanes),
              segfold.segfold_reference_torch(*lanes))
    tot, live = segfold.segfold(big_zeros, big_zeros, big_ones, big_zeros)
    check(int(live.sum()) == 1 and int(tot[-1]) == big,
          "one giant segment must total N at its single end")

    gcases = [("corpus-like N=2^18", n, 20000, 0.05, 8, 0.0),
              ("N=2^22", big, 50000, 0.05, 8, 0.0),
              ("one token over every tile of N=2^22", big, 1, 0.0, 8, 0.0),
              ("ragged N", 100003, 3000, 0.3, 8, 0.0),
              ("tile edge - 1", tile * 3 - 1, 40, 0.5, 8, 0.0),
              ("tile edge + 1", tile * 3 + 1, 40, 0.5, 8, 0.0),
              ("all invalid", 5000, 10, 1.0, 8, 0.0),
              ("collisions", n, 20000, 0.05, 8, 0.01),
              ("collisions, odd width", 30011, 500, 0.1, 13, 0.02),
              ("collisions in one segment over every tile", big, 1, 0.0, 16,
               0.001)]
    for name, m, keys, zero_frac, L, collide in gcases:
        for dedup in (True, False):
            args = gather_case(torch, lower, fnv, dev, rng, m, keys, L=L,
                               zero_frac=zero_frac, dedup=dedup,
                               collide=collide)
            want = segfold.segfold_gather_reference(*args, dedup)
            check((int(want[5]) > 0) == (collide > 0),
                  "the gather case {} has the wrong collisions".format(name))
            agree("gather {} (dedup={})".format(name, dedup),
                  lambda: segfold.segfold_gather(*args, dedup), want)
    torch.cuda.synchronize()
    return worst


def corpus_batch(torch, path, dev, dedup):
    """The first program batch of the corpus, padded exactly as the
    device sink pads it (N = 2^18 rows): its compact upload, the row
    builder on the card."""
    import numpy as np

    from dampr_tpu_torch.ops import lower as L
    from dampr_tpu_torch.ops.text import _LOWER

    with open(path, "rb") as f:
        data = f.read(8 * 1024 ** 2)
    data = data[:data.rfind(b"\n") + 1]
    buf = _LOWER[np.frombuffer(data, dtype=np.uint8)]
    starts, lens, lines, _long = L.scan_lanes(buf, "word", True,
                                              L.scan_slices(buf))
    bounds = L._batch_bounds(lines, len(starts), LOWER_BATCH)
    a, b = bounds[0]
    sink = L.DeviceTokenFoldSink({"mode": "word", "lower": True,
                                  "dedup": dedup, "pair_values": False},
                                 device=dev)
    mat, ln, li = sink._pad_batch(buf, starts[a:b], lens[a:b],
                                  lines[a:b] if dedup else None)
    sink._wait_inflight()  # built on the sink's stream
    return mat, ln, li, b - a


def check_token_fold(torch, lower, fnv, segfold, batches):
    for dedup, (mat, lens, lines, _n) in batches.items():
        got = lower.token_fold(mat, lens, lines, dedup)
        want = lower.token_fold(mat, lens, lines, dedup,
                                hash_fn=fnv.fnv_sort_keys_reference,
                                fold_fn=segfold.segfold_gather_reference)
        names = ("sh1", "sh2", "tot", "live", "rep_orig", "collisions")
        for name, g, w in zip(names, got, want):
            ok, _ = exact(torch, g, w)
            check(ok, "token_fold output {} differs between the kernels "
                      "and the plain versions (dedup={})".format(name,
                                                                 dedup))
        check(int(got[5]) == 0, "unexpected collision in the corpus batch")
    torch.cuda.synchronize()


#: Kernel names (regular expressions) in the profiler's table.
K1_NAMES = r"fnv_(tile|rows)"
K2_NAMES = r"segscan"
ROWS_NAMES = r"build_rows"

#: The row builder's widths: the benchmark corpus's bucket and the widest.
ROWS_WIDTHS = (32, 256)


def rows_upload(torch, dev, rng, n, L):
    """A compact upload of ``n`` tokens of 1..L random bytes, a separator
    after each, nine to a line: ``(span, offs, lens, lines)`` on ``dev``
    and the bytes the row builder moves for it into ``LOWER_BATCH``
    rows."""
    import numpy as np

    lens = rng.randint(1, L + 1, size=n).astype(np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    offs[1:] = np.cumsum(lens.astype(np.int64) + 1)[:-1]
    span = rng.randint(0, 256, size=int(offs[-1]) + int(lens[-1])).astype(
        np.uint8)
    lines = (np.arange(n) // 9).astype(np.int32)
    moved = span.nbytes + 9 * n + LOWER_BATCH * (L + 8)
    return [torch.from_numpy(x).to(dev) for x in (
        span, offs.astype(np.int32), lens, lines)], moved


def check_rows(torch, fnv, dev, rng):
    """The row builder (``csrc/fnv.cu``'s ``dampr_rows``) against its
    plain version at the main path's batch, 2^18 rows (1,000 of them pad
    rows), at each of :data:`ROWS_WIDTHS`, with lines and without: bit
    for bit.  Returns each width's upload."""
    uploads = {}
    for L in ROWS_WIDTHS:
        (span, offs, lens, lines), moved = rows_upload(
            torch, dev, rng, LOWER_BATCH - 1000, L)
        for li in (lines, None):
            got = fnv.build_rows(span, offs, lens, li, LOWER_BATCH, L)
            want = fnv.build_rows_reference(span, offs, lens, li,
                                            LOWER_BATCH, L)
            for name, g, w in zip(("mat", "lens", "lines"), got, want):
                ok, _ = exact(torch, g, w)
                check(ok, "row builder {} differs from the plain version "
                          "(L={}, lines={})".format(name, L,
                                                     li is not None))
        uploads[L] = ((span, offs, lens, lines), moved)
    torch.cuda.synchronize()
    return uploads


def random_batch(torch, dev, rng, n, L):
    """A token batch like the corpus's at another size: tokens of 1..L
    bytes from a 24,000-token Zipf vocabulary, ten to a line."""
    import numpy as np

    vocab_n = 24000
    vocab = rng.randint(97, 123, size=(vocab_n, L)).astype(np.uint8)
    vlens = rng.randint(1, L + 1, size=vocab_n).astype(np.int32)
    probs = 1.0 / np.arange(1, vocab_n + 1) ** 1.1
    ids = rng.choice(vocab_n, size=n, p=probs / probs.sum())
    mat = vocab[ids] * (np.arange(L)[None, :] < vlens[ids][:, None])
    lines = (np.arange(n) // 10).astype(np.int32)
    return (torch.from_numpy(mat.astype(np.uint8)).to(dev),
            torch.from_numpy(vlens[ids]).to(dev),
            torch.from_numpy(lines).to(dev))


def run_pipeline(Dampr, scanner, path, chunk):
    em = (Dampr.text(path, chunk).custom_mapper(scanner)
          .fold_values(operator.add).run(name="chip-smoke"))
    return em


def stage_seconds(stats):
    return [(s["kind"], s["op"], s["seconds"]) for s in stats["stages"]]


def part_lines(d):
    out = []
    for part in sorted(os.listdir(d)):
        with open(os.path.join(d, part)) as f:
            out.extend(f.read().splitlines())
    return sorted(out)


def tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir):
    """``bench_tfidf.py:135-147``: DocFreq -> ``fold_values`` ->
    ``cross_right(docs.len(), idf, memory=True)`` -> ``sink_tsv``."""
    docs = Dampr.text(corpus, chunk)
    doc_freq = (docs.custom_mapper(
        DocFreq(mode="word", lower=True, pair_values=False))
        .fold_values(operator.add))
    idf = doc_freq.cross_right(
        docs.len(),
        lambda df, total: (df[0], df[1],
                           math.log(1 + (float(total) / df[1]))),
        memory=True)
    return idf.sink_tsv(out_dir)


def tfidf_oracle_lines(df, n_lines):
    return sorted("{}\t{}\t{}".format(w, c, math.log(1 + float(n_lines) / c))
                  for w, c in df.items())


def phase_tfidf(Dampr, DocFreq, kernels, corpus, chunk, nbytes, df, n_lines,
                out_dir):
    """The TF-IDF benchmark's pipeline (``bench_tfidf.py:135-147``) on the
    port, every sink line held against the oracle; kernel counters are
    zeroed just before the run and read just after."""
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
        name="chip-tfidf")
    secs = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in kernels.items()}
    stats = em.stats()
    dstat = stats["device"]
    got = part_lines(out_dir)
    want = tfidf_oracle_lines(df, n_lines)
    check(got == want, "TF-IDF sink lines differ from the oracle "
                       "({} lines against {})".format(len(got), len(want)))
    check(dstat["device_stages"] >= 1, "TF-IDF: no stage lowered")
    for name, count in launches.items():
        check(count > 0, "kernel {} never launched in the TF-IDF run"
              .format(name))
    groups = stats["scan_sharing"]["groups"]
    check(len(groups) == 1 and len(groups[0]["stages"]) == 2
          and groups[0]["windowed"] == groups[0]["chunks"],
          "TF-IDF: DocFreq and len() did not share one window pass: {}"
          .format(groups))
    check_analysis_clean("TF-IDF", stats)
    run = {"pipeline": "tfidf", "seconds": secs,
           "mb_per_s": nbytes / 1e6 / secs, "lines": n_lines,
           "sink_lines": len(got),
           "device_stages": dstat["device_stages"],
           "device_fraction": dstat["device_fraction"],
           "host_phase_seconds": dstat["host_phase_seconds"],
           "combine_seconds": stats["combine_seconds"],
           "stage_seconds": stage_seconds(stats),
           "batches": dstat["batches"], "fallbacks": dstat["fallbacks"],
           "h2d_bytes": dstat["h2d_bytes"], "d2h_bytes": dstat["d2h_bytes"],
           "scan_sharing": groups,
           "overlap_peak_bytes": stats["io"]["overlap_peak_bytes"],
           "budget_bytes": stats["io"]["budget_bytes"],
           "analysis": stats["plan"]["analysis"]["counts"],
           "kernels": launches}
    log("e2e " + json.dumps(run))
    return launches


def check_analysis_clean(what, stats):
    """The plan report's ``analysis`` section of a main-path run: the
    analyzer was on (the default) and found no error and no warning."""
    sec = stats["plan"]["analysis"]
    check(sec["enabled"] and sec["stages"]
          and sec["counts"]["error"] == 0 and sec["counts"]["warn"] == 0,
          "{}: the analysis section is off or not clean: {}".format(
              what, sec["diagnostics"] if sec["enabled"] else sec))


def _join_keys(left, right, how):
    """The keys an ``how`` join of two dicts' keys reads back, sorted."""
    keys = set(left) & set(right)
    if how != "inner":
        keys |= set(left)
    if how == "outer":
        keys |= set(right)
    return sorted(keys)


def _run_joins(Dampr, left, right, joiner, **run_args):
    """Inner, left and outer joins of two grouped collections in one run;
    returns ({how: records}, seconds, the run's stats)."""
    j = left.join(right)
    t0 = time.perf_counter()
    ems = Dampr.run(j.reduce(joiner), j.left_reduce(joiner),
                    j.outer_reduce(joiner), **run_args)
    out = {how: em.read() for how, em in zip(("inner", "left", "outer"),
                                              ems)}
    secs = time.perf_counter() - t0
    stats = ems[0].stats()
    for em in ems:
        em.delete()
    return out, secs, stats


def phase_joins(Dampr, Map, DocFreq, TokenCounts, corpus, chunk, tc, df,
                seed):
    """Keyed joins: words of the corpus, then seeded integer keys at a
    size whose grouped views sort on the card."""
    import numpy as np

    # (a) the two fold outputs of the corpus, each filtered by its count
    def fold(scanner):
        return (Dampr.text(corpus, chunk).custom_mapper(scanner)
                .fold_values(operator.add))

    left = fold(TokenCounts(mode="word", lower=True, pair_values=False)) \
        .custom_mapper(Map(lambda k, v: [(k, v)] if v[1] % 2 == 0 else []))
    right = fold(DocFreq(mode="word", lower=True, pair_values=False)) \
        .custom_mapper(Map(lambda k, v: [(k, v)] if v[1] % 3 else []))
    out, secs, stats = _run_joins(
        Dampr, left, right,
        lambda l, r: ([v[1] for v in l], [v[1] for v in r]))
    lw = {w: [c] for w, c in tc.items() if c % 2 == 0}
    rw = {w: [c] for w, c in df.items() if c % 3}
    for how, got in out.items():
        want = [(w, (lw.get(w, []), rw.get(w, [])))
                for w in _join_keys(lw, rw, how)]
        check(got == want,
              "word {} join differs from the dict oracle".format(how))
    log("joins-words " + json.dumps({
        "seconds": secs, "left_keys": len(lw), "right_keys": len(rw),
        "records": {h: len(v) for h, v in out.items()},
        "stage_seconds": stage_seconds(stats)}))

    # (b) integer keys: half of each side's distinct keys shared, drawn
    # with repeats; 4 partitions put over 65,536 records in every view
    rng = np.random.RandomState(seed)
    n_left, n_right = 1 << 20, 1 << 19
    pool = rng.permutation(1 << 24)[:3 << 18].astype(np.int64) - (1 << 23)
    shared, l_only, r_only = np.split(pool, 3)
    lkeys = rng.choice(np.concatenate([shared, l_only]), n_left).tolist()
    rkeys = rng.choice(np.concatenate([shared, r_only]), n_right).tolist()
    lmem = Dampr.memory(lkeys)
    t0 = time.perf_counter()
    out, secs, stats = _run_joins(
        Dampr, lmem.group_by(lambda x: x),
        Dampr.memory(rkeys).group_by(lambda x: x),
        lambda l, r: (sum(1 for _ in l), sum(1 for _ in r)), n_partitions=4)
    cl = collections.Counter(lkeys)
    cr = collections.Counter(rkeys)
    for how, got in out.items():
        want = [(k, (cl.get(k, 0), cr.get(k, 0)))
                for k in _join_keys(cl, cr, how)]
        check(got == want,
              "integer {} join differs from the dict oracle".format(how))
    t1 = time.perf_counter()
    n = lmem.len().read()
    len_secs = time.perf_counter() - t1
    check(n == [n_left], "len() {} != {}".format(n, n_left))
    log("joins-ints " + json.dumps({
        "seconds": secs, "len_seconds": len_secs,
        "left_records": n_left, "right_records": n_right,
        "left_keys": len(cl), "right_keys": len(cr),
        "shared_keys": len(set(cl) & set(cr)), "partitions": 4,
        "records": {h: len(v) for h, v in out.items()},
        "stage_seconds": stage_seconds(stats),
        "phase_seconds": time.perf_counter() - t0}))


def wc_pipeline(Dampr, path, chunk_size):
    """``examples/wc.py``'s ``build()``, verbatim but for the chunk size."""
    return (Dampr.text(path, chunk_size=chunk_size)
            .flat_map(lambda line: line.split())
            .fold_by(lambda w: w, binop=lambda x, y: x + y,
                     value=lambda w: 1))


def word_stats_pipelines(Dampr, fname, chunk_size):
    """``examples/word_stats.py``'s ``build()``, verbatim but for the chunk
    size."""
    words = Dampr.text(fname, chunk_size).flat_map(lambda line: line.split())

    top_words = (words.count(lambda x: x)
                 .sort_by(lambda word_count: -word_count[1]))

    total_count = top_words.fold_by(
        key=lambda word: 1,
        value=lambda x: x[1],
        binop=lambda x, y: x + y)

    word_lengths = (top_words
                    .fold_by(lambda tc: len(tc[0]),
                             value=lambda tc: tc[1],
                             binop=lambda x, y: x + y)
                    .sort_by(lambda cl: cl[0]))

    avg_word_lengths = (word_lengths
                        .map(lambda wl: wl[0] * wl[1])
                        .a_group_by(lambda x: 1)
                        .sum()
                        .join(total_count)
                        .reduce(lambda awl, tc:
                                next(awl)[1] / float(next(tc)[1])))

    return total_count, top_words, word_lengths, avg_word_lengths


def run_line(stats, secs, nbytes, launches):
    """The e2e-style JSON fields of one pipeline run."""
    dstat = stats["device"]
    plan = stats["plan"]
    return {"seconds": secs, "mb_per_s": nbytes / 1e6 / secs,
            "stage_seconds": stage_seconds(stats),
            "combine_seconds": stats["combine_seconds"],
            "kernels": launches, "keyed": dstat["keyed"],
            "h2d_bytes": dstat["h2d_bytes"], "d2h_bytes": dstat["d2h_bytes"],
            "stages_before": plan["stages_before"],
            "stages_after": plan["stages_after"], "rules": plan["rules"],
            "device_stages": dstat["device_stages"]}


def phase_wc(Dampr, kernels, corpus, chunk, nbytes, wc):
    """``examples/wc.py`` on the port against the ``split()`` Counter;
    kernel counters are zeroed just before the run and read just after."""
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    em = wc_pipeline(Dampr, corpus, chunk).run(name="chip-wc")
    got = em.read()
    secs = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in kernels.items()}
    stats = em.stats()
    em.delete()
    check(got == sorted(wc.items()),
          "wc differs from the split() Counter ({} words against {})"
          .format(len(got), len(wc)))
    check(launches["fnv"] > 0, "K1 never launched in the wc run")
    check(stats["device"]["h2d_bytes"] > 0
          and stats["device"]["d2h_bytes"] > 0,
          "the wc run counted no copies: {}".format(stats["device"]))
    maps = [s for s in stats["stages"] if s["kind"] == "map"]
    check(len(maps) == 1 and maps[0]["op"] == "FlatMap . Rekey",
          "wc's record chain did not fuse into one map stage: {}".format(
              stage_seconds(stats)))
    check(stats["plan"]["rules"]["fuse_maps"] == 1
          and stats["plan"]["rules"]["hoist_combiners"] == 1,
          "wc's plan fired {}".format(stats["plan"]["rules"]))
    check_analysis_clean("wc", stats)
    run = dict(run_line(stats, secs, nbytes, launches), pipeline="wc",
               words=sum(wc.values()), distinct=len(wc))
    log("e2e " + json.dumps(run))
    return launches


def wc_breakdown(corpus, chunk):
    """One wc job over the corpus's first chunk on this thread, run as the
    runner's batched path runs it (``_record_batches`` into
    ``_run_record_chain``: survivors coalesce into full blocks and the
    FlatMap takes its input in adaptive slices; the map-side combine folds
    each block and merges its partials every ``_PARTIAL_FANIN`` blocks
    and at the end), timed phase by phase: ``read_lists``, the FlatMap
    and Rekey batches, block building (coalescing and
    ``Block.from_lists``), then in the combine the key hashing (the key
    encoding and K1 with its copies for blocks that reach
    ``use_device_for``, the host FNV for the smaller ones, each with its
    block count), the stable sort and grouping, and the fold."""
    from dampr_tpu_torch import runner, settings
    from dampr_tpu_torch.base import FlatMap, Rekey
    from dampr_tpu_torch.blocks import Block
    from dampr_tpu_torch.dataset import TextLineDataset
    from dampr_tpu_torch.ops import hashing, segment

    B = settings.batch_size
    op = segment.as_assoc_op(lambda x, y: x + y)
    t = dict.fromkeys(("read_lists", "flat_map", "rekey", "build_blocks",
                       "encode", "k1_with_copies", "host_hash",
                       "sort_and_group", "fold"), 0.0)
    n = {"words": 0, "blocks": 0, "k1_blocks": 0, "host_hash_blocks": 0,
         "merges": 0}
    combine = [0.0]

    def timed(name, fn, when=lambda *a: True):
        def call(*a):
            if not when(*a):
                return fn(*a)
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                t[name] += time.perf_counter() - t0
        return call

    flat = FlatMap(lambda line: line.split())
    rekey = Rekey(lambda w: w, lambda w: 1)
    # instance attributes: the chain still sees a FlatMap and slices it
    flat.apply_batch = timed("flat_map", flat.apply_batch)
    rekey.apply_batch = timed("rekey", rekey.apply_batch)

    def fold(blk):
        t0 = time.perf_counter()
        if blk.h1 is None:
            on_card = settings.use_device_for(len(blk))
            blk.hashes()
            dt = time.perf_counter() - t0
            if on_card:
                n["k1_blocks"] += 1
                t["encode"] += dt  # K1's share comes off below
            else:
                n["host_hash_blocks"] += 1
                t["host_hash"] += dt
        t1 = time.perf_counter()
        groups = segment.sort_and_group(blk)
        t2 = time.perf_counter()
        out = segment.fold_sorted(groups, op)
        t3 = time.perf_counter()
        t["sort_and_group"] += t2 - t1
        t["fold"] += t3 - t2
        combine[0] += t3 - t0
        return out

    partials = []

    def push(blk):
        n["words"] += len(blk)
        n["blocks"] += 1
        partials.append(fold(blk))
        if len(partials) >= runner._PARTIAL_FANIN:
            merged = fold(Block.concat(partials))
            del partials[:]
            partials.append(merged)
            n["merges"] += 1

    orig_fnv = hashing._fnv
    hashing._fnv = timed("k1_with_copies", orig_fnv,
                         lambda mat, lens: settings.use_device_for(len(mat)))
    try:
        t0 = time.perf_counter()
        batches = list(runner._record_batches(
            TextLineDataset(corpus, 0, chunk), B))
        t1 = time.perf_counter()
        runner._run_record_chain([flat, rekey], iter(batches), B, push)
        t2 = time.perf_counter()
        in_chain = combine[0]
        fold(Block.concat(partials))
    finally:
        hashing._fnv = orig_fnv
    t["read_lists"] = t1 - t0
    t["build_blocks"] = t2 - t1 - t["flat_map"] - t["rekey"] - in_chain
    t["encode"] -= t["k1_with_copies"]
    return dict(n, chunk_bytes=chunk, seconds=t,
                total_seconds=sum(t.values()))


def word_stats_run(Dampr, corpus, chunk):
    """One run of the four ``word_stats`` outputs: (outputs, seconds,
    stats, the ``Rekey`` stages' [stage, jobs, seconds])."""
    t0 = time.perf_counter()
    ems = Dampr.run(*word_stats_pipelines(Dampr, corpus, chunk),
                    name="chip-word-stats")
    outs = [em.read() for em in ems]
    secs = time.perf_counter() - t0
    stats = ems[0].stats()
    for em in ems:
        em.delete()
    # ``sort_by`` and the ``fold_by`` stages over ``top_words``: the
    # tiny-input collapse runs each as one job
    rekeys = [[s["stage"], s["jobs"], s["seconds"]] for s in stats["stages"]
              if s["kind"] == "map" and s["op"] == "Rekey"]
    return outs, secs, stats, rekeys


def reduce_launches(stats):
    """Each kernel's launches in a run's reduce stages, summed."""
    out = collections.Counter()
    for s in stats["stages"]:
        if s["kind"] == "reduce":
            out.update(s["launches"])
    return dict(out)


def phase_word_stats(Dampr, runner, kernels, corpus, chunk, nbytes, wc):
    """``examples/word_stats.py``'s four outputs in one run against values
    computed from the corpus's ``split()`` Counter; then once more with
    the tiny-stage collapse off (``runner.SMALL_STAGE_BYTES = 0``), its
    outputs equal (``top_words``' ties as a multiset: they come in key
    order there), for the ``Rekey`` stages' seconds and both runs' kernel
    launches side by side."""
    zero_launches(kernels)
    outs, secs, stats, rekeys = word_stats_run(Dampr, corpus, chunk)
    launches = read_launches(kernels)
    tc, tw, wl, awl = outs
    total = sum(wc.values())
    check(tc == [(1, total)], "total_count {} != {}".format(tc, total))
    check([c for _w, c in tw] == sorted(wc.values(), reverse=True)
          and sorted(tw) == sorted(wc.items()),
          "top_words differs from the Counter (ties as multisets)")
    lengths = collections.Counter()
    for w, c in wc.items():
        lengths[len(w)] += c
    check(wl == sorted(lengths.items()), "word_lengths differs")
    want_avg = sum(n * c for n, c in lengths.items()) / float(total)
    check(awl == [(1, want_avg)], "avg_word_lengths {} != {}".format(
        awl, want_avg))
    run = dict(run_line(stats, secs, nbytes, launches),
               pipeline="word_stats", corpus_bytes=nbytes,
               rekey_stages=rekeys, tiny_folds=stats["tiny_folds"],
               records={"total_count": len(tc), "top_words": len(tw),
                        "word_lengths": len(wl),
                        "avg_word_lengths": len(awl)})
    log("e2e " + json.dumps(run))
    old = runner.SMALL_STAGE_BYTES
    runner.SMALL_STAGE_BYTES = 0
    try:
        zero_launches(kernels)
        off, off_secs, off_stats, off_rekeys = word_stats_run(
            Dampr, corpus, chunk)
        off_launches = read_launches(kernels)
    finally:
        runner.SMALL_STAGE_BYTES = old
    check(off[0] == tc and sorted(off[1]) == sorted(tw) and off[2] == wl
          and off[3] == awl, "word_stats with the collapse off differs")
    log("word_stats-ab " + json.dumps([
        {"collapse": True, "seconds": secs, "rekey_stages": rekeys,
         "tiny_folds": stats["tiny_folds"], "kernels": launches,
         "reduce_kernels": reduce_launches(stats)},
        {"collapse": False, "seconds": off_secs, "rekey_stages": off_rekeys,
         "tiny_folds": off_stats["tiny_folds"], "kernels": off_launches,
         "reduce_kernels": reduce_launches(off_stats)}]))


def wc_batch(torch, hashing, path, dev):
    """K1's lanes entry's inputs at the wc batch: the corpus's first
    65,536 ``split()`` words, encoded as the map-side combine encodes
    them."""
    import numpy as np

    words = []
    with open(path) as f:
        for line in f:
            words.extend(line.split())
            if len(words) >= 1 << 16:
                break
    mat, lens = hashing.encode_str_keys(words[:1 << 16])
    return (torch.from_numpy(mat).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


#: The sizes of ooc-fold and ooc-join, cut from the suggested ones.
OOC_CUT = ("fold input 1/8 of the records file (suggested 1/4), budget and "
           "join subset 1/32 (suggested 1/16)")


def make_records(path, mb, seed=7):
    """``benchmarks/sort_bench.py::make_records``: blocks of 50,000 random
    int64 keys below 2^62 from ``seed``, one a line, until ``mb`` MiB are
    written.  Returns (bytes written, the keys written)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    target = mb * 1024 ** 2
    written = 0
    keys = []
    with open(path, "w") as f:
        while written < target:
            ks = rng.randint(0, 1 << 62, size=50000)
            chunk = "\n".join(str(k) for k in ks) + "\n"
            f.write(chunk)
            written += len(chunk)
            keys.append(ks)
    return written, np.concatenate(keys)


def head_lines(src, dst, nbytes):
    """The whole lines of ``src``'s first ``nbytes`` bytes into ``dst``;
    returns the bytes written."""
    with open(src, "rb") as f:
        data = f.read(nbytes)
    data = data[:data.rfind(b"\n") + 1]
    with open(dst, "wb") as f:
        f.write(data)
    return len(data)


def zero_launches(kernels):
    for k in kernels.values():
        k.launches = 0


def read_launches(kernels):
    return {k: kern.launches for k, kern in kernels.items()}


def ooc_line(run, stats, secs, nbytes, launches, **extra):
    """The ``ooc`` JSON line of one out-of-core run."""
    line = dict(run=run, seconds=secs, mb_per_s=nbytes / 1e6 / secs,
                input_bytes=nbytes, spill=stats["spill"],
                merge_gens=stats["spill"]["merge_gens"], io=stats["io"],
                streamed_assoc_folds=stats["streamed_assoc_folds"],
                streamed_views=stats["streamed_views"],
                streamed_joins=stats["streamed_joins"],
                stage_seconds=stage_seconds(stats),
                stage_spills=[s["spill_count"] for s in stats["stages"]],
                kernels=launches)
    line.update(extra)
    log("ooc " + json.dumps(line))
    return line


def ascending(keys):
    return all(a < b for a, b in zip(keys, keys[1:]))


def phase_ooc_sort(Dampr, ParseNumbers, settings, kernels, path, nbytes, want,
                   budget, chunk, fanin):
    """One external sort of the records file against ``np.sort`` of the
    keys written, count and order."""
    import numpy as np

    old = settings.merge_fanin
    if fanin is not None:
        settings.merge_fanin = fanin
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = (Dampr.text(path, chunk).custom_mapper(ParseNumbers())
              .checkpoint(force=True)
              .run(name="chip-ooc-sort", memory_budget=budget))
        got = np.fromiter(em.stream(), dtype=np.int64)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        settings.merge_fanin = old
    stats = em.stats()
    runs = em.dataset.pset
    check(got.shape == want.shape and np.array_equal(got, want),
          "ooc-sort: {} records differ from np.sort of the {} written"
          .format(len(got), len(want)))
    check(runs.key_sorted_runs, "ooc-sort: the map did not register sorted "
                                "runs")
    check(stats["spill"]["count"] > 0, "ooc-sort: nothing spilled")
    if fanin is None:
        check(stats["spill"]["merge_gens"] == 0,
              "ooc-sort: a merge generation ran under the default fan-in")
    else:
        check(stats["spill"]["merge_gens"] >= 1,
              "ooc-sort: no merge generation past merge_fanin = {}".format(
                  fanin))
    line = ooc_line("ooc-sort", stats, secs, nbytes, launches,
                    budget=budget, partitions=settings.partitions,
                    chunk=chunk,
                    merge_fanin=fanin or settings.merge_fanin,
                    records=len(got), runs_read=len(list(runs.all_refs())))
    em.delete()
    return line


def fold_lines(Dampr, path, chunk):
    """``fold_by(line, value=1, add)``: a count of each distinct line."""
    return (Dampr.text(path, chunk)
            .fold_by(lambda l: l, value=lambda l: 1, binop=operator.add))


def phase_ooc_fold(Dampr, kernels, path, nbytes, budget, counts):
    zero_launches(kernels)
    t0 = time.perf_counter()
    em = fold_lines(Dampr, path, nbytes // 8 + 1).run(
        name="chip-ooc-fold", n_partitions=8, memory_budget=budget)
    got = em.read()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    stats = em.stats()
    em.delete()
    check(len(got) == len(counts) and ascending([k for k, _c in got])
          and dict(got) == counts,
          "ooc-fold differs from the Counter ({} keys against {})".format(
              len(got), len(counts)))
    check(stats["streamed_assoc_folds"] + stats["streamed_views"] > 0,
          "ooc-fold: no reduce partition streamed")
    check(launches["fnv"] > 0, "ooc-fold: K1 never launched")
    return ooc_line("ooc-fold", stats, secs, nbytes, launches,
                    budget=budget, partitions=8, chunk=nbytes // 8 + 1,
                    threshold=budget, keys=len(got), cut=OOC_CUT)


def phase_ooc_join(Dampr, settings, kernels, path, nbytes, sub_path,
                   sub_bytes, budget, counts, sub_counts):
    """Inner and left joins of the line counts against the lines of the
    subset file, grouped by line, in one run (the fold runs once)."""
    threshold = budget // 4
    old = settings.streaming_reduce_threshold
    settings.streaming_reduce_threshold = threshold
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        right = Dampr.text(sub_path, sub_bytes // 8 + 1).group_by(
            lambda l: l)
        j = fold_lines(Dampr, path, nbytes // 8 + 1).join(right)

        def joiner(left, r):
            return [c for _k, c in left], sum(1 for _ in r)

        ems = Dampr.run(j.reduce(joiner), j.left_reduce(joiner),
                        name="chip-ooc-join", n_partitions=8,
                        memory_budget=budget)
        inner, left = [em.read() for em in ems]
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        settings.streaming_reduce_threshold = old
    stats = ems[0].stats()
    for em in ems:
        em.delete()
    # values read back as (line, (the left values, the right count))
    want_inner = {k: ([c], sub_counts[k]) for k, c in counts.items()
                  if k in sub_counts}
    check(len(inner) == len(want_inner)
          and ascending([k for k, _v in inner])
          and dict(inner) == want_inner,
          "ooc-join inner differs from the dict join")
    check(len(left) == len(counts) and ascending([k for k, _v in left])
          and dict(left) == {k: ([c], sub_counts.get(k, 0))
                             for k, c in counts.items()},
          "ooc-join left differs from the dict join")
    check(stats["streamed_joins"] > 0, "ooc-join: no join partition "
                                       "streamed")
    check(launches["fnv"] > 0, "ooc-join: K1 never launched")
    return ooc_line("ooc-join", stats, secs, nbytes + sub_bytes, launches,
                    budget=budget, partitions=8, chunk=nbytes // 8 + 1,
                    threshold=threshold, inner=len(inner), left=len(left),
                    right_bytes=sub_bytes, cut=OOC_CUT)


def phase_ooc_tfidf(Dampr, DocFreq, settings, kernels, corpus, chunk, nbytes,
                    df, n_lines, out_dir, in_budget_lines):
    """The ``tfidf`` phase's pipeline with the DocFreq map output spilling
    (the budget a quarter of it) and every fold partition over the
    streaming threshold while its folded accumulator is under it: each
    word recurs in all 8 chunks, so a partition holds about 8 records a
    word and the accumulator one (80 bytes a record with a string key)."""
    part_bytes = 8 * len(df) * 80 // settings.partitions
    threshold = 3 * part_bytes // 8
    budget = 8 * len(df) * 80 // 4
    old = settings.streaming_reduce_threshold, settings.handoff
    settings.streaming_reduce_threshold = threshold
    # the spill path is what this run measures: with the handoff on,
    # DocFreq's counts would stay on the card instead
    settings.handoff = "off"
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
            name="chip-ooc-tfidf", memory_budget=budget)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        settings.streaming_reduce_threshold, settings.handoff = old
    stats = em.stats()
    got = part_lines(out_dir)
    check(got == in_budget_lines,
          "ooc-tfidf sink lines differ from the in-budget tfidf run's")
    check(got == tfidf_oracle_lines(df, n_lines),
          "ooc-tfidf sink lines differ from the oracle")
    check(stats["spill"]["count"] > 0, "ooc-tfidf: nothing spilled")
    check(stats["streamed_assoc_folds"] > 0,
          "ooc-tfidf: no fold partition took the streaming fold")
    check(stats["device"]["device_stages"] >= 1, "ooc-tfidf: no stage "
                                                 "lowered")
    for name in ("fnv", "segfold"):
        check(launches[name] > 0, "kernel {} never launched in the "
                                  "ooc-tfidf run".format(name))
    check(launches["handoff"] == 0 and stats["device"]["handoff_bytes"] == 0,
          "ooc-tfidf: the handoff ran with settings.handoff off")
    return ooc_line("ooc-tfidf", stats, secs, nbytes, launches,
                    budget=budget, partitions=settings.partitions,
                    chunk=chunk, threshold=threshold,
                    sink_lines=len(got))


def phase_ooc(Dampr, ParseNumbers, DocFreq, settings, kernels, workdir, mb,
              corpus, chunk, nbytes, df, n_lines, in_budget_lines):
    """The four out-of-core runs; returns each kernel's launches summed
    over them."""
    import numpy as np

    t0 = time.perf_counter()
    records = os.path.join(workdir, "records.txt")
    rec_bytes, keys = make_records(records, mb)
    want = np.sort(keys)
    del keys
    log("phase ooc records: {} bytes, {} keys in {:.3f} s".format(
        rec_bytes, len(want), time.perf_counter() - t0))
    budget = mb * 1024 ** 2 // 4
    lines = []
    for chunk_div, fanin in ((8, None), (32, 4)):
        lines.append(phase_ooc_sort(
            Dampr, ParseNumbers, settings, kernels, records, rec_bytes, want,
            budget, rec_bytes // chunk_div + 1, fanin))
    del want

    t0 = time.perf_counter()
    fold_path = os.path.join(workdir, "records_fold.txt")
    sub_path = os.path.join(workdir, "records_sub.txt")
    # cut to half of the suggested sizes (the fold over a quarter of the
    # records, the budget and the join subset a 16th) to keep the phase
    # near two minutes: both streaming paths are per-record Python
    fold_bytes = head_lines(records, fold_path, mb * 1024 ** 2 // 8)
    sub_bytes = head_lines(records, sub_path, mb * 1024 ** 2 // 32)
    with open(fold_path) as f:
        counts = collections.Counter(f.read().splitlines())
    with open(sub_path) as f:
        sub_counts = collections.Counter(f.read().splitlines())
    log("phase ooc oracle: {} and {} distinct lines in {:.3f} s".format(
        len(counts), len(sub_counts), time.perf_counter() - t0))
    fold_budget = mb * 1024 ** 2 // 32
    lines.append(phase_ooc_fold(Dampr, kernels, fold_path, fold_bytes,
                                fold_budget, counts))
    lines.append(phase_ooc_join(Dampr, settings, kernels, fold_path,
                                fold_bytes, sub_path, sub_bytes, fold_budget,
                                counts, sub_counts))
    lines.append(phase_ooc_tfidf(
        Dampr, DocFreq, settings, kernels, corpus, chunk, nbytes, df, n_lines,
        os.path.join(workdir, "idf_ooc"), in_budget_lines))
    return {k: sum(line["kernels"][k] for line in lines) for k in kernels}


#: Uncompressed bytes per BGZF member: bgzip's block size, which keeps a
#: member's compressed size inside BGZF's 64 KiB limit.
BGZF_BLOCK = 0xff00


def _bgzf_member(payload):
    """One BGZF member: a raw-deflate gzip member carrying the htslib
    ``BC`` extra subfield with its own size less one."""
    import struct
    import zlib

    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = 12 + 6 + len(cdata) + 8
    hdr = struct.pack("<2sBBIBBH2sHH", b"\x1f\x8b", 8, 4, 0, 0, 255, 6,
                      b"BC", 2, bsize - 1)
    return hdr + cdata + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                     len(payload) & 0xFFFFFFFF)


def write_bgzf(src, dst):
    """``src`` as a BGZF file: members of ``BGZF_BLOCK`` bytes each (lines
    cross member boundaries), compressed on a thread pool, then the empty
    EOF member.  Returns the compressed size."""
    from concurrent.futures import ThreadPoolExecutor

    with open(src, "rb") as f:
        data = f.read()
    blocks = [data[at:at + BGZF_BLOCK]
              for at in range(0, len(data), BGZF_BLOCK)]
    with ThreadPoolExecutor(8) as pool, open(dst, "wb") as out:
        for member in pool.map(_bgzf_member, blocks):
            out.write(member)
        out.write(_bgzf_member(b""))
    return os.path.getsize(dst)


def phase_ingest(Dampr, DocFreq, settings, kernels, workdir, corpus, nbytes,
                 df, n_lines, plain_lines):
    """TF-IDF over a BGZF copy of the corpus in 8 member-aligned chunks
    (scan sharing and lowering on), then DocFreq over a plain gzip of the
    corpus's first 16 MB as one chunk; returns each kernel's launches in
    the BGZF run."""
    import gzip

    t0 = time.perf_counter()
    bgzf = os.path.join(workdir, "corpus.txt.gz")
    zbytes = write_bgzf(corpus, bgzf)
    log("phase ingest corpus: {} bytes BGZF in {:.3f} s".format(
        zbytes, time.perf_counter() - t0))
    check(settings.lower_enabled(), "ingest needs lowering on")
    from dampr_tpu_torch.inputs import plan_chunks

    out_dir = os.path.join(workdir, "idf_bgzf")
    chunk = zbytes // 8 + 1
    n_chunks = len(plan_chunks(bgzf, chunk))
    zero_launches(kernels)
    t0 = time.perf_counter()
    em = tfidf_pipeline(Dampr, DocFreq, bgzf, chunk, out_dir).run(
        name="chip-ingest")
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    stats = em.stats()
    got = part_lines(out_dir)
    check(got == plain_lines,
          "BGZF TF-IDF sink lines differ from the plain-text run's")
    check(got == tfidf_oracle_lines(df, n_lines),
          "BGZF TF-IDF sink lines differ from the oracle")
    for name, count in launches.items():
        check(count > 0, "kernel {} never launched in the BGZF TF-IDF run"
              .format(name))
    groups = stats["scan_sharing"]["groups"]
    check(len(groups) == 1 and len(groups[0]["stages"]) == 2
          and groups[0]["chunks"] == n_chunks,
          "BGZF TF-IDF: scan-shared groups {}".format(groups))
    io = stats["io"]
    check(0 < io["overlap_peak_bytes"] <= io["budget_bytes"]
          and io["overlap_bytes"] == 0,
          "BGZF TF-IDF: overlap peak {} bytes against a {} byte budget, {} "
          "left".format(io["overlap_peak_bytes"], io["budget_bytes"],
                        io["overlap_bytes"]))
    dstat = stats["device"]
    log("ingest " + json.dumps({
        "run": "tfidf-bgzf", "seconds": secs,
        "mb_per_s": nbytes / 1e6 / secs,
        "compressed_mb_per_s": zbytes / 1e6 / secs,
        "bytes": nbytes, "compressed_bytes": zbytes, "chunks": n_chunks,
        "sink_lines": len(got), "kernels": launches,
        "scan_sharing": groups,
        "overlap_peak_bytes": io["overlap_peak_bytes"],
        "budget_bytes": io["budget_bytes"],
        "overlap_windows": io["overlap_windows"],
        "device_stages": dstat["device_stages"],
        "batches": dstat["batches"], "fallbacks": dstat["fallbacks"],
        "host_phase_seconds": dstat["host_phase_seconds"],
        "stage_seconds": stage_seconds(stats)}))

    t0 = time.perf_counter()
    head = os.path.join(workdir, "corpus_head.txt")
    head_bytes = head_lines(corpus, head, 16 * 1024 ** 2)
    gz = os.path.join(workdir, "corpus_head.txt.gz")
    with open(head, "rb") as f, open(gz, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", compresslevel=6) as z:
            z.write(f.read())
    head_df = oracle(head)[1]
    prep = time.perf_counter() - t0
    zero_launches(kernels)
    t0 = time.perf_counter()
    em = (Dampr.text(gz, 64 * 1024 ** 2)
          .custom_mapper(DocFreq(mode="word", lower=True, pair_values=False))
          .fold_values(operator.add).run(name="chip-ingest-gzip"))
    got = em.read()
    secs = time.perf_counter() - t0
    gz_launches = read_launches(kernels)
    stats = em.stats()
    em.delete()
    check(got == sorted(head_df.items()),
          "plain-gzip DocFreq differs from the oracle of its 16 MB")
    maps = [s for s in stats["stages"] if s["kind"] == "map"]
    check(maps[0]["jobs"] == 1, "plain gzip did not read as one chunk")
    log("ingest " + json.dumps({
        "run": "docfreq-gzip", "seconds": secs,
        "mb_per_s": head_bytes / 1e6 / secs, "bytes": head_bytes,
        "compressed_bytes": os.path.getsize(gz), "chunks": maps[0]["jobs"],
        "prep_seconds": prep, "distinct": len(got),
        "kernels": gz_launches,
        "overlap_peak_bytes": stats["io"]["overlap_peak_bytes"],
        "stage_seconds": stage_seconds(stats)}))
    return launches


# -- the handoff (B4, csrc/handoff.cu) ----------------------------------------

#: Kernel names (regular expressions) of the table program in the profiler.
HANDOFF_NAMES = r"probe_rows|run_starts"

#: Runs of each case of the table-program check: its hits add with integer
#: atomics in no fixed order, so an ordering fault would show only
#: sometimes.
HANDOFF_REPEATS = 20

#: The table program's variants: (dedup, dedup_k): +1 a hit; per-line
#: first occurrence through the 16-token window; through the sort.
HANDOFF_VARIANTS = ((False, 0), (True, 16), (True, 0))


def handoff_table(np, hashing, vrows, vlens, cap, Lcap, dup_h1=False,
                  collide=False, run=0):
    """A vocabulary table as the handoff lays it out: ``(tab_h1 uint32,
    tab_slot, tab_mat, tab_lens)`` numpy lanes for token rows ``vrows``
    (uint8 [V, >= max(vlens)], zero past each length).  ``dup_h1`` puts
    every 97th slot under its neighbour's h1 (the leftmost must win, the
    other one's tokens miss); ``collide`` flips a byte of every 89th slot's
    row, so its tokens meet their h1 with other bytes and miss; ``run``
    puts that many slots from slot 3 on under slot 3's h1, a run of equal
    lanes across several samples of the kernel's index (slot 3, leftmost,
    must win; the others' tokens miss)."""
    V = len(vlens)
    h1 = hashing._fnv_numpy(vrows, vlens)[0]
    slot_h1 = h1.copy()
    rows = np.zeros((V, Lcap), dtype=np.uint8)
    w = min(vrows.shape[1], Lcap)
    rows[:, :w] = vrows[:, :w]
    if dup_h1:
        slot_h1[1::97] = h1[0::97][:len(slot_h1[1::97])]
    if collide:
        rows[2::89, 0] ^= 1
    if run:
        slot_h1[3:3 + run] = h1[3]
    order = np.argsort(slot_h1, kind="stable")
    tab_h1 = np.full(cap, 0xFFFFFFFF, dtype=np.uint32)
    tab_h1[:V] = slot_h1[order]
    tab_slot = np.zeros(cap, dtype=np.int32)
    tab_slot[:V] = order
    tab_mat = np.zeros((cap, Lcap), dtype=np.uint8)
    tab_mat[:V] = rows
    tab_lens = np.full(cap, -1, dtype=np.int32)
    tab_lens[:V] = vlens
    return tab_h1, tab_slot, tab_mat, tab_lens


def handoff_batch(np, rng, vrows, vlens, n, L, fresh=0.1, max_line=6,
                  hot=0.0, pad=True):
    """A padded batch (``mat``, ``lens``, ``lines``) of ``n`` rows: 7/8 of
    them (all with ``pad`` False) tokens, Zipf over the vocabulary rows
    (each at most L bytes) or, a ``fresh`` share, digit strings no
    vocabulary holds; a ``hot`` share of the tokens then the vocabulary's
    first token; lines of 1 to ``max_line`` tokens; the rest pad rows."""
    n_tok = n - n // 8 if pad else n
    V = len(vlens)
    mat = np.zeros((n, L), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    if V:
        probs = 1.0 / np.arange(1, V + 1) ** 1.1
        ids = rng.choice(V, size=n_tok, p=probs / probs.sum())
        if hot:
            ids[rng.rand(n_tok) < hot] = 0
        w = min(L, vrows.shape[1])
        mat[:n_tok, :w] = vrows[ids, :w]
        lens[:n_tok] = vlens[ids]
    new = rng.rand(n_tok) < fresh if V else np.ones(n_tok, dtype=bool)
    flen = rng.randint(1, L + 1, size=n_tok)
    digits = rng.randint(48, 58, size=(n_tok, L), dtype=np.uint8)
    digits[np.arange(L)[None, :] >= flen[:, None]] = 0
    mat[:n_tok][new] = digits[new]
    lens[:n_tok][new] = flen[new]
    runs = rng.randint(1, max_line + 1, size=n_tok)
    lines = np.zeros(n, dtype=np.int32)
    lines[:n_tok] = np.repeat(np.arange(n_tok), runs)[:n_tok]
    return mat, lens, lines


def random_vocab(np, rng, V, width):
    """``V`` random lower-case tokens of 1 to ``width`` bytes."""
    vlens = rng.randint(1, width + 1, size=V).astype(np.int32)
    vrows = rng.randint(97, 123, size=(V, width)).astype(np.uint8)
    vrows[np.arange(width)[None, :] >= vlens[:, None]] = 0
    return vrows, vlens


def corpus_vocab(np, df):
    """The corpus's own vocabulary as token rows (its words are ASCII), in
    sorted-word order."""
    return vocab_rows(np, sorted(df))


def vocab_rows(np, words):
    """Words as token rows: (uint8 [V, >= 8] zero past each word, their
    lengths)."""
    width = max(8, max(len(w) for w in words))
    vrows = np.zeros((len(words), width), dtype=np.uint8)
    vlens = np.zeros(len(words), dtype=np.int32)
    for i, w in enumerate(words):
        b = w.encode()
        vrows[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        vlens[i] = len(b)
    return vrows, vlens


def table_args(torch, np, dev, table, cap):
    """The table's lanes on the card, and a fresh accumulator."""
    tab_h1, tab_slot, tab_mat, tab_lens = table
    return [torch.from_numpy(tab_h1.view(np.int32)).to(dev),
            torch.from_numpy(tab_slot).to(dev),
            torch.from_numpy(tab_mat).to(dev),
            torch.from_numpy(tab_lens).to(dev),
            torch.zeros(cap + 1, dtype=torch.int64, device=dev)]


#: The table program's cases beside the corpus batch: (name, L, Lcap,
#: vocabulary size, rows, the batch's options, the table's options).
HANDOFF_CASES = (
    ("random L=8", 8, 8, 20000, 1 << 18, {}, {}),
    ("random L=16", 16, 16, 20000, 1 << 18, {}, {}),
    ("random L=256", 256, 256, 4000, 1 << 18, {}, {}),
    ("duplicate h1 lanes", 8, 8, 20000, 1 << 18, {}, {"dup_h1": True}),
    ("h1 collisions, other bytes", 8, 8, 20000, 1 << 18, {},
     {"collide": True}),
    ("Lcap > L", 8, 32, 20000, 1 << 18, {}, {}),
    ("Lcap < L", 16, 8, 20000, 1 << 18, {}, {}),
    ("empty table", 8, 8, 0, 1 << 18, {}, {}),
    ("all miss", 8, 8, 20000, 1 << 18, {"fresh": 1.0}, {}),
    ("one token in 60% of the rows", 8, 8, 20000, 1 << 18,
     {"hot": 0.6, "fresh": 0.0, "pad": False}, {}),
    ("every row one token", 8, 8, 20000, 1 << 18,
     {"hot": 1.0, "fresh": 0.0, "pad": False}, {}),
    ("cap 2^21", 8, 8, (1 << 20) + 4321, 1 << 18, {}, {}),
    ("40 equal h1 lanes", 8, 8, 20000, 1 << 18, {}, {"run": 40}),
    ("n not a multiple of the tile", 8, 8, 20000, (1 << 18) - 777, {}, {}),
    ("n < k", 8, 8, 20000, 10, {"pad": False}, {}),
    ("n = 1", 8, 8, 20000, 1, {"pad": False}, {}))


def check_handoff(torch, np, handoff, hashing, dev, rng, corpus_inputs,
                  vocabs):
    """The table program against its plain version, bit for bit (``acc``,
    ``miss``, ``n_miss``): the corpus batch against each slot order of its
    vocabulary (``vocabs``: order -> token rows), then HANDOFF_CASES,
    every case in all three variants, each HANDOFF_REPEATS times.
    Returns ``(max abs error, cases)``."""
    worst = 0.0
    cases = []
    for order, (cvrows, cvlens) in vocabs.items():
        ccap = max(4096, 1 << (len(cvlens) - 1).bit_length())
        cases.append(("corpus batch, {} vocabulary".format(order),
                      corpus_inputs,
                      handoff_table(np, hashing, cvrows, cvlens, ccap, 8),
                      ccap))
    for name, L, Lcap, V, n, bopts, topts in HANDOFF_CASES:
        vrows, vlens = random_vocab(np, rng, V, min(L, Lcap))
        cap = max(4096, 1 << max(0, (V - 1).bit_length()))
        mat, lens, lines = handoff_batch(np, rng, vrows, vlens, n, L,
                                         **bopts)
        inputs = [torch.from_numpy(x).to(dev) for x in (mat, lens, lines)]
        cases.append((name, inputs,
                      handoff_table(np, hashing, vrows, vlens, cap, Lcap,
                                    **topts), cap))
    for name, inputs, table, cap in cases:
        for dedup, k in HANDOFF_VARIANTS:
            tabs = table_args(torch, np, dev, table, cap)
            want_acc = tabs[4].clone()
            want = handoff.table_probe_reference(*inputs, *tabs[:4],
                                                 want_acc, dedup, k)
            if name == "all miss":
                check(int(want[1]) == int((inputs[1] > 0).sum()),
                      "the all-miss batch hit its table")
            if name.startswith("corpus"):
                # only a word behind another's equal h1 may miss
                check(int(want[1]) * 100 < int((inputs[1] > 0).sum()),
                      "the corpus batch missed its own vocabulary")
            if name == "40 equal h1 lanes":
                check(int(want_acc[3]) > 0 and not want_acc[4:43].any(),
                      "the equal-h1 run: not its leftmost slot alone hit")
            for _ in range(HANDOFF_REPEATS):
                acc = tabs[4].clone()
                got = handoff.table_probe(*inputs, *tabs[:4], acc, dedup, k)
                for what, g, w in (("acc", acc, want_acc),
                                   ("miss", got[0], want[0]),
                                   ("n_miss", got[1], want[1])):
                    ok, err = exact(torch, g, w)
                    worst = max(worst, err)
                    check(ok, "handoff disagrees with its plain version: "
                              "{} in {} (dedup={}, k={})".format(
                                  what, name, dedup, k))
    torch.cuda.synchronize()
    return worst, len(cases)


#: The table program's variants as the kernels line names them: (name,
#: dedup, dedup_k).
HANDOFF_TIMED = (("window", True, 16), ("count", False, 0),
                 ("sort", True, 0))


def time_handoff(torch, np, ablate, handoff, hashing, dev, corpus_inputs,
                 vocabs, reps):
    """The table program at the main path's batch (the corpus's first)
    against the corpus's vocabulary: DocFreq's variant (the 16-token
    window) under the sorted-word slot order beside its plain version and
    its byte bound, then every variant under each slot order in
    ``vocabs`` (``variants``), then the first design's ablations
    (``ablations``; ``ablate``: its built kernel)."""
    mat, lens, lines = corpus_inputs
    N, L = mat.shape
    Lcap = 8
    tables = {}
    for order, (vrows, vlens) in vocabs.items():
        cap = max(4096, 1 << (len(vlens) - 1).bit_length())
        tables[order] = (table_args(
            torch, np, dev,
            handoff_table(np, hashing, vrows, vlens, cap, Lcap), cap), cap)
    tabs, cap = tables["sorted"]
    k = handoff._DEDUP_WINDOW
    t = timing(torch, lambda: handoff.table_probe(mat, lens, lines, *tabs,
                                                  True, k),
               reps, HANDOFF_NAMES)
    t["plain"] = timing(torch, lambda: handoff.table_probe_reference(
        mat, lens, lines, *tabs, True, k), reps, launches=20 * L + 100)
    live = int(lens.clamp(0, L).sum())
    nbytes = (N * L + 8 * N            # the batch: mat, lens, lines
              + cap * (12 + Lcap)      # the table's lanes
              + 8 * (cap + 1)          # acc
              + N + 4)                 # miss, n_miss
    nops = 4 * live + 3 * N * cap.bit_length()
    t["bound"] = bound_ms(nbytes, nops)
    t["shape"] = [N, L]
    t["table"] = {"cap": cap, "Lcap": Lcap, "slots": len(vocabs["sorted"][1])}
    t["variants"] = {}
    for name, dedup, dk in HANDOFF_TIMED:
        # COUNT reads no lines; the sort's keys are its own scratch
        vb = bound_ms(nbytes - (0 if dedup else 4 * N), nops)[0]
        t["variants"][name] = {}
        for order, (vtabs, _cap) in tables.items():
            vt = timing(torch, lambda: handoff.table_probe(
                mat, lens, lines, *vtabs, dedup, dk), reps,
                launches=2 if dk or not dedup else 20)
            t["variants"][name][order] = {
                "device_ms": vt["device_ms"], "ms": vt["ms"],
                "host_ms": vt["host_ms"], "bound_ms": vb}
    t["ablations"] = time_handoff_ablations(torch, ablate, handoff,
                                            corpus_inputs, tables, reps)
    return t


def first_seen_vocab(np, path, df):
    """The corpus's vocabulary as token rows in the order the handoff
    assigns slots: first seen in the corpus's text first (so the Zipf head
    takes the low slots), the words its first 8 MB never show after."""
    rx = re.compile(r"[^\w]+")
    seen = {}
    with open(path) as f:
        for line in f.read(8 * 1024 ** 2).splitlines():
            for t in rx.split(line.lower()):
                if t and t in df:
                    seen.setdefault(t, None)
    return vocab_rows(np, list(seen) + sorted(set(df) - set(seen)))


#: The ablations of the first design (tools/handoff_ablate.cu): flags bit 1
#: drops the atomics, 2 replaces the binary search by a position computed
#: beforehand, 4 drops the WINDOW halo's second probe.
HANDOFF_ABLATIONS = (("as is", 0), ("no atomics", 1),
                     ("no binary search", 2), ("no halo probe", 4),
                     ("none of the three", 7))


def ablate_kernel(build):
    """The first design of the table program with its ablation switches
    (tools/handoff_ablate.cu), built like the port's kernels."""
    import ctypes

    return build.Kernel(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                     "handoff_ablate.cu"), "dampr_handoff_ablate",
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 2)


def time_handoff_ablations(torch, kern, handoff, corpus_inputs, tables,
                           reps):
    """The first design's ``device_ms`` at the corpus batch with each of
    its suspected costs taken away in turn, for WINDOW (k = 16) and
    COUNT, under each slot order in ``tables`` (name -> ``(table_args,
    cap)``).  Returns ``{order: {mode: {ablation: device_ms}}}``."""
    from dampr_tpu_torch.ops import fnv

    mat, lens, lines = corpus_inputs
    N, L = mat.shape
    miss = torch.empty(N, dtype=torch.bool, device=mat.device)
    n_miss = torch.empty((), dtype=torch.int32, device=mat.device)
    out = {}
    for order, (tabs, cap) in tables.items():
        tab_h1, tab_slot, tab_mat, tab_lens, acc = tabs
        Lcap = tab_mat.shape[1]
        h = fnv.fnv_reference(mat, lens)[0].to(torch.int64) & 0xFFFFFFFF
        pos = torch.searchsorted(tab_h1.to(torch.int64) & 0xFFFFFFFF,
                                 h).to(torch.int32)
        out[order] = {}
        for mode, k in (("WINDOW", handoff._DEDUP_WINDOW), ("COUNT", 0)):
            code = handoff._WINDOW if k else handoff._COUNT
            row = {}
            for name, flags in HANDOFF_ABLATIONS:
                if flags & 4 and not k:
                    continue

                def call():
                    kern.launch(mat.device, mat.data_ptr(), lens.data_ptr(),
                                lines.data_ptr(), tab_h1.data_ptr(),
                                tab_slot.data_ptr(), tab_mat.data_ptr(),
                                tab_lens.data_ptr(), acc.data_ptr(),
                                miss.data_ptr(), n_miss.data_ptr(), None, N,
                                L, cap, Lcap, code, k, flags, pos.data_ptr())
                row[name] = time_split(torch, call, max(2, 5 * reps))[0]
            out[order][mode] = row
    torch.cuda.synchronize()
    return out


def handoff_line(mode, stats, secs, nbytes, launches, sink_lines):
    d = stats["device"]
    return {"run": "tfidf", "handoff": mode, "seconds": secs,
            "mb_per_s": nbytes / 1e6 / secs, "sink_lines": sink_lines,
            "host_phase_seconds": d["host_phase_seconds"],
            "h2d_bytes": d["h2d_bytes"], "d2h_bytes": d["d2h_bytes"],
            "d2h_avoided_bytes": d["d2h_avoided_bytes"],
            "handoff_bytes": d["handoff_bytes"],
            "handoff_edges": d["handoff_edges"],
            "hbm_peak_bytes": d["hbm_peak_bytes"],
            "hbm_offloads": d["hbm_offloads"],
            "handoff_degrades": d["handoff_degrades"],
            "table_batches": d["handoff"]["table_batches"],
            "classic_batches": d["handoff"]["classic_batches"],
            "misses": d["handoff"]["misses"],
            "batches": d["batches"], "device_folds": d["mesh_folds"],
            "kernels": launches, "reduce_kernels": reduce_launches(stats),
            "combine_seconds": stats["combine_seconds"],
            "stage_seconds": stage_seconds(stats)}


def phase_handoff(Dampr, DocFreq, settings, kernels, corpus, chunk, nbytes,
                  df, n_lines, workdir, plain_lines):
    """The TF-IDF pipeline with ``settings.handoff`` "off", then "auto":
    both runs' sink lines equal the oracle's and each other's; the auto
    run keeps DocFreq's counts on the card (a device edge, table batches,
    the table program launched, the fold reading device refs).  Returns
    the auto run's launches."""
    old = settings.handoff
    out = {}
    try:
        for mode in ("off", "auto"):
            settings.handoff = mode
            out_dir = os.path.join(workdir, "idf_handoff_" + mode)
            zero_launches(kernels)
            t0 = time.perf_counter()
            em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
                name="chip-handoff-" + mode)
            secs = time.perf_counter() - t0
            launches = read_launches(kernels)
            stats = em.stats()
            got = part_lines(out_dir)
            check(got == tfidf_oracle_lines(df, n_lines),
                  "handoff {}: TF-IDF sink lines differ from the oracle"
                  .format(mode))
            check(got == plain_lines, "handoff {}: TF-IDF sink lines differ "
                                      "from the tfidf phase's".format(mode))
            out[mode] = (got, handoff_line(mode, stats, secs, nbytes,
                                           launches, len(got)))
            log("handoff " + json.dumps(out[mode][1]))
    finally:
        settings.handoff = old
    check(out["off"][0] == out["auto"][0], "handoff off and auto differ")
    off, on = out["off"][1], out["auto"][1]
    check(off["handoff_edges"] == 0 and off["kernels"]["handoff"] == 0
          and off["handoff_bytes"] == 0,
          "handoff off: the table program ran: {}".format(off))
    check(on["handoff_edges"] >= 1, "handoff auto: no device edge")
    check(on["table_batches"] > 0, "handoff auto: no table batch")
    check(on["kernels"]["handoff"] > 0, "handoff auto: the table program "
                                        "never launched")
    check(on["device_folds"] >= 1 and on["handoff_bytes"] > 0,
          "handoff auto: the fold did not read device refs")
    check(on["handoff_degrades"] == 0, "handoff auto degraded")
    return on["kernels"]


def phase_handoff_degrade(Dampr, DocFreq, settings, kernels, head, head_df):
    """DocFreq under a 16 KiB device budget: every job's vocabulary
    degrades to the spill path, exactly."""
    old = settings.hbm_budget
    settings.hbm_budget = 1 << 14
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = (Dampr.text(head, os.path.getsize(head) // 8 + 1)
              .custom_mapper(DocFreq(mode="word", lower=True,
                                     pair_values=False))
              .fold_values(operator.add).run(name="chip-handoff-degrade"))
        got = em.read()
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
        stats = em.stats()
        em.delete()
    finally:
        settings.hbm_budget = old
    d = stats["device"]
    check(got == sorted(head_df.items()),
          "handoff degrade: DocFreq differs from the oracle")
    check(d["handoff_degrades"] >= 1, "handoff degrade: nothing degraded")
    log("handoff " + json.dumps({
        "run": "docfreq-degrade", "hbm_budget": 1 << 14, "seconds": secs,
        "handoff_degrades": d["handoff_degrades"],
        "handoff_bytes": d["handoff_bytes"],
        "hbm_offloads": d["hbm_offloads"], "device_folds": d["mesh_folds"],
        "table_batches": d["handoff"]["table_batches"], "kernels": launches,
        "distinct": len(got)}))


class InjectedFailure(object):
    """The kill mechanism: while active, the table program raises on the
    first dispatch after a job registered its device refs; every
    ``RunStore`` made and every device ref registered is kept."""

    def __init__(self, storage, handoff):
        self.storage, self.handoff = storage, handoff
        self.stores, self.registered, self.table_batches = [], [], []

    def __enter__(self):
        st, ho = self.storage, self.handoff
        self._real = (st.RunStore.__init__, st.RunStore.register_device,
                      ho.HandoffVocab.dispatch)
        real_init, real_reg, real_dispatch = self._real
        stores, registered = self.stores, self.registered
        table_batches = self.table_batches

        def init(store, *a, **kw):
            real_init(store, *a, **kw)
            stores.append(store)

        def register_device(store, ref):
            registered.append(ref)
            return real_reg(store, ref)

        def dispatch(vocab, *a, **kw):
            if registered:
                raise RuntimeError("table program launch failed (injected)")
            table_batches.append(1)
            return real_dispatch(vocab, *a, **kw)

        st.RunStore.__init__ = init
        st.RunStore.register_device = register_device
        ho.HandoffVocab.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        (self.storage.RunStore.__init__,
         self.storage.RunStore.register_device,
         self.handoff.HandoffVocab.dispatch) = self._real
        return False


def allocated_after_failure(torch):
    """``memory_allocated()`` once a failed run's lanes are freed."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    # an allocation lets the allocator retire blocks freed while another
    # stream still held them (record_stream) before it is read
    probe = torch.empty(1, device="cuda")
    del probe
    return torch.cuda.memory_allocated()


def run_injected_failure(Dampr, DocFreq, head, name):
    """DocFreq over ``head`` on one job thread, to fail under
    :class:`InjectedFailure`; returns the failure's message."""
    try:
        (Dampr.text(head, os.path.getsize(head) // 4 + 1)
         .custom_mapper(DocFreq(mode="word", lower=True, pair_values=False))
         .fold_values(operator.add).run(name=name, n_maps=1))
    except RuntimeError as e:
        return str(e)
    return None


def phase_handoff_kill(torch, Dampr, DocFreq, storage, handoff, head):
    """A DocFreq run made to fail mid-map: its table program raises on the
    first dispatch after a job registered its device refs.  Every
    ``RunStore`` must end with no device bytes charged and no live device
    ref, and ``torch.cuda.memory_allocated()`` must come back to its level
    before the run (the allocator's reserved-but-free slack is printed,
    as information only)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with InjectedFailure(storage, handoff) as inj:
        failed = run_injected_failure(Dampr, DocFreq, head,
                                      "chip-handoff-kill")
    stores, registered = inj.stores, inj.registered
    table_batches = inj.table_batches
    check(failed is not None and "injected" in failed,
          "handoff kill: the run did not fail as made to: {}".format(failed))
    check(registered and table_batches,
          "handoff kill: no device ref or table batch before the failure")
    n_refs = len(registered)
    del registered[:]
    after = allocated_after_failure(torch)
    reserved = torch.cuda.memory_reserved()
    slack = reserved - after
    live = sum(1 for s in stores for r in s._dev_resident if not r._dead)
    dev_bytes = sum(s._dev_bytes for s in stores)
    line = {"run": "docfreq-kill", "refs_registered": n_refs,
            "table_batches": len(table_batches), "stores": len(stores),
            "dev_bytes": dev_bytes, "live_device_refs": live,
            "allocated_before": before, "allocated_after": after,
            "reserved": reserved, "reserved_free_slack": slack}
    log("handoff " + json.dumps(line))
    check(stores and dev_bytes == 0 and live == 0,
          "handoff kill: device refs left charged: {}".format(line))
    check(after <= before,
          "handoff kill: device memory not returned: {}".format(line))


def check_ref_offload(torch, np, storage, handoff, hashing):
    """Offloading one finalized handoff ref frees at least its lanes'
    bytes on the card: each partition's ref owns its lanes, so what its
    store uncharges is what the card gets back."""
    import gc

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        probe = torch.empty(1, device="cuda")  # retires record_stream frees
        del probe
        return torch.cuda.memory_allocated()

    store = storage.RunStore("chip-handoff-offload", budget=1 << 28)
    store.handoff_active = True
    try:
        n = 1 << 16
        keys = np.empty(n, dtype=object)
        keys[:] = ["k%d" % i for i in range(n)]
        h1, h2 = hashing.hash_keys(keys)
        hv = handoff.HandoffVocab(store, dedup=False)
        ok, _frac = hv.absorb_drain(list(keys), np.ones(n, dtype=np.int64),
                                    h1, h2, n)
        check(ok, "handoff offload: the vocabulary refused its keys")
        _blocks, mapping = hv.finalize(store, 4)
        refs = [r for rs in mapping.values() for r in rs]
        check(len(refs) == 4 and all(r.is_device for r in refs),
              "handoff offload: finalize made no device refs")
        before = allocated()
        owned = refs[0].dev_bytes
        freed, _host = refs[0].offload()
        after = allocated()
        line = {"run": "ref-offload", "ref_dev_bytes": owned,
                "freed": freed, "allocated_before": before,
                "allocated_after": after}
        log("handoff " + json.dumps(line))
        check(freed == owned and before - after >= owned,
              "handoff offload: the card got back less than the ref's "
              "lanes: {}".format(line))
    finally:
        store.cleanup()


# -- the obs phase -----------------------------------------------------------

#: Span categories the traced TF-IDF run must record on the card: those
#: the JAX package's accelerator path records for this pipeline.
OBS_CATS = "stage,job,codec,fold,device,handoff"
OBS_COUNTERS = "store.resident_bytes,store.hbm_bytes"

#: The kernels' names in a ``torch.profiler`` trace, by launch counter.
PROFILER_NAMES = {"fnv": K1_NAMES, "segfold": K2_NAMES,
                  "handoff": HANDOFF_NAMES, "rows": ROWS_NAMES}


def validate_trace_file(path, cats=None, counters=None):
    """``tools/validate_trace.py`` on ``path`` (a subprocess: the tool is
    stdlib-only); returns its output, fails the phase on a refusal."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "validate_trace.py")
    cmd = [sys.executable, tool, path]
    if cats:
        cmd += ["--require-cats", cats]
    if counters:
        cmd += ["--require-counters", counters]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out = (res.stdout + res.stderr).strip()
    check(res.returncode == 0, "validate_trace refused {}: {}".format(
        path, out))
    return out


def _union(intervals):
    """Merged, sorted ``(t0, t1)`` intervals."""
    out = []
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def card_timeline(profile_path, tracer_doc, wall_s):
    """The card's busy share, top device operations and longest idle
    gaps in one run, from the ``torch.profiler`` Chrome trace
    (``profile_path``) and the port's own ``trace.json`` (``tracer_doc``).

    Clocks: both map to the wall clock in microseconds.  A
    ``torch.profiler`` event's ``ts`` plus the trace's
    ``baseTimeNanoseconds`` / 1000 is the realtime clock; a tracer span's
    ``ts`` plus ``otherData.wall_start`` (``time.time()`` taken with the
    tracer's perf_counter epoch) is the same clock.  The run's window is
    ``[wall_start, wall_start + wall_seconds]``.  The check of the
    alignment: the share of the table program's kernels whose launch
    call (``cudaLaunchKernel``, joined by correlation id) falls inside one
    of the tracer's ``table-probe`` spans."""
    with open(profile_path) as f:
        doc = json.load(f)
    check("baseTimeNanoseconds" in doc,
          "torch.profiler trace has no baseTimeNanoseconds: cannot align "
          "its clock")
    base = doc["baseTimeNanoseconds"] / 1e3
    gpu, launch_ts, launch_calls = [], {}, {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        args = ev.get("args") or {}
        t0 = float(ev["ts"]) + base
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            gpu.append((t0, t0 + float(ev.get("dur", 0)), ev.get("name", "?"),
                        cat, args.get("correlation")))
        elif cat == "cuda_runtime" and "correlation" in args:
            launch_ts[args["correlation"]] = t0
            if "LaunchKernel" in str(ev.get("name", "")):
                launch_calls[args["correlation"]] = t0
    check(gpu, "torch.profiler recorded no kernel or copy on the card")
    # Kineto keeps a device record only when its timestamp lies inside
    # the profiler's window, and it maps the card's timestamps onto the
    # host's clock: where that mapping runs behind, a kernel early in the
    # run can read as older than the window and its record is dropped,
    # while the launch call that queued it (a host record) stays.  Those
    # calls with no device record are counted, and the skew is measured:
    # each kernel's start minus its launch call's start (negative means
    # the card's clock reads behind the host's).
    kernel_corr = {k for _a, _b, _n, cat, k in gpu if cat == "kernel"}
    unmatched = sorted(t for k, t in launch_calls.items()
                       if k not in kernel_corr)
    skews = [a - launch_ts[k] for a, _b, _n, cat, k in gpu
             if cat == "kernel" and k in launch_ts]
    w0 = float(tracer_doc["otherData"]["wall_start"]) * 1e6
    w1 = w0 + wall_s * 1e6
    busy = _union((max(a, w0), min(b, w1)) for a, b, _n, _c, _k in gpu)
    busy_us = sum(b - a for a, b in busy)
    ops = {}
    for a, b, name, cat, _k in gpu:
        o = ops.setdefault(name, [0, 0.0, cat])
        o[0] += 1
        o[1] += b - a
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:5]
    spans = [(ev["cat"], ev["name"], w0 + float(ev["ts"]),
              w0 + float(ev["ts"]) + float(ev["dur"]))
             for ev in tracer_doc["traceEvents"] if ev.get("ph") == "X"]
    gap_lines = []
    for g0, g1 in gaps:
        over = {}
        for cat, name, a, b in spans:
            ov = min(b, g1) - max(a, g0)
            if ov > 0 and cat != "stage":
                key = "{}:{}".format(cat, name)
                over[key] = over.get(key, 0.0) + ov
        host = sorted(over.items(), key=lambda kv: -kv[1])[:4]
        # a span's overlap with the gap, summed over the lanes (threads)
        # that ran it: thread-milliseconds, so it can exceed the gap
        gap_lines.append({
            "start_s": round((g0 - w0) / 1e6, 6),
            "ms": round((g1 - g0) / 1e3, 3),
            "host_spans_thread_ms": [[k, round(v / 1e3, 3)]
                                     for k, v in host]})
    probes = [(a, b) for cat, name, a, b in spans
              if cat == "handoff" and name == "table-probe"]
    pk = [k for _a, _b, name, _c, k in gpu
          if re.search(HANDOFF_NAMES, name) and k in launch_ts]
    inside = sum(1 for k in pk
                 if any(a - 50 <= launch_ts[k] <= b + 50 for a, b in probes))
    counts = {k: sum(1 for _a, _b, name, cat, _c in gpu
                     if cat == "kernel" and re.search(pat, name))
              for k, pat in PROFILER_NAMES.items()}
    return {"window_s": round(wall_s, 6),
            "busy_s": round(busy_us / 1e6, 6),
            "busy_share": round(busy_us / max(1e-9, w1 - w0), 6),
            "gpu_events": len(gpu),
            "top_device_ops": [
                {"name": n[:96], "cat": v[2], "count": v[0],
                 "ms": round(v[1] / 1e3, 4)} for n, v in top],
            "idle_gaps": gap_lines,
            "kernel_counts": counts,
            "launch_calls": len(launch_calls),
            "launch_calls_without_kernel": len(unmatched),
            "unmatched_launch_s": [round((t - w0) / 1e6, 6)
                                   for t in unmatched[:8]],
            "kernel_minus_launch_ms": ([round(min(skews) / 1e3, 3),
                                        round(max(skews) / 1e3, 3)]
                                       if skews else None),
            "aligned_launch_share": (round(inside / len(pk), 4)
                                     if pk else None)}


def obs_run(Dampr, DocFreq, settings, kernels, corpus, chunk, workdir, tag,
            trace=False, profile_dir=None):
    """One TF-IDF run for the obs phase; returns ``(seconds, launches,
    stats, sink lines)``."""
    out_dir = os.path.join(workdir, "idf_obs_" + tag)
    old = (settings.trace, settings.profile, settings.trace_dir,
           settings.profile_dir)
    settings.trace = settings.profile = trace
    settings.trace_dir = os.path.join(workdir, "traces")
    settings.profile_dir = profile_dir
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
            name="chip-obs-" + tag)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        (settings.trace, settings.profile, settings.trace_dir,
         settings.profile_dir) = old
    return secs, launches, em.stats(), part_lines(out_dir)


def phase_obs(torch, Dampr, DocFreq, settings, storage, handoff, kernels,
              corpus, chunk, nbytes, df, n_lines, workdir, plain_lines,
              head):
    """(a) TF-IDF untraced, then traced and profiled: equal sink lines,
    copies and launches; the trace validates with the categories and
    counters the path must record; stats.json round-trips to
    ``em.stats()``; the critical path names a verdict; the DocFreq stage's
    profile has device sub-phases.  (b) The same run under
    ``settings.profile_dir`` (and traced): the card's busy share, top
    operations and longest idle gaps with the host spans inside them; the
    profiler's K1/K2/B4 kernels, with its launch calls that have no
    kernel record, must account for the launch counters.  (c) A
    traced run failed mid-map leaves a crashdump that validates, and
    ``memory_allocated()`` reads the same before and after."""
    want = tfidf_oracle_lines(df, n_lines)
    runs = {}
    for tag, trace in (("untraced", False), ("traced", True)):
        secs, launches, stats, got = obs_run(
            Dampr, DocFreq, settings, kernels, corpus, chunk, workdir, tag,
            trace=trace)
        check(got == want and got == plain_lines,
              "obs {}: TF-IDF sink lines differ from the oracle".format(tag))
        runs[tag] = (secs, launches, stats)
    (s0, l0, st0), (s1, l1, st1) = runs["untraced"], runs["traced"]
    d0, d1 = st0["device"], st1["device"]
    check(l0 == l1 and all(l0.values()),
          "obs: launches differ traced/untraced: {} {}".format(l0, l1))
    check(d0["kernels"] == l0 and d1["kernels"] == l1,
          "obs: stats kernels differ from the counters")
    check((d0["h2d_bytes"], d0["d2h_bytes"]) == (d1["h2d_bytes"],
                                                 d1["d2h_bytes"]),
          "obs: copies differ traced/untraced")
    check(st0["trace_file"] is None and st0["stats_file"] is None
          and "spans" not in st0, "obs: the untraced run traced")
    vout = validate_trace_file(st1["trace_file"], OBS_CATS, OBS_COUNTERS)
    with open(st1["stats_file"]) as f:
        on_disk = json.load(f)
    check(on_disk == json.loads(json.dumps(st1, default=str)),
          "obs: stats.json does not round-trip to em.stats()")
    verdict = (st1.get("critpath") or {}).get("run", {}).get("verdict")
    check(verdict, "obs: critpath names no run verdict")
    dev_stages = [s for s in st1["profile"]["stages"] if s["device"]]
    check(dev_stages and {"build", "h2d", "compute"} <= set(
        dev_stages[0]["device"]), "obs: DocFreq has no device sub-phases: "
                                  "{}".format(st1["profile"]["stages"]))
    log("obs " + json.dumps({
        "run": "traced-vs-untraced", "seconds_untraced": s0,
        "seconds_traced": s1, "ratio": s1 / s0,
        "mb_per_s_untraced": nbytes / 1e6 / s0,
        "mb_per_s_traced": nbytes / 1e6 / s1,
        "devtime_untraced": st0["devtime"], "devtime_traced": st1["devtime"],
        "device_fraction": [d0["device_fraction"], d1["device_fraction"]],
        "stall_fraction": [st0["overlap"]["stall_fraction"],
                           st1["overlap"]["stall_fraction"]],
        "h2d_bytes": d1["h2d_bytes"], "d2h_bytes": d1["d2h_bytes"],
        "kernels": l1, "spans": st1["spans"], "validate": vout,
        "critpath": st1["critpath"]["run"],
        "critpath_stages": [(c["stage"], c["kind"], c["verdict"])
                            for c in st1["critpath"]["stages"]],
        "profile": [{"stage": s["stage"], "kind": s["kind"],
                     "coverage": s["coverage"], "ops": s["ops"][:4],
                     "device": s["device"]}
                    for s in st1["profile"]["stages"]],
        "sampler": st1["metrics"]["sampler"]}))

    # -- (b) the card's timeline under torch.profiler --------------------
    pdir = os.path.join(workdir, "torch_profile")
    s2, l2, st2, got = obs_run(Dampr, DocFreq, settings, kernels, corpus,
                               chunk, workdir, "profiled", trace=True,
                               profile_dir=pdir)
    check(got == want, "obs profiled: TF-IDF sink lines differ")
    path = st2.get("profile_trace_file")
    check(path and os.path.isfile(path), "obs: no torch.profiler trace")
    with open(st2["trace_file"]) as f:
        tdoc = json.load(f)
    t0 = time.perf_counter()
    tl = card_timeline(path, tdoc, st2["wall_seconds"])
    tl_secs = time.perf_counter() - t0
    # every counted launch is in the profile: as its kernel, or, where
    # kineto dropped the kernel's record as outside its window (see
    # card_timeline), as a launch call that has no device record; the
    # profile never holds more of a kernel than its counter
    lost = sum(l2.values()) - sum(tl["kernel_counts"].values())
    check(all(tl["kernel_counts"][k] <= l2[k] for k in l2)
          and lost <= tl["launch_calls_without_kernel"],
          "obs: the profiler's kernels {} and its {} launch calls with no "
          "kernel record do not account for the launch counters {} "
          "(kernel minus launch call {} ms)".format(
              tl["kernel_counts"], tl["launch_calls_without_kernel"], l2,
              tl["kernel_minus_launch_ms"]))
    # the card's work per run is the same with or without the profiler,
    # whose host cost stretches the window: its busy seconds over the
    # untraced run's wall
    tl["busy_share_of_untraced_wall"] = round(
        tl["busy_s"] / st0["wall_seconds"], 6)
    log("obs " + json.dumps(dict(
        tl, run="card-timeline", seconds=s2,
        trace_mb=os.path.getsize(path) / 1e6, read_seconds=tl_secs,
        launches=l2, corpus_bytes=nbytes)))

    # -- (c) a traced run failed mid-map ---------------------------------
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    old = (settings.trace, settings.trace_dir)
    settings.trace = True
    settings.trace_dir = os.path.join(workdir, "traces")
    try:
        with InjectedFailure(storage, handoff):
            failed = run_injected_failure(Dampr, DocFreq, head,
                                          "chip-obs-kill")
    finally:
        settings.trace, settings.trace_dir = old
    check(failed is not None and "injected" in failed,
          "obs kill: the run did not fail as made to: {}".format(failed))
    after = allocated_after_failure(torch)
    dump = os.path.join(workdir, "traces", "chip-obs-kill", "trace",
                        "crashdump.json")
    check(os.path.isfile(dump), "obs kill: no crashdump.json")
    dout = validate_trace_file(dump)
    with open(dump) as f:
        crash = json.load(f)["otherData"]
    log("obs " + json.dumps({
        "run": "traced-kill", "crashdump": dout, "crash": crash["crash"],
        "log_codes": [r["code"] for r in crash.get("log", ())],
        "allocated_before": before, "allocated_after": after}))
    check(after == before, "obs kill: memory_allocated {} before, {} after"
          .format(before, after))
    return l1


#: The ``analyze`` phase's inputs: 2^22 values from ``--seed``, the
#: integer chain's uniform in [-2^40, 2^40) (past int32: the card runs the
#: chain in int64), in 8 partitions (8 jobs of 524,288 records, 8 batches
#: of 65,536 each, every batch at the card's dispatch floor).
ANALYZE_N = 1 << 22
ANALYZE_PARTS = 8
ANALYZE_KEYS = 4096

#: The module ``analyze.lint`` lints: the port's ``wc``, ``word_stats``
#: and TF-IDF pipelines, built by this script's own functions.
LINT_MODULE = """
import chip_smoke
from dampr_tpu_torch import Dampr
from dampr_tpu_torch.ops.text import DocFreq


def lint_pipelines():
    out = [("wc", chip_smoke.wc_pipeline(Dampr, {corpus!r}, {chunk}))]
    ws = chip_smoke.word_stats_pipelines(Dampr, {corpus!r}, {chunk})
    out += [("word_stats_%d" % i, p) for i, p in enumerate(ws)]
    out.append(("tfidf", chip_smoke.tfidf_pipeline(
        Dampr, DocFreq, {corpus!r}, {chunk}, {out!r})))
    return out
"""


def int_chain(Dampr, vals):
    """The integer chain: ``map . filter . fold_by`` (the JAX package plans
    it as one certified ``ValueMap . Filter . Rekey`` stage on the device
    and a device sum fold)."""
    return (Dampr.memory(vals, partitions=ANALYZE_PARTS)
            .map(lambda x: x * 3 + 1)
            .filter(lambda x: x % 2 == 0)
            .fold_by(lambda x: x % ANALYZE_KEYS, operator.add))


def float_chain(Dampr, vals):
    return (Dampr.memory(vals, partitions=ANALYZE_PARTS)
            .map(lambda v: v * 0.5 + 3.0)
            .filter(lambda v: v > 10.0))


def int_chain_oracle(np, arr):
    v = arr * 3 + 1
    v = v[v % 2 == 0]
    keys = v % ANALYZE_KEYS
    sums = np.zeros(ANALYZE_KEYS, dtype=np.int64)
    np.add.at(sums, keys, v)
    present = np.bincount(keys, minlength=ANALYZE_KEYS) > 0
    return [(int(k), int(sums[k])) for k in np.nonzero(present)[0]]


def chain_program(pipe):
    """The lane program the runner takes for the pipeline's first map
    stage (the same program object: it is cached by the chain's UDFs)."""
    from dampr_tpu_torch.analyze import torchtrace
    from dampr_tpu_torch.plan import passes

    graph, _ = passes.optimize(pipe.pmer.graph, [pipe.source])
    stage = [s for s in graph.stages if hasattr(s, "mapper")][0]
    prog = torchtrace.stage_program(stage)
    check(prog is not None, "the chain did not certify: {}".format(
        torchtrace.chain_claims(stage.mapper)[1]))
    return prog


def analyze_run(settings, build, name, analyze, kernels, trace_dir=None):
    """One run of a chain pipeline: ``(records, seconds, stats,
    counters of its lane program in this run, kernel launches)``."""
    pipe = build()
    prog = chain_program(pipe)
    before = dict(prog.counters)
    old = (settings.analyze, settings.trace, settings.trace_dir)
    settings.analyze = analyze
    settings.trace = trace_dir is not None
    settings.trace_dir = trace_dir
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = pipe.run(name="chip-analyze-" + name)
        got = em.read()
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        settings.analyze, settings.trace, settings.trace_dir = old
    stats = em.stats()
    em.delete()
    counters = {k: v - before[k] for k, v in prog.counters.items()}
    return got, secs, stats, counters, launches, prog


def check_counters(what, c):
    check(c["batches"] >= 1 and c["device_dispatched"] == c["batches"]
          and c["device_verified"] == c["device_dispatched"]
          and c["device_mismatch"] == 0 and c["fallback"] == 0
          and c["diff_checked"] >= 1 and c["diff_diverged"] == 0,
          "{}: the lane program's counters fail the contract: {}".format(
              what, c))


def numeric_chain_spans(trace_file):
    """The ``numeric-chain`` device spans of a trace: count, seconds in
    all, and the median, smallest and largest span in ms."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    ms = sorted(e["dur"] / 1e3 for e in events
                if e.get("name") == "numeric-chain" and e.get("ph") == "X")
    return {"spans": len(ms), "seconds": sum(ms) / 1e3,
            "median_ms": statistics.median(ms) if ms else None,
            "min_ms": ms[0] if ms else None,
            "max_ms": ms[-1] if ms else None}


def lint_main_path(workdir, corpus, chunk):
    """``python -m dampr_tpu_torch.analyze.lint --json`` (its ``main``, in
    this process) over a module building the port's ``wc``,
    ``word_stats`` and TF-IDF pipelines; the report must be clean and pass
    ``tools/validate_lint.py``."""
    import contextlib
    import importlib.util
    import io

    from dampr_tpu_torch.analyze import lint

    path = os.path.join(workdir, "lint_main_path.py")
    with open(path, "w") as f:
        f.write(LINT_MODULE.format(corpus=corpus, chunk=chunk,
                                   out=os.path.join(workdir, "idf_lint")))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = lint.main(["--json", path])
    secs = time.perf_counter() - t0
    report = json.loads(buf.getvalue())
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "validate_lint", os.path.join(root, "tools", "validate_lint.py"))
    vl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vl)
    with open(os.path.join(root, "docs", "lint_schema.json")) as f:
        problems = vl.validate(report, json.load(f))
    check(code == 0 and report["exit_code"] == 0
          and report["counts"]["error"] == 0
          and report["counts"]["warn"] == 0,
          "lint of the main path's pipelines is not clean: {}".format(
              report["diagnostics"]))
    check(not problems, "validate_lint refused the lint report: {}".format(
        problems))
    check(len(report["targets"][0]["pipelines"]) == 6,
          "lint found {}".format(report["targets"]))
    return {"exit_code": code, "counts": report["counts"],
            "pipelines": report["targets"][0]["pipelines"],
            "codes": sorted({d["code"] for d in report["diagnostics"]}),
            "schema_problems": problems, "seconds": secs}


def time_lane_program(torch, np, prog, lane_np, reps):
    """B11 at one 65,536-lane batch of the integer chain: ``device_ms``
    (the card alone), ``host_ms`` (queueing the chain's launches),
    ``ms`` (``run_device``: copy in, the chain, three copies back), the
    host's numpy evaluation (``run_host``, the result that decides), one
    batch of the per-record chain, and the kernels one dispatch launches
    (from ``torch.profiler``; None where it shows none)."""
    from torch.profiler import ProfilerActivity, profile

    lane = torch.from_numpy(lane_np).to("cuda")
    fn = lambda: prog.device_program(lane)  # noqa: E731
    out = {"shape": [len(lane_np)], "dtype": "int64"}
    out["device_ms"], out["host_ms"] = time_split(torch, fn, 100)
    walls = []
    for _ in range(3 + reps):
        t0 = time.perf_counter()
        prog.run_device(lane_np, np.dtype(np.int64))
        walls.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = statistics.median(walls[3:])
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prog.run_host(lane_np)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["host_eval_ms"] = statistics.median(walls)
    vals = lane_np.tolist()
    t0 = time.perf_counter()
    for kind, f in prog.spec.ops:
        vals = ([f(v) for v in vals] if kind == "map"
                else [v for v in vals if f(v)])
    key_f, value_f = prog.spec.rekey
    [(key_f(v), value_f(v)) for v in vals]
    out["per_record_ms"] = (time.perf_counter() - t0) * 1e3
    n = len(lane_np)
    out["bound_ms"], out["bound_by"] = bound_ms(8 * n + 8 * n + 8 * n + n,
                                                0)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        out["kernels_per_dispatch"] = sum(
            r.count for r in p.key_averages()
            if str(getattr(r, "device_type", "")).endswith("CUDA")) or None
    except RuntimeError as e:
        log("profiler unavailable: {}".format(e))
        out["kernels_per_dispatch"] = None
    return out


def phase_analyze(torch, np, Dampr, settings, kernels, workdir, corpus,
                  chunk, seed, reps):
    """The static analyzer and the certified lane chain (B11) on the card:
    (a) the integer chain at 2^22 values, analysis on (the lane program,
    its counters) and off (the per-record path), both against a numpy
    oracle, the plan against the JAX package's; (b) the float chain, on
    and off, exact; (c) the linter over the main path's pipelines.  One
    ``analyze`` JSON line."""
    mem0 = torch.cuda.memory_allocated()
    rng = np.random.RandomState(seed)
    arr = rng.randint(-(1 << 40), 1 << 40, size=ANALYZE_N, dtype=np.int64)
    ivals = arr.tolist()
    farr = rng.standard_normal(ANALYZE_N) * 10.0
    fvals = farr.tolist()
    line = {"phase": "analyze", "n": ANALYZE_N,
            "partitions": ANALYZE_PARTS, "cuts": []}

    # (a) the integer chain
    want = int_chain_oracle(np, arr)
    build = lambda: int_chain(Dampr, ivals)  # noqa: E731
    on, on_s, stats, c, launches, prog = analyze_run(
        settings, build, "int-on", True, kernels)
    check(on == want, "the integer chain differs from the numpy oracle "
                      "({} keys against {})".format(len(on), len(want)))
    check_counters("integer chain", c)
    stages = [(s["kind"], s["op"], s["target"]) for s in stats["stages"]]
    check(stages == [("map", "ValueMap . Filter . Rekey", "device"),
                     ("reduce", "AssocFoldReducer", "device")],
          "the integer chain's plan differs from the JAX package's "
          "(one certified ValueMap . Filter . Rekey stage on the device, "
          "a device sum fold): {}".format(stages))
    off, off_s, off_stats, c_off, _l, _p = analyze_run(
        settings, build, "int-off", False, kernels)
    check(off == on, "the integer chain with analysis off differs")
    check(c_off["batches"] == 0 and {s["target"] for s in
                                     off_stats["stages"]
                                     if s["kind"] == "map"} == {"host"},
          "analysis off still took the lane program: {}".format(c_off))
    tr_dir = os.path.join(workdir, "analyze_trace")
    traced, tr_s, tr_stats, c_tr, _l, _p = analyze_run(
        settings, build, "int-traced", True, kernels, trace_dir=tr_dir)
    check(traced == on, "the traced integer chain differs")
    spans = numeric_chain_spans(tr_stats["trace_file"])
    check(spans["spans"] == c_tr["device_dispatched"],
          "{} numeric-chain spans for {} dispatches".format(
              spans["spans"], c_tr["device_dispatched"]))
    line["int"] = {"records_on": len(on), "seconds_on": on_s,
                   "records_off": len(off), "seconds_off": off_s,
                   "seconds_traced": tr_s, "stages": stages,
                   "counters": c, "launches": launches,
                   "numeric_chain_device_seconds": spans["seconds"],
                   "numeric_chain_spans": spans,
                   "device_fraction": stats["device"]["device_fraction"]}
    log("analyze-int " + json.dumps(line["int"]))

    # B11 at one batch of the integer chain
    batch = arr[:ANALYZE_N // ANALYZE_PARTS][:1 << 16]
    line["b11"] = dict(time_lane_program(torch, np, prog, batch, reps),
                       dispatches=c["device_dispatched"])
    log("analyze-b11 " + json.dumps(line["b11"]))

    # (b) the float chain
    fwant = [v for v in (farr * 0.5 + 3.0).tolist() if v > 10.0]
    fbuild = lambda: float_chain(Dampr, fvals)  # noqa: E731
    fon, fon_s, fstats, fc, _l, _p = analyze_run(
        settings, fbuild, "float-on", True, kernels)
    check(fon == fwant, "the float chain differs from the numpy oracle")
    check_counters("float chain", fc)
    check([s["target"] for s in fstats["stages"]] == ["device"],
          "the float chain did not lower: {}".format(fstats["stages"]))
    foff, foff_s, _st, _c, _l, _p = analyze_run(
        settings, fbuild, "float-off", False, kernels)
    check(foff == fon, "the float chain with analysis off differs")
    line["float"] = {"records_on": len(fon), "seconds_on": fon_s,
                     "records_off": len(foff), "seconds_off": foff_s,
                     "counters": fc}
    log("analyze-float " + json.dumps(line["float"]))

    # (c) the analyzer over the main path
    line["lint"] = lint_main_path(workdir, corpus, chunk)
    del ivals, fvals, on, off, traced, fon, foff
    torch.cuda.synchronize()
    line["memory_allocated_before"] = mem0
    line["memory_allocated_after"] = torch.cuda.memory_allocated()
    log(json.dumps(line))
    return line


def adapt_edges(stats):
    """The TF-IDF run's handoff edges: (src, dst, handoff, kind, reason)."""
    return [[e["src"], e["dst"], e["handoff"], e["kind"], e["reason"]]
            for e in stats["plan"]["lowering"]["handoff"]]


def phase_adapt(Dampr, DocFreq, settings, kernels, workdir, corpus, chunk,
                nbytes, df, n_lines, plain_lines, head, head_df):
    """The run-history corpus and the adaptive plan, under a fresh scratch
    root of their own:

    (a) the TF-IDF pipeline three times under one name (handoff "auto"
        over an empty corpus, "off", "auto" again): each run's sink lines
        equal the oracle; the third run's edge decision must be the one
        ``plan.model.price_handoff`` gives over the two records before it,
        and the corpus must end with three records;
    (b) DocFreq -> ``fold_values(add)`` over the 16 MB head twice under
        one name, ``n_partitions`` not pinned: the second run's plan report
        says ``adaptive.applied`` with its changes, and both read back the
        head's oracle;
    (c) streamed edges, lowering off (a device-lowered fold keeps its
        barrier): a ``wc``-shaped count over the head
        (``fold_by(word, binop=operator.add, value=1)``, an ``early_fold``
        edge) and an unfused map -> map chain over its lines (an impure
        UDF keeps the optimizer from fusing; sorted runs off), each with
        ``settings.pipeline`` "auto" then "off", records equal, the auto
        runs' ``stats()["pipeline"]`` showing the edge executed (and early
        folded blocks for the count);
    (d) ``explain()`` of the TF-IDF and ``wc`` plans under their run
        names: no kernel launches, the corpora unchanged.

    Kernel counts are zeroed just before each run and read just after;
    returns their sum over the phase."""
    from dampr_tpu_torch.obs import history
    from dampr_tpu_torch.plan import model

    saved = {k: getattr(settings, k) for k in (
        "scratch_root", "handoff", "pipeline", "lower", "sort_runs")}
    settings.scratch_root = os.path.join(workdir, "adapt_scratch")
    total = dict.fromkeys(kernels, 0)

    def timed(build, name):
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = build().run(name=name)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
        for k, n in launches.items():
            total[k] += n
        return em, secs, launches

    try:
        # -- (a) the priced handoff on the main path ------------------------
        name = "chip-adapt-tfidf"
        want = tfidf_oracle_lines(df, n_lines)
        runs = []
        for i, mode in enumerate(("auto", "off", "auto")):
            settings.handoff = mode
            out_dir = os.path.join(workdir, "idf_adapt_{}".format(i))
            em, secs, launches = timed(lambda: tfidf_pipeline(
                Dampr, DocFreq, corpus, chunk, out_dir), name)
            stats = em.stats()
            got = part_lines(out_dir)
            check(got == want and got == plain_lines,
                  "adapt run {}: TF-IDF sink lines differ from the oracle"
                  .format(i + 1))
            d = stats["device"]
            line = {"run": i + 1, "handoff_setting": mode, "seconds": secs,
                    "mb_per_s": nbytes / 1e6 / secs,
                    "edges": adapt_edges(stats),
                    "handoff_edges": d["handoff_edges"],
                    "device_fraction": d["device_fraction"],
                    "n_partitions": stats["n_partitions"],
                    "adaptive": stats["plan"]["adaptive"],
                    "cost": {k: stats["plan"]["cost"].get(k) for k in (
                        "enabled", "source", "reason")},
                    "targets": [[t["sid"], t["target"]] for t in
                                stats["plan"]["lowering"]["targets"]],
                    "kernels": launches}
            runs.append(line)
            log("adapt-tfidf " + json.dumps(line))
            check(launches["fnv"] > 0 and launches["segfold"] > 0,
                  "adapt run {}: K1 or K2 never launched: {}".format(
                      i + 1, launches))
            check((launches["handoff"] > 0) == (d["handoff_edges"] > 0),
                  "adapt run {}: B4 launches {} with {} device edges"
                  .format(i + 1, launches["handoff"], d["handoff_edges"]))
        check(runs[1]["device_fraction"] > 0,
              "adapt: the handoff-off TF-IDF run reads device_fraction 0, "
              "so it never votes in the handoff pricing")
        recs = history.load(name)
        check(len(recs) == 3, "adapt: the corpus holds {} records, not 3"
              .format(len(recs)))
        choice, why = model.price_handoff(recs[:2], recs[2]["fingerprint"])
        priced = [e for e in runs[2]["edges"] if e[3] in ("priced",
                                                          "resident")]
        check(priced, "adapt run 3: no edge reached the pricing")
        for e in priced:
            if choice == "spill":
                check(e[2:] == ["spill", "priced", why],
                      "adapt run 3: edge {} is not the corpus's spill "
                      "decision ({})".format(e, why))
            else:
                check(e[2:4] == ["device", "resident"],
                      "adapt run 3: edge {} is not the corpus's device "
                      "decision ({}, {})".format(e, choice, why))
        log("adapt-price " + json.dumps({
            "decision": choice, "reason": why,
            "records": len(recs),
            "walls": [r["wall_seconds"] for r in recs],
            "input_mb": [max(st.get("bytes_in") or 0
                             for st in r["stages"]) / 1e6 for r in recs],
            "edges_resident": [r["handoff"]["edges"] for r in recs],
            "device_fraction": [r["device_fraction"] for r in recs]}))
        settings.handoff = saved["handoff"]

        # -- (b) adaptive sizing ------------------------------------------
        sized = []
        for _ in range(2):
            em, secs, launches = timed(lambda: (
                Dampr.text(head, chunk // 8 + 1).custom_mapper(
                    DocFreq(mode="word", lower=True, pair_values=False))
                .fold_values(operator.add)), "chip-adapt-size")
            got = em.read()
            stats = em.stats()
            em.delete()
            check(got == sorted(head_df.items()),
                  "adapt sizing: DocFreq of the head differs from the oracle")
            sized.append({"seconds": secs,
                          "n_partitions": stats["n_partitions"],
                          "adaptive": stats["plan"]["adaptive"],
                          "kernels": launches})
        ad = sized[1]["adaptive"]
        check(ad["applied"] and ad["changes"],
              "adapt sizing: the second run did not adapt: {}".format(ad))
        log("adapt-size " + json.dumps(sized))

        # -- (c) streamed edges -------------------------------------------
        settings.lower = "off"
        settings.sort_runs = "off"
        seen = []

        def wc_count():
            return (Dampr.text(head, chunk // 8 + 1)
                    .flat_map(lambda line: line.split())
                    .fold_by(lambda w: w, binop=operator.add,
                             value=lambda w: 1))

        def chain():
            return (Dampr.text(head, chunk // 8 + 1)
                    .map(lambda line: len(line))
                    .map(lambda n: (seen.append(n), n * 2 + 1)[1]))

        streamed, results = {}, {}
        for what, build in (("early_fold", wc_count), ("chain", chain)):
            out = {}
            for mode in ("auto", "off"):
                settings.pipeline = mode
                em, secs, launches = timed(build, "chip-adapt-" + what)
                got = em.read()
                stats = em.stats()
                em.delete()
                edges = [e for e in stats["plan"]["pipeline"]["edges"]
                         if e["decision"] == "streamed"
                         and e["mode"] == what]
                out[mode] = (got, stats, {
                    "edge": what, "pipeline": mode, "seconds": secs,
                    "records": len(got),
                    "plan_edges": len(edges),
                    "pipeline_stats": {k: v for k, v in
                                       stats["pipeline"].items()
                                       if k != "queue_depth_series"},
                    "stage_kinds": [s["kind"] for s in stats["stages"]],
                    "kernels": launches})
                log("adapt-stream " + json.dumps(out[mode][2]))
            on, off = out["auto"], out["off"]
            check(on[0] == off[0], "adapt {}: pipelined records differ "
                                   "from staged".format(what))
            check(on[2]["plan_edges"] == 1 and on[1]["pipeline"][
                "executed"] >= 1, "adapt {}: the streamed edge did not "
                                  "execute: {}".format(what, on[2]))
            check(off[1]["pipeline"]["executed"] == 0,
                  "adapt {}: pipeline off still streamed".format(what))
            streamed[what] = on[1]["pipeline"]
            results[what] = on[0]
        check(streamed["early_fold"]["early_folded_blocks"] > 0,
              "adapt: the early folder folded no block")
        words = collections.Counter()
        lens = []
        with open(head, encoding="utf-8") as f:
            for line in f:
                words.update(line.split())
                lens.append(2 * len(line.rstrip("\n")) + 1)
        check(results["early_fold"] == sorted(words.items()),
              "adapt: the streamed count differs from the split() Counter")
        check(sorted(results["chain"]) == sorted(lens),
              "adapt: the streamed chain differs from the line lengths")
        settings.lower = saved["lower"]
        settings.sort_runs = saved["sort_runs"]
        settings.pipeline = saved["pipeline"]

        # -- (d) explain() runs nothing -------------------------------------
        before = {n: len(history.load(n)) for n in (
            "chip-adapt-tfidf", "chip-adapt-early_fold")}
        zero_launches(kernels)
        texts = {"tfidf": tfidf_pipeline(
            Dampr, DocFreq, corpus, chunk,
            os.path.join(workdir, "idf_explain")).explain(
                name="chip-adapt-tfidf"),
            "wc": wc_count().explain(name="chip-adapt-early_fold")}
        check(all(v == 0 for v in read_launches(kernels).values()),
              "adapt: explain() launched a kernel")
        check(before == {n: len(history.load(n)) for n in before},
              "adapt: explain() changed a corpus")
        check(not os.path.exists(os.path.join(workdir, "idf_explain")),
              "adapt: explain() wrote the sink")
        for what, text in texts.items():
            check("cost model:" in text and "pipeline:" in text,
                  "adapt: explain() of {} lacks its plan sections"
                  .format(what))
        log("adapt-explain " + json.dumps(
            {k: len(v.splitlines()) for k, v in texts.items()}))
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
    return total


#: The ``faults`` phase's I/O schedule: at p = 0.01 under seed 1411 the
#: first ``spill_write`` fault fires at the 8th write, the first
#: ``spill_read`` at the 3rd read, and no two fire within 4 invocations of
#: a site in its first 3,000 (so the default two in-place retries absorb
#: every one).
FAULTS_IO_SPEC = "spill_write:p=0.01;spill_read:p=0.01;seed=1411"


def ckpt_bytes(root):
    """Bytes of the checkpoint blocks under a run's scratch root."""
    total = 0
    for d, _dirs, files in os.walk(os.path.join(root, "ckpt")):
        total += sum(os.path.getsize(os.path.join(d, f)) for f in files)
    return total


def manifests(root):
    mdir = os.path.join(root, "manifest")
    return sorted(f for f in os.listdir(mdir)) if os.path.isdir(mdir) else []


def faults_line(run, stats, secs, launches, before, after, root=None,
                **extra):
    """One ``faults`` JSON line: the run's faults section, its restored
    and persisted stages and checkpoint bytes, its copies and launches,
    and ``memory_allocated()`` before and after."""
    d = stats["device"]
    line = dict(
        run=run, seconds=secs, faults=stats["faults"],
        restored=[s["kind"] for s in stats["stages"]
                  if s["kind"].startswith("resumed-")],
        executed=[s["kind"] for s in stats["stages"]
                  if not s["kind"].startswith("resumed-")],
        persisted=len(manifests(root)) if root else 0,
        checkpoint_bytes=ckpt_bytes(root) if root else 0,
        h2d_bytes=d["h2d_bytes"], d2h_bytes=d["d2h_bytes"],
        table_batches=d["handoff"]["table_batches"],
        kernels=launches, allocated_before=before, allocated_after=after)
    line.update(extra)
    log("faults " + json.dumps(line))
    return line


def phase_faults(torch, Dampr, DocFreq, settings, faults, runner_mod,
                 handoff, kernels, workdir, corpus, chunk, nbytes, df,
                 n_lines, plain_lines, head, head_df):
    """Faults, retries and resume on the card, each run printing one
    ``faults`` line:

    (a) ``faults-retry``: the TF-IDF pipeline with ``job_retries = 2`` and
        one transient ``device_dispatch`` fault at the middle table
        dispatch of a clean run (counted by a plan that never fires), so
        it lands on a job whose vocabulary took the table program: sink
        lines equal
        the oracle, at least one job retried, more table batches than the
        clean run (the failed attempt's) and K1 and B4 launched at least
        as often, ``memory_allocated()`` no higher after than before;
    (b) ``faults-io``: DocFreq -> fold over the 16 MB head, handoff off,
        under a quarter of its map output as the budget (it spills), with
        :data:`FAULTS_IO_SPEC`: exact, ``io_retries`` > 0, no job retry;
    (c) ``faults-resume``: the TF-IDF pipeline under one name with
        ``resume=True``, traced; the first run dies of a fatal
        ``checkpoint_persist`` fault at the manifest of the stage after
        the DocFreq map, DocFreq's landed: it leaves a crashdump that validates, its ``d2h`` bytes
        cover DocFreq's device-resident counts fetched once for their
        checkpoint, and ``memory_allocated()`` comes back; the rerun
        restores DocFreq (the DocFreq stage launches nothing, B4 never
        runs, K1 runs only to hash the cross stage's keys) and its sink
        lines equal the oracle; a third run with nothing changed restores every
        stage it needs and runs none;
    (d) ``faults-auto``: the same pipeline with ``resume="auto"``,
        ``job_retries = 0`` and one transient ``device_dispatch`` fault:
        it completes on its second attempt, exact, the summary counts the
        failed one, and ``memory_allocated()`` comes back;
    (e) ``faults-cost``: the pipeline with ``resume=True`` and no fault
        beside the same pipeline plain (seconds, checkpoint bytes and
        copies: a number to record, not a gate).

    Returns the launches of (a)'s retried run."""
    want = tfidf_oracle_lines(df, n_lines)
    olds = {n: getattr(settings, n) for n in (
        "job_retries", "retry_backoff_ms", "handoff", "trace", "trace_dir",
        "faults")}
    lines = {}

    def run_tfidf(tag, **run_args):
        # the sink's path is part of its fingerprint: runs that resume
        # one another share it
        out_dir = os.path.join(workdir, "idf_" + tag.split(":")[0])
        zero_launches(kernels)
        t0 = time.perf_counter()
        em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
            **run_args)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
        # the part files stay: a resumed run's sink manifest names them
        return part_lines(out_dir), em.stats(), secs, launches

    try:
        settings.retry_backoff_ms = 5
        # -- (a) a retried job ------------------------------------------
        # a plan that never fires counts the dispatches; the table
        # program's ones are noted as they come
        counter = faults.FaultPlan("device_dispatch:nth=1000000000")
        rule = counter.rules["device_dispatch"]
        table_at = []
        real_dispatch = handoff.HandoffVocab.dispatch

        def noting(vocab, *a, **kw):
            table_at.append(rule.invocations)
            return real_dispatch(vocab, *a, **kw)

        faults.install(counter)
        handoff.HandoffVocab.dispatch = noting
        try:
            got, clean, secs0, clean_l = run_tfidf(
                "fault-clean", name="chip-faults-clean")
        finally:
            handoff.HandoffVocab.dispatch = real_dispatch
            faults.clear()
        dispatches = rule.invocations
        check(got == want, "faults-retry: the clean run's lines differ")
        check(table_at, "faults-retry: the clean run took no table batch")
        # the middle table dispatch: every job seeds its vocabulary in its
        # first dispatches, so by then the jobs run the table program
        nth = sorted(table_at)[len(table_at) // 2]
        settings.job_retries = 2
        before = allocated_after_failure(torch)
        faults.install(faults.FaultPlan(
            "device_dispatch:nth={},kind=transient".format(nth)))
        got, stats, secs, launches = run_tfidf(
            "fault-retry", name="chip-faults-retry")
        faults.clear()
        after = allocated_after_failure(torch)
        lines["retry"] = faults_line(
            "faults-retry", stats, secs, launches, before, after,
            nth=nth, dispatches=dispatches, table_dispatches=len(table_at),
            clean_seconds=secs0,
            clean_kernels=clean_l,
            clean_table_batches=clean["device"]["handoff"]["table_batches"])
        fa = stats["faults"]
        check(got == want, "faults-retry: sink lines differ from the oracle")
        check(got == plain_lines, "faults-retry: sink lines differ from "
                                  "the tfidf phase's")
        check(fa["injected"] == {"device_dispatch": 1}
              and fa["job_retries"] >= 1,
              "faults-retry: no retried job: {}".format(fa))
        check(lines["retry"]["table_batches"]
              > clean["device"]["handoff"]["table_batches"] > 0,
              "faults-retry: the fault did not land in a table-mode job")
        # the fault fails the attempt; it never moves the job to the host
        # codec (a fallback) or off the table program (a degrade)
        cd, rd = clean["device"], stats["device"]
        # (a retried chunk repeats at most its own fallbacks)
        check(rd["handoff_degrades"] == 0 and rd["device_stages"]
              == cd["device_stages"]
              and rd["fallbacks"] <= 2 * cd["fallbacks"],
              "faults-retry: the fault degraded the job: {} against {}"
              .format({k: rd[k] for k in ("handoff_degrades", "fallbacks",
                                          "device_stages")},
                      {k: cd[k] for k in ("handoff_degrades", "fallbacks",
                                          "device_stages")}))
        for k in ("fnv", "handoff"):
            check(launches[k] >= clean_l[k] > 0,
                  "faults-retry: {} launched {} times, the clean run {}"
                  .format(k, launches[k], clean_l[k]))
        check(after <= before, "faults-retry: memory_allocated {} before, "
                               "{} after".format(before, after))
        settings.job_retries = 0

        # -- (b) absorbed spill I/O faults ------------------------------
        budget = 8 * len(head_df) * 80 // 4
        settings.handoff = "off"
        zero_launches(kernels)
        before = allocated_after_failure(torch)
        faults.install(faults.FaultPlan(FAULTS_IO_SPEC))
        t0 = time.perf_counter()
        em = (Dampr.text(head, os.path.getsize(head) // 8 + 1)
              .custom_mapper(DocFreq(mode="word", lower=True,
                                     pair_values=False))
              .fold_values(operator.add)
              .run(name="chip-faults-io", memory_budget=budget))
        got = em.read()
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
        stats = em.stats()
        em.delete()
        faults.clear()
        settings.handoff = olds["handoff"]
        after = allocated_after_failure(torch)
        fa = stats["faults"]
        lines["io"] = faults_line(
            "faults-io", stats, secs, launches, before, after,
            spec=FAULTS_IO_SPEC, budget=budget,
            spills=stats["spill"]["count"], io=stats["io"])
        check(got == sorted(head_df.items()),
              "faults-io: DocFreq differs from the oracle")
        check(stats["spill"]["count"] > 0, "faults-io: nothing spilled")
        check(sum(fa["io_retries"].values()) > 0,
              "faults-io: no I/O retry: {}".format(fa))
        check(fa["job_retries"] == 0, "faults-io: a job retried")

        # -- (c) fail after DocFreq's checkpoint, resume ----------------
        # stages persist in stage order: the fault takes the manifest of
        # the stage after the lowered DocFreq map (the clean run's list)
        ops = [st["op"] for st in clean["stages"]]
        check("DocFreq" in ops, "faults-resume: no DocFreq stage in {}"
              .format(ops))
        persist_nth = ops.index("DocFreq") + 2
        name = "chip-faults-resume"
        root = os.path.join(settings.scratch_root, name)
        settings.trace = True
        settings.trace_dir = os.path.join(workdir, "traces")
        before = allocated_after_failure(torch)
        faults.install(faults.FaultPlan(
            "checkpoint_persist:nth={},kind=fatal".format(persist_nth)))
        pipe = tfidf_pipeline(Dampr, DocFreq, corpus, chunk,
                              os.path.join(workdir, "idf_resume"))
        r1 = runner_mod.MTRunner(name, pipe.pmer.graph, resume=True)
        zero_launches(kernels)
        t0 = time.perf_counter()
        failed = None
        try:
            r1.run([pipe.source])
        except faults.FatalInjectedFault as e:
            failed = str(e)
        secs = time.perf_counter() - t0
        launches = read_launches(kernels)
        faults.clear()
        settings.trace = False
        s1 = r1.run_summary
        del r1, pipe
        after = allocated_after_failure(torch)
        check(failed is not None, "faults-resume: the first run did not "
                                  "fail as made to")
        dump = os.path.join(workdir, "traces", name, "trace",
                            "crashdump.json")
        check(os.path.isfile(dump), "faults-resume: no crashdump.json")
        dout = validate_trace_file(dump)
        # the DocFreq map stage's records are its jobs' vocabularies: each
        # value lane (int64) came off the card once, for its checkpoint
        df_stage = [st for st in s1["stages"] if st["op"] == "DocFreq"][0]
        lines["resume-fail"] = faults_line(
            "faults-resume-fail", s1, secs, launches, before, after,
            root=root, crashdump=dout, failure=failed,
            failed_manifest=persist_nth,
            docfreq_records=df_stage["records_out"],
            handoff_bytes=s1["device"]["handoff_bytes"])
        check(s1["device"]["handoff_bytes"] > 0,
              "faults-resume: DocFreq's counts were not on the card")
        check(s1["device"]["d2h_bytes"] >= 8 * df_stage["records_out"],
              "faults-resume: DocFreq's device refs were not fetched to be "
              "persisted: {}".format(lines["resume-fail"]))
        check(len(manifests(root)) == persist_nth - 1,
              "faults-resume: {} manifests landed before the failure, not "
              "{}".format(len(manifests(root)), persist_nth - 1))
        check(after <= before, "faults-resume: memory_allocated {} before, "
                               "{} after".format(before, after))
        for i, tag in enumerate(("resume", "resume-again")):
            before = allocated_after_failure(torch)
            got, stats, secs, launches = run_tfidf("resume:" + tag,
                                                   name=name, resume=True)
            after = allocated_after_failure(torch)
            stage_launches = [(st["kind"], st["op"], st["launches"])
                              for st in stats["stages"]]
            line = lines[tag] = faults_line(
                "faults-" + tag, stats, secs, launches, before, after,
                root=root, stage_launches=stage_launches)
            check(got == want, "faults-{}: sink lines differ from the "
                               "oracle".format(tag))
            if i == 0:
                # DocFreq restored: neither its K1 (the token fold) nor B4
                # runs; K1's lanes entry may still hash the keys a stage
                # past the failure registers (the cross's output)
                df_st = [st for st in stats["stages"]
                         if st["op"] == "DocFreq"]
                check(df_st and df_st[0]["kind"] == "resumed-map"
                      and not any(df_st[0]["launches"].values()),
                      "faults-resume: DocFreq not restored: {}".format(
                          stage_launches))
                check(launches["handoff"] == 0 and launches["fnv"]
                      < clean_l["fnv"],
                      "faults-resume: K1/B4 launched: {}".format(launches))
            else:
                check(line["executed"] == [] and line["restored"],
                      "faults-resume-again: a stage ran: {}".format(line))
                check(sum(launches.values()) == 0,
                      "faults-resume-again: kernels launched")

        # -- (d) resume="auto" after a transient fault ------------------
        before = allocated_after_failure(torch)
        faults.install(faults.FaultPlan(
            "device_dispatch:nth={},kind=transient".format(nth)))
        got, stats, secs, launches = run_tfidf(
            "auto", name="chip-faults-auto", resume="auto")
        faults.clear()
        after = allocated_after_failure(torch)
        lines["auto"] = faults_line(
            "faults-auto", stats, secs, launches, before, after,
            root=os.path.join(settings.scratch_root, "chip-faults-auto"))
        fa = stats["faults"]
        check(got == want, "faults-auto: sink lines differ from the oracle")
        check(fa.get("run_attempt") == 2 and fa.get("failed_attempts") == 1,
              "faults-auto: not completed on its second attempt: {}"
              .format(fa))
        check(after <= before, "faults-auto: memory_allocated {} before, "
                               "{} after".format(before, after))

        # -- (e) the cost of checkpointing ------------------------------
        cost = {}
        for tag, args in (("plain", {}), ("resume", {"resume": True})):
            got, stats, secs, launches = run_tfidf(
                "cost-" + tag, name="chip-faults-cost-" + tag, **args)
            check(got == want, "faults-cost {}: lines differ".format(tag))
            root = os.path.join(settings.scratch_root,
                                "chip-faults-cost-" + tag)
            cost[tag] = {"seconds": secs, "d2h_bytes":
                         stats["device"]["d2h_bytes"],
                         "checkpoint_bytes": ckpt_bytes(root),
                         "persisted": len(manifests(root))}
        log("faults " + json.dumps({
            "run": "faults-cost", "plain": cost["plain"],
            "resume": cost["resume"],
            "extra_seconds": cost["resume"]["seconds"]
            - cost["plain"]["seconds"],
            "extra_d2h_bytes": cost["resume"]["d2h_bytes"]
            - cost["plain"]["d2h_bytes"], "corpus_bytes": nbytes}))
    finally:
        faults.clear()
        for n, v in olds.items():
            setattr(settings, n, v)
    return lines["retry"]["kernels"]


#: A job's terminal states, as the daemon reports them.
#: The mesh phase's rig: shards of the one card (settings.mesh_devices).
MESH_SHARDS = 4
MESH_DEVICE = "cuda:0"
#: The mesh phase's exchange pipelines run over the corpus's head.
MESH_HEAD_MB = 16
#: A budget small enough that the exchange's schedule takes several steps.
MESH_SMALL_HBM = 1 << 18
MESH_RING_N = 1 << 24
MESH_SGD_ROWS, MESH_SGD_FEATURES, MESH_SGD_STEPS = 1 << 20, 128, 20


def docfreq_lanes(np, text, corpus, pieces=8):
    """The DocFreq map's output lanes over the corpus, as its 8 chunk jobs
    emit them (the host scanner): ``(h1, h2, v)`` numpy lanes."""
    with open(corpus, "rb") as f:
        data = f.read()
    cuts = [0]
    for i in range(1, pieces):
        cuts.append(data.find(b"\n", i * len(data) // pieces) + 1)
    cuts.append(len(data))
    h1s, h2s, vs = [], [], []
    for a, b in zip(cuts, cuts[1:]):
        blk = text.chunk_doc_freq(data[a:b], "word", True, pair_values=False)
        h1, h2 = blk.hashes()
        h1s.append(h1)
        h2s.append(h2)
        vs.append(np.asarray(blk.values, dtype=np.int64))
    return np.concatenate(h1s), np.concatenate(h2s), np.concatenate(vs)


def fold_dict(hashing, words, fh1, fh2, fv):
    """A keyed fold's rows as {word: value} (every row must be a word)."""
    h1, h2 = hashing.hash_keys(list(words))
    lookup = {(int(a), int(b)): w for w, a, b in zip(words, h1, h2)}
    out = {}
    for a, b, v in zip(fh1.tolist(), fh2.tolist(), fv.tolist()):
        key = lookup.get((a, b))
        check(key is not None and key not in out,
              "mesh fold: a row that is no word, or a word twice")
        out[key] = v
    return out


def mesh_exchange_pipes(Dampr, head, chunk, head_df):
    """The mesh phase's exchange pipelines over the corpus's head: a
    non-associative group_by, an inner and a left join, and a sort_by
    (numeric keys: its read redistributes by key range).  Every UDF
    captures only picklable state (``zlib`` is a global here, not a
    closure variable), so the fleet phase's ranks pass the analyzer's
    pre-flight check."""
    lines = Dampr.text(head, chunk)
    right = Dampr.memory(sorted(head_df.items())[::3]).group_by(
        lambda wc: wc[0])
    first = lines.map(lambda l: (l.split(" ", 1)[0], len(l))).group_by(
        lambda t: t[0])
    return {
        "group_by": lines.group_by(lambda l: len(l) % 97).reduce(
            lambda k, vs: sorted(vs)[:2]),
        "join": first.join(right).reduce(
            lambda l, r: (sum(n for _w, n in l), sum(c for _w, c in r))),
        "left_join": first.join(right).left_reduce(
            lambda l, r: (len(list(l)), sum(c for _w, c in r))),
        "sort_by": lines.map(lambda l: zlib.crc32(l.encode())).sort_by(
            lambda x: x),
    }


def phase_mesh(torch, np, Dampr, DocFreq, settings, kernels, workdir, corpus,
               chunk, nbytes, df, n_lines, idf_lines, head, head_df, reps):
    """The mesh inside one process (ROADMAP A5a) on a rig of
    :data:`MESH_SHARDS` shards of the one card (``settings.mesh_devices =
    "cuda:0*4"``), each check against the same work at D = 1 or with the
    mesh off:

    1. TF-IDF with ``mesh_fold = "on"``: sink lines equal the ``tfidf``
       phase's and the oracle; ``stats()["mesh"]`` has 4 devices and a
       fold; K2 launched in the fold's stages; the same pipeline at D = 1
       (the wall of each, launches, handoff edges); over the real cards too
       where more than one is visible;
    2. ``mesh_keyed_fold`` of the corpus's DocFreq lanes (its 8 chunk jobs'
       output) at the default capacity factor and at 1/1000 (the Zipf head
       overflows: the retry runs), each equal to the D = 1 fold and the
       oracle;
    3. with ``mesh_exchange = "on"`` over the :data:`MESH_HEAD_MB` MB head:
       a non-associative group_by, an inner and a left join and a sort_by,
       each equal to the same pipeline with the mesh off; exchanges and
       steps counted, the peak in flight within the budget, the group_by
       once more under :data:`MESH_SMALL_HBM` (several steps a window);
    4. ``ring_allreduce`` (sum, max) and ``ring_allgather`` of 2^24 int64,
       exact against ``torch.stack(...).sum(0)``/``amax``/``cat``;
    5. ``sgd.train`` on 2^20 x 128 float32 rows, 20 steps, at D = 4
       against D = 1 (rtol 1e-3, atol 1e-5 on ``w``, 1e-4 on the loss: the
       JAX tests' tolerances);
    6. one ``mesh-programs`` line: B7-B10 timed (CUDA events), their
       launches in items 1-5, the byte bound, and a library call's time
       where one torch call computes the same function.

    Returns the rows of the programs line.  No cut."""
    from dampr_tpu_torch.ops import hashing, text
    from dampr_tpu_torch.parallel import exchange as px
    from dampr_tpu_torch.parallel import mesh as pmesh
    from dampr_tpu_torch.parallel import ring, sgd, shuffle

    saved = {k: getattr(settings, k) for k in (
        "mesh_devices", "mesh_fold", "mesh_exchange", "exchange_hbm_budget")}
    counts0 = (shuffle.program_runs, px.total_steps, ring.calls, sgd.steps)
    rig = "{}*{}".format(MESH_DEVICE, MESH_SHARDS)
    try:
        # -- 1. TF-IDF over the rig, then at D = 1 -----------------------
        runs = {}
        for label, devices, fold in (("mesh", rig, "on"),
                                     ("one", None, "auto")):
            settings.mesh_devices = devices
            settings.mesh_fold = fold
            out_dir = os.path.join(workdir, "mesh-idf-" + label)
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
                name="chip-mesh-" + label)
            secs = time.perf_counter() - t0
            stats = em.stats()
            lines = part_lines(out_dir)
            check(lines == idf_lines,
                  "mesh TF-IDF ({}): sink lines differ from the tfidf "
                  "phase's".format(label))
            fold_k2 = sum(st["launches"]["segfold"] for st in stats["stages"]
                          if st["kind"] == "reduce")
            runs[label] = {
                "run": "mesh-tfidf-" + label, "seconds": secs,
                "mb_per_s": nbytes / 1e6 / secs, "mesh": stats["mesh"],
                "launches": {k: kern.launches for k, kern in kernels.items()},
                "fold_segfold_launches": fold_k2,
                "handoff_edges": stats["device"]["handoff_edges"],
                "mesh_folds": stats["device"]["mesh_folds"]}
            log("mesh " + json.dumps(runs[label]))
        check(runs["mesh"]["mesh"]["devices"] == MESH_SHARDS
              and runs["mesh"]["mesh"]["folds"] > 0,
              "mesh TF-IDF: the fold did not run over {} shards: {}".format(
                  MESH_SHARDS, runs["mesh"]["mesh"]))
        check(runs["mesh"]["fold_segfold_launches"] > 0,
              "mesh TF-IDF: K2 never launched in the mesh fold")
        check(part_lines(os.path.join(workdir, "mesh-idf-mesh"))
              == tfidf_oracle_lines(df, n_lines),
              "mesh TF-IDF: sink lines differ from the oracle")
        for name, count in runs["mesh"]["launches"].items():
            check(count > 0, "mesh TF-IDF: kernel {} never launched".format(
                name))
        if torch.cuda.device_count() > 1:
            settings.mesh_devices = None
            settings.mesh_fold = "on"
            out_dir = os.path.join(workdir, "mesh-idf-cards")
            t0 = time.perf_counter()
            em = tfidf_pipeline(Dampr, DocFreq, corpus, chunk, out_dir).run(
                name="chip-mesh-cards")
            secs = time.perf_counter() - t0
            check(part_lines(out_dir) == idf_lines,
                  "mesh TF-IDF over the cards: sink lines differ")
            log("mesh " + json.dumps({"run": "mesh-tfidf-cards",
                                      "seconds": secs,
                                      "mesh": em.stats()["mesh"]}))

        # -- 2. the keyed fold of the DocFreq lanes --------------------------
        settings.mesh_devices = rig
        mesh = pmesh.data_mesh()
        one = pmesh.data_mesh([MESH_DEVICE])
        t0 = time.perf_counter()
        h1, h2, v = docfreq_lanes(np, text, corpus)
        lanes_s = time.perf_counter() - t0
        words = sorted(df)
        want = fold_dict(hashing, words, *shuffle.mesh_keyed_fold(
            one, h1, h2, v, "sum"))
        check(want == df, "the D = 1 fold of the DocFreq lanes differs "
                          "from the oracle")
        fold_rows = {}
        for label, factor in (("default", None), ("overflow", 1e-3)):
            r0 = shuffle.retries
            t0 = time.perf_counter()
            got = fold_dict(hashing, words, *shuffle.mesh_keyed_fold(
                mesh, h1, h2, v, "sum", capacity_factor=factor))
            fold_rows[label] = {"seconds": time.perf_counter() - t0,
                                "retries": shuffle.retries - r0}
            check(got == df, "mesh fold ({}) of the DocFreq lanes differs "
                             "from the D = 1 fold and the oracle".format(
                                 label))
        check(fold_rows["overflow"]["retries"] > 0,
              "mesh fold: the small capacity never overflowed")
        log("mesh " + json.dumps({"run": "mesh-fold", "rows": len(h1),
                                  "distinct": len(df),
                                  "lanes_seconds": lanes_s, **fold_rows}))

        # -- 3. the byte exchange ------------------------------------------
        settings.mesh_fold = "off"
        head_chunk = os.path.getsize(head) // 8 + 1
        ex_rows = []
        for name in ("group_by", "join", "left_join", "sort_by",
                     "group_by-small"):
            pipe_name = name.split("-")[0]
            settings.exchange_hbm_budget = (
                MESH_SMALL_HBM if name.endswith("small")
                else saved["exchange_hbm_budget"])
            got = {}
            for mode in ("on", "off"):
                settings.mesh_exchange = mode
                pipe = mesh_exchange_pipes(Dampr, head, head_chunk,
                                           head_df)[pipe_name]
                x0 = (px.total_exchanges, px.total_steps)
                t0 = time.perf_counter()
                # the sort's output past a third of its budget: its read
                # takes the range exchange, not the one in-memory sort
                em = pipe.run(name="chip-mesh-x-{}-{}".format(name, mode),
                              memory_budget=(
                                  max(1 << 16, os.path.getsize(head) // 4)
                                  if pipe_name == "sort_by" else None))
                got[mode] = em.read()
                secs = time.perf_counter() - t0
                if mode == "on":
                    ex = em.stats()["mesh"]["exchange"]
                    row = {"run": "mesh-" + name, "seconds": secs,
                           "records": len(got[mode]),
                           "exchanges": px.total_exchanges - x0[0],
                           "steps": px.total_steps - x0[1],
                           "run_exchange": ex,
                           "hbm_budget": settings.exchange_hbm_budget}
                    check(row["exchanges"] > 0 and row["steps"] >= 1,
                          "mesh {}: the exchange never engaged".format(name))
                    check(ex["peak_inflight_bytes"]
                          <= settings.exchange_hbm_budget,
                          "mesh {}: peak in flight past the budget".format(
                              name))
                    if pipe_name != "sort_by":
                        check(em.stats()["mesh"]["exchanges"] > 0,
                              "mesh {}: the run counts no exchange".format(
                                  name))
                else:
                    row["off_seconds"] = secs
                em.delete()
            check(got["on"] == got["off"],
                  "mesh {}: records differ from the mesh-off run".format(
                      name))
            ex_rows.append(row)
            log("mesh " + json.dumps(row))
        small = ex_rows[-1]
        check(small["steps"] >= 2 * small["exchanges"],
              "mesh group_by under {} B: the schedule took one step a "
              "window".format(MESH_SMALL_HBM))
        settings.exchange_hbm_budget = saved["exchange_hbm_budget"]

        # -- 4. rings --------------------------------------------------------
        dev = torch.device(MESH_DEVICE)
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randint(-(1 << 40), 1 << 40, (MESH_RING_N,),
                          dtype=torch.int64, device=dev, generator=g)
        parts = torch.stack(x.chunk(MESH_SHARDS))
        check(torch.equal(ring.ring_allreduce(mesh, x, "sum"),
                          parts.sum(0).repeat(MESH_SHARDS)),
              "ring_allreduce(sum) differs from torch.stack(...).sum(0)")
        check(torch.equal(ring.ring_allreduce(mesh, x, "max"),
                          parts.amax(0).repeat(MESH_SHARDS)),
              "ring_allreduce(max) differs from amax")
        check(torch.equal(ring.ring_allgather(mesh, x),
                          torch.cat([x] * MESH_SHARDS)),
              "ring_allgather differs from cat")

        # -- 5. SGD at D = 4 against D = 1 ---------------------------------
        X = torch.randn(MESH_SGD_ROWS, MESH_SGD_FEATURES, device=dev,
                        generator=g)
        wt = torch.randn(MESH_SGD_FEATURES, device=dev, generator=g)
        y = (X @ wt > 0).float()
        t0 = time.perf_counter()
        p4, l4 = sgd.train(mesh, X, y, n_steps=MESH_SGD_STEPS, lr=0.5)
        s4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        p1, l1 = sgd.train(one, X, y, n_steps=MESH_SGD_STEPS, lr=0.5)
        s1 = time.perf_counter() - t0
        werr = float(np.max(np.abs(p4["w"] - p1["w"])))
        check(np.allclose(p4["w"], p1["w"], rtol=1e-3, atol=1e-5)
              and abs(l4 - l1) < 1e-4,
              "sgd at D = 4 differs from D = 1 (w {}, loss {} vs {})".format(
                  werr, l4, l1))
        log("mesh " + json.dumps({"run": "mesh-sgd", "rows": MESH_SGD_ROWS,
                                  "features": MESH_SGD_FEATURES,
                                  "steps": MESH_SGD_STEPS, "loss_d4": l4,
                                  "loss_d1": l1, "w_max_abs_err": werr,
                                  "seconds_d4": s4, "seconds_d1": s1}))
        launches = [shuffle.program_runs - counts0[0],
                    px.total_steps - counts0[1], ring.calls - counts0[2],
                    sgd.steps - counts0[3]]

        # -- 6. the programs, timed ---------------------------------------
        part = (torch.from_numpy(h1.view(np.int32)).to(dev),
                torch.from_numpy(h2.view(np.int32)).to(dev),
                torch.from_numpy(v).to(dev),
                torch.ones(len(h1), dtype=torch.int32, device=dev))
        out = shuffle.mesh_keyed_refold(mesh, [part], "sum", nonneg=True)
        n_in, n_out = len(h1), int(out[0].shape[0])
        b7 = time_ms(torch, lambda: shuffle.mesh_keyed_refold(
            mesh, [part], "sum", nonneg=True), reps)
        b7_one = time_ms(torch, lambda: shuffle.mesh_keyed_refold(
            one, [part], "sum", nonneg=True), reps)
        cap = px.peak_capacity
        D = MESH_SHARDS
        bufs = [torch.randint(0, 256, (D, cap), dtype=torch.uint8,
                              device=dev, generator=g) for _ in range(D)]
        stacked = torch.stack(bufs)
        step_np = np.zeros((D * D, cap), dtype=np.uint8)
        lens_np = np.full(D * D, cap, dtype=np.int32)
        b8 = timing(torch, lambda: pmesh.all_to_all(mesh, bufs), reps,
                    launches=D * D)
        b8_step = time_ms(torch, lambda: px._exchange_step(
            mesh, step_np, lens_np), reps)
        b8_lib = time_ms(torch, lambda: stacked.transpose(0, 1).contiguous(),
                         reps)
        b9 = timing(torch, lambda: ring.ring_allreduce(mesh, x, "sum"), reps,
                    launches=4 * D)
        b9_lib = time_ms(torch, lambda: torch.sum(x.view(D, -1), 0), reps)
        w0 = torch.zeros(MESH_SGD_FEATURES, device=dev)
        b0 = torch.zeros((), device=dev)
        Xs = [X[i * (MESH_SGD_ROWS // D):(i + 1) * (MESH_SGD_ROWS // D)]
              for i in range(D)]
        ys = [y[i * (MESH_SGD_ROWS // D):(i + 1) * (MESH_SGD_ROWS // D)]
              for i in range(D)]
        b10 = timing(torch, lambda: sgd._step(mesh, w0, b0, Xs, ys, 0.5),
                     reps, launches=20 * D)
        rows = [
            {"name": "keyed_fold", "id": "B7",
             "source": "dampr_tpu_torch/parallel/shuffle.py",
             "replaces": "dampr_tpu/parallel/shuffle.py:167",
             "entry": "mesh_keyed_refold(mesh, [DocFreq lanes], 'sum', "
                      "nonneg=True)",
             "shape": [n_in], "out_rows": n_out, "launches": launches[0],
             "device_ms": b7, "device_ms_d1": b7_one,
             "timer": "CUDA events around one call (it syncs inside)",
             "bound_ms": bound_ms(20 * n_in + 20 * n_out, 0)[0],
             "bound_by": "bytes", "plain_ms": None, "library_ms": None},
            {"name": "byte_exchange_step", "id": "B8",
             "source": "dampr_tpu_torch/parallel/exchange.py",
             "replaces": "dampr_tpu/parallel/exchange.py:88",
             "entry": "mesh.all_to_all(mesh, [D x [D, C] uint8])",
             "shape": [D * D, cap], "launches": launches[1],
             "device_ms": b8["device_ms"], "ms": b8["ms"],
             "host_ms": b8["host_ms"], "step_ms_with_h2d": b8_step,
             "bound_ms": bound_ms(2 * D * D * (cap + 4), 0)[0],
             "bound_by": "bytes", "plain_ms": None, "library_ms": b8_lib,
             "library_call": "[D, D, C].transpose(0, 1).contiguous()"},
            {"name": "ring_allreduce", "id": "B9",
             "source": "dampr_tpu_torch/parallel/ring.py",
             "replaces": "dampr_tpu/parallel/ring.py:21",
             "entry": "ring_allreduce(mesh, int64 [2^24], 'sum')",
             "shape": [MESH_RING_N], "launches": launches[2],
             "device_ms": b9["device_ms"], "ms": b9["ms"],
             "host_ms": b9["host_ms"],
             "bound_ms": bound_ms(2 * 8 * MESH_RING_N, MESH_RING_N)[0],
             "bound_by": "bytes", "plain_ms": None, "library_ms": b9_lib,
             "library_call": "torch.sum(x.view(D, -1), 0)"},
            {"name": "sgd_step", "id": "B10",
             "source": "dampr_tpu_torch/parallel/sgd.py",
             "replaces": "dampr_tpu/parallel/sgd.py:35",
             "entry": "sgd._step(mesh, w, b, X shards, y shards, 0.5)",
             "shape": [MESH_SGD_ROWS, MESH_SGD_FEATURES],
             "launches": launches[3], "device_ms": b10["device_ms"],
             "ms": b10["ms"], "host_ms": b10["host_ms"],
             "bound_ms": bound_ms(
                 4 * MESH_SGD_ROWS * (MESH_SGD_FEATURES + 1),
                 4 * MESH_SGD_ROWS * MESH_SGD_FEATURES)[0],
             "bound_by": "bytes", "plain_ms": None, "library_ms": None}]
        log("mesh-programs " + json.dumps({"programs": rows,
                                           "shards": MESH_SHARDS,
                                           "max_capacity": cap}))
        check(all(r["launches"] > 0 for r in rows),
              "mesh: a program never ran in items 1-5")
        return rows
    finally:
        for k, val in saved.items():
            setattr(settings, k, val)


SERVE_TERMINAL = ("done", "failed", "cancelled", "rejected")


def compute_apps():
    """``[(pid, used MiB), ...]`` of the processes holding a CUDA context,
    as ``nvidia-smi --query-compute-apps`` lists them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    check(res.returncode == 0, "nvidia-smi --query-compute-apps failed: "
                               "{}".format(res.stderr.strip()))
    apps = []
    for line in res.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 2 and parts[0].isdigit():
            apps.append((int(parts[0]), parts[1]))
    return apps


class ContextWatch(object):
    """Polls the card's compute apps on a thread for the whole ``serve``
    phase: every pid seen, and the most apps listed at once.  Where the
    container's pids are not the ones ``nvidia-smi`` reports (this
    process's own pid, which holds a context, is not listed), the checks
    fall back to counting apps."""

    def __init__(self, interval=0.25):
        import threading

        self.interval = interval
        self.pids = set()
        self.samples = 0
        self.max_apps = 0
        self.own_visible = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.baseline = len(compute_apps())

    def _run(self):
        while not self._stop.is_set():
            try:
                apps = compute_apps()
            except PhaseFailed:
                apps = []
            self.samples += 1
            self.max_apps = max(self.max_apps, len(apps))
            pids = {p for p, _m in apps}
            self.pids |= pids
            if os.getpid() in pids:
                self.own_visible = True
            self._stop.wait(self.interval)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def start_daemon(settings, workdir, state_dir, scratch, cache, workers):
    """``python -m dampr_tpu_torch.serve.daemon`` as its own process on an
    OS-assigned port, with its own scratch root and cache directory and
    this process's device and lowering switch; returns ``(proc, url,
    pid)`` once it listens."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({"DAMPR_TPU_TORCH_SCRATCH": scratch,
                "DAMPR_TPU_TORCH_REUSE_DIR": cache,
                "DAMPR_TPU_TORCH_DEVICE": str(settings.device),
                "DAMPR_TPU_TORCH_LOWER": str(settings.lower)})
    out_path = os.path.join(workdir, "serve-daemon.log")
    out = open(out_path, "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dampr_tpu_torch.serve.daemon", "--port",
         "0", "--workers", str(workers), "--state-dir", state_dir],
        env=env, stdout=out, stderr=subprocess.STDOUT)
    out.close()
    deadline = time.time() + 120
    rx = re.compile(r"listening on (http://[^ ]+) .*pid (\d+)")
    while time.time() < deadline:
        with open(out_path, errors="replace") as f:
            m = rx.search(f.read())
        if m:
            return proc, m.group(1), int(m.group(2))
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    with open(out_path, errors="replace") as f:
        tail = f.read()[-2000:]
    stop_daemon(proc)
    raise PhaseFailed("the serve daemon did not start: {}".format(tail))


def stop_daemon(proc):
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)  # drain, then exit
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def served(job, state_dir, t0=None, timeout=600):
    """Wait for ``job``; ``(row, result.json or error.json, stats.json,
    client-side seconds since ``t0``, by default since this call)``."""
    if t0 is None:
        t0 = time.perf_counter()
    row = job.wait(timeout_s=timeout, interval_s=0.05)
    secs = time.perf_counter() - t0
    jid = row.get("primary") or job.id
    meta, stats = {}, {}
    for fn in ("result.json", "error.json"):
        path = os.path.join(state_dir, "jobs", jid, fn)
        if os.path.isfile(path):
            with open(path) as f:
                meta = json.load(f)
            break
    if meta.get("stats_file") and os.path.isfile(meta["stats_file"]):
        with open(meta["stats_file"]) as f:
            stats = json.load(f)
    return row, meta, stats, secs


def idf_lines(records):
    """The sink's TSV lines of the TF-IDF pipeline's read-back records."""
    return sorted("{}\t{}\t{}".format(*v) for _k, v in records)


def serve_line(step, row, meta, stats, secs, **extra):
    dev = stats.get("device") or {}
    ru = meta.get("reuse") or {}
    line = {"step": step, "state": row.get("state"),
            "seconds": secs, "worker_wall": row.get("wall_s"),
            "run_wall": meta.get("wall_seconds"),
            "queue_wait": row.get("queue_wait_s"),
            "records": row.get("records"),
            "reuse": {k: ru.get(k) for k in (
                "hits", "misses", "stages_skipped", "incremental_merges",
                "recompute_fallbacks", "bytes_published", "bytes_mounted",
                "evictions")},
            "decisions": ru.get("decisions"),
            "kernels": dev.get("kernels"), "batches": dev.get("batches"),
            "device_stages": dev.get("device_stages"),
            "h2d_bytes": dev.get("h2d_bytes"),
            "d2h_bytes": dev.get("d2h_bytes"),
            "handoff_bytes": dev.get("handoff_bytes"),
            "stages": [(s.get("kind"), s.get("op")) for s in
                       stats.get("stages") or ()]}
    line.update(extra)
    log("serve " + json.dumps(line))
    return line


#: What a worker pays before and in its first run, timed in a fresh
#: process, each part after the ones before it: ``import torch``, the
#: package and its serve worker, the CUDA context, the three kernel
#: libraries' ``dlopen``, then a 1,000-record memory fold run twice (the
#: first pays the process's first use of the plan and analyzer layers).
STARTUP_PROBE = r"""
import json, operator, sys, time
t = [time.perf_counter()]
import torch
t.append(time.perf_counter())
import dampr_tpu_torch.serve.worker, dampr_tpu_torch.dampr
from dampr_tpu_torch import settings
from dampr_tpu_torch.runner import KERNELS
t.append(time.perf_counter())
cuda = settings.resolve_device().type == "cuda"
if cuda:
    torch.zeros(1, device="cuda"); torch.cuda.synchronize()
t.append(time.perf_counter())
if cuda:
    for k in KERNELS.values():
        k.fn()
t.append(time.perf_counter())
for i in range(2):
    (dampr_tpu_torch.dampr.Dampr.memory(list(range(1000)))
     .map(lambda x: (x % 7, x))
     .fold_by(lambda kv: kv[0], value=lambda kv: kv[1], binop=operator.add)
     .run(name="startup-probe-%d" % i).read())
    t.append(time.perf_counter())
print(json.dumps(dict(zip(("import_torch", "import_package", "cuda_context",
                           "dlopen_kernels", "first_run", "second_run"),
                          [b - a for a, b in zip(t, t[1:])]))))
"""


def startup_breakdown(settings):
    """:data:`STARTUP_PROBE` in a fresh process: seconds per part, and the
    process's whole wall from spawn to exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["DAMPR_TPU_TORCH_DEVICE"] = str(settings.device)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", STARTUP_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, "serve: the start-up probe failed: {}".format(
        res.stderr[-2000:]))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["process_wall"] = wall
    return out


#: The fleet phase's deployment: two rank processes on the one card, each
#: naming :data:`FLEET_LOCAL` shards of it (a global mesh of 4), a gloo
#: process group between them.
FLEET_RANKS = 2
FLEET_LOCAL = 2
FLEET_DEVICE = "cuda:0"
#: The step watchdog's deadline in the fleet phase: the kill part's rank 0
#: must exit within twice it of rank 1's death.
FLEET_TIMEOUT_MS = 6000
#: The mitigation part: rank 1 sleeps this long at every exchange step for
#: the first FLEET_SLOW_WINDOW_MS of the run (the fault grammar's windowed
#: slowness), and the run's budget keeps its exchange windows small
#: (256 KiB at D = 4), so it has windows to engage, skip, probe and
#: disengage in.
FLEET_SLOW_MS = 200
FLEET_SLOW_WINDOW_MS = 2000
FLEET_MIT_BUDGET = 32 * 1024 ** 2
#: The traced part: rank 1 enters every exchange step this late.
FLEET_LAG_MS = 150
#: The exchange budget of part (b)'s second pass.
FLEET_SMALL_HBM = 256 * 1024
#: The most seconds one pair of rank processes may take.
FLEET_PAIR_TIMEOUT = 600
#: The timed B8 step's cell (bytes from each shard to each shard: 1 MiB,
#: the mesh phase's), and the timed calls of B7 and B8 each.
FLEET_STEP_CELL = 1 << 20
FLEET_PROGRAM_REPS = 10


def records_digest(recs, ordered=False):
    """A record list's count and SHA-256 (of its reprs, in order where
    ``ordered``, else sorted): what two processes compare."""
    import hashlib

    reprs = [repr(r) for r in recs]
    if not ordered:
        reprs.sort()
    h = hashlib.sha256()
    for r in reprs:
        h.update(r.encode("utf-8"))
        h.update(b"\n")
    return {"records": len(reprs), "sha256": h.hexdigest()}


def fleet_kill_pipe(Dampr, head, chunk):
    """The kill part's resumable pipeline: a checkpointed map, then a
    non-associative group_by through the byte exchange."""
    return (Dampr.text(head, chunk)
            .map(lambda l: (len(l) % 97, l))
            .checkpoint(force=True)
            .group_by(lambda t: t[0])
            .reduce(lambda k, vs: sorted(v[1] for v in vs)[:3]))


def _fleet_part_tfidf(ctx):
    """(a) TF-IDF through the mesh fold across both ranks."""
    Dampr, DocFreq, settings = ctx["Dampr"], ctx["DocFreq"], ctx["settings"]
    settings.mesh_fold = "on"
    settings.mesh_exchange = "auto"
    out_dir = os.path.join(ctx["rdir"], "idf")
    for k in ctx["kernels"].values():
        k.launches = 0
    t0 = time.perf_counter()
    em = tfidf_pipeline(Dampr, DocFreq, ctx["head"], ctx["chunk"],
                        out_dir).run(name="fleet-tfidf")
    secs = time.perf_counter() - t0
    stats = em.stats()
    return {"seconds": secs,
            "launches": {k: kern.launches
                         for k, kern in ctx["kernels"].items()},
            "fold_segfold_launches": sum(
                st["launches"]["segfold"] for st in stats["stages"]
                if st["kind"] == "reduce"),
            "mesh": stats["mesh"],
            "sink": records_digest(part_lines(out_dir))}


def _fleet_part_exchange(ctx):
    """(b) group_by, the joins and sort_by through the byte exchange
    across both ranks, at the default budget and at 256 KiB."""
    Dampr, settings = ctx["Dampr"], ctx["settings"]
    px, pmesh = ctx["px"], ctx["pmesh"]
    settings.mesh_fold = "off"
    settings.mesh_exchange = "on"
    default = settings.exchange_hbm_budget
    rows = {}
    for label, hbm in (("default", default), ("256k", FLEET_SMALL_HBM)):
        settings.exchange_hbm_budget = hbm
        for name in ("group_by", "join", "left_join", "sort_by"):
            pipe = mesh_exchange_pipes(Dampr, ctx["head"], ctx["chunk"],
                                       ctx["head_df"])[name]
            x0 = (px.total_exchanges, px.total_steps, px.total_bytes)
            s0 = (pmesh.staging_seconds, pmesh.wire_seconds)
            t0 = time.perf_counter()
            em = pipe.run(name="fleet-x-{}-{}".format(name, label),
                          memory_budget=(
                              max(1 << 16, os.path.getsize(ctx["head"]) // 4)
                              if name == "sort_by" else None))
            recs = em.read()
            rows["{}-{}".format(name, label)] = {
                "seconds": time.perf_counter() - t0,
                "exchanges": px.total_exchanges - x0[0],
                "steps": px.total_steps - x0[1],
                "bytes": px.total_bytes - x0[2],
                "staging_seconds": pmesh.staging_seconds - s0[0],
                "wire_seconds": pmesh.wire_seconds - s0[1],
                "digest": records_digest(recs, ordered=name == "sort_by")}
    settings.exchange_hbm_budget = default
    return {"runs": rows}


def _fleet_part_mitigate(ctx):
    """(d) group_by through the exchange with the mitigation on and rank
    1 slowed for a window of the run."""
    Dampr, settings, px = ctx["Dampr"], ctx["settings"], ctx["px"]
    saved = {k: getattr(settings, k) for k in (
        "mitigate", "speculate_after_steps", "mitigate_probe_windows",
        "speculate_threshold", "exchange_timeout_ms", "faults")}
    settings.mesh_fold = "off"
    settings.mesh_exchange = "on"
    settings.mitigate = "on"
    settings.speculate_after_steps = 2
    settings.mitigate_probe_windows = 2
    settings.speculate_threshold = 1.5
    # window skipping needs the bounded-collective regime
    settings.exchange_timeout_ms = FLEET_TIMEOUT_MS
    settings.faults = ("exchange_step:rank=1,sleep_ms={},every=1,"
                       "duration_ms={},times=1000000".format(
                           FLEET_SLOW_MS, FLEET_SLOW_WINDOW_MS))
    try:
        pipe = mesh_exchange_pipes(Dampr, ctx["head"], ctx["chunk"],
                                   ctx["head_df"])["group_by"]
        x0 = px.total_exchanges
        t0 = time.perf_counter()
        em = pipe.run(name="fleet-mitigate", memory_budget=FLEET_MIT_BUDGET)
        recs = em.read()
        mit = em.stats()["mitigation"]
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        ctx["faults"].clear()  # the run's plan outlives it otherwise
    return {"seconds": time.perf_counter() - t0,
            "windows": px.total_exchanges - x0,
            "mitigation": {k: mit[k] for k in (
                "engaged", "observations", "engagements", "disengagements",
                "windows_skipped", "speculative_attempts",
                "speculative_wins", "stolen_partitions", "straggler_rank",
                "downweighted_ranks")},
            "digest": records_digest(recs)}


def _fleet_part_traced(ctx):
    """(e) a traced group_by with rank 1 late at every step: rank 0 merges
    the ranks' artifacts at finalize."""
    Dampr, settings = ctx["Dampr"], ctx["settings"]
    saved = {k: getattr(settings, k) for k in ("trace", "trace_dir",
                                               "faults")}
    settings.mesh_fold = "off"
    settings.mesh_exchange = "on"
    settings.trace = True
    settings.trace_dir = os.path.join(ctx["fdir"], "trace")
    settings.faults = "exchange_step:rank=1,sleep_ms={}".format(FLEET_LAG_MS)
    try:
        pipe = mesh_exchange_pipes(Dampr, ctx["head"], ctx["chunk"],
                                   ctx["head_df"])["group_by"]
        t0 = time.perf_counter()
        em = pipe.run(name="fleet-traced")
        recs = em.read()
        stats = em.stats()
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        ctx["faults"].clear()
    fl = stats.get("fleet") or {}
    skew = fl.get("skew") or {}
    return {"seconds": time.perf_counter() - t0,
            "digest": records_digest(recs),
            "merged": bool(fl),
            "alignment": fl.get("alignment"),
            "missing_ranks": fl.get("missing_ranks"),
            "straggler_rank": skew.get("straggler_rank"),
            "late_ratio": skew.get("late_ratio"),
            "skew_seconds": skew.get("skew_seconds"),
            "steps": len(skew.get("steps") or ()),
            "merged_trace_file": fl.get("merged_trace_file"),
            "clock": stats["process"].get("clock")}


def _fleet_part_programs(ctx):
    """B7 and B8 across the ranks, timed on the host clock around calls
    that end synchronized (a fetch, or ``torch.cuda.synchronize``): the
    keyed fold of the head's DocFreq lanes (local fold, the all_to_all
    across the ranks, the final fold, the all_gather of the ``gather``
    variant); one exchange of :data:`FLEET_STEP_CELL` bytes a cell with
    the exchange's codec off (its pack, the step, the unpack); and that
    step alone (the all_to_all of the ``[D*D, C]`` buffer and its
    lengths, the gather of what the shards received).  Each with its
    host staging (copies) and gloo (wire) seconds a call."""
    import numpy as np
    from dampr_tpu_torch.ops import text
    from dampr_tpu_torch.parallel import shuffle

    px, pmesh, settings = ctx["px"], ctx["pmesh"], ctx["settings"]
    mesh = pmesh.data_mesh()
    h1, h2, v = docfreq_lanes(np, text, ctx["head"])
    D = pmesh.mesh_size(mesh)
    rng = np.random.RandomState(5)
    C = FLEET_STEP_CELL
    blobs = {(s, d): rng.bytes(C) for s in range(D) for d in range(D)}
    buf = np.frombuffer(b"".join(blobs[(s, d)] for s in range(D)
                                 for d in range(D)),
                        dtype=np.uint8).reshape(D * D, C)
    lens = np.full(D * D, C, dtype=np.int32)

    def step():
        out = px._exchange_step(mesh, buf, lens)
        px._synchronize(mesh)
        return out

    def timed(fn):
        fn()
        fn()
        s0 = (pmesh.staging_seconds, pmesh.wire_seconds,
              pmesh.cross_rank_calls, pmesh.cross_rank_bytes)
        t0 = time.perf_counter()
        for _ in range(FLEET_PROGRAM_REPS):
            out = fn()
        n = FLEET_PROGRAM_REPS
        return out, {
            "ms": (time.perf_counter() - t0) * 1e3 / n,
            "staging_ms": (pmesh.staging_seconds - s0[0]) * 1e3 / n,
            "wire_ms": (pmesh.wire_seconds - s0[1]) * 1e3 / n,
            "collectives": (pmesh.cross_rank_calls - s0[2]) // n,
            "bytes_sent": (pmesh.cross_rank_bytes - s0[3]) // n}

    _out, b7 = timed(lambda: shuffle.mesh_keyed_fold(mesh, h1, h2, v, "sum"))
    codec = settings.exchange_codec
    settings.exchange_codec = "off"
    try:
        out, b8 = timed(lambda: px.mesh_blob_exchange(mesh, blobs,
                                                      budget=1 << 30))
        steps = px.last_info["steps"]
    finally:
        settings.exchange_codec = codec
    check(out == blobs, "fleet: the timed exchange changed its bytes")
    (rb, rl), b8_step = timed(step)
    check(all(int(t[s]) == C for t in rl for s in range(D))
          and bytes(rb[D - 1][0].cpu().numpy()) == blobs[(0, D - 1)],
          "fleet: the timed exchange step delivered other bytes")
    b7["rows"] = int(len(h1))
    b8.update(steps=steps, cell_bytes=C)
    b8_step["cell_bytes"] = C
    return {"B7": b7, "B8": b8, "B8-step": b8_step, "shards": D}


def _fleet_part_kill(ctx):
    """(c) a resumable traced run in which rank 1 dies at its first
    exchange step; rank 0's watchdog ends it.  Neither rank returns."""
    Dampr, settings = ctx["Dampr"], ctx["settings"]
    settings.mesh_fold = "off"
    settings.mesh_exchange = "on"
    settings.trace = True
    settings.exchange_timeout_ms = FLEET_TIMEOUT_MS
    settings.faults = "rank_kill:rank=1,nth=1,exit=137"
    fleet_kill_pipe(Dampr, ctx["head"], ctx["chunk"]).run(
        name="fleet-kill", resume=True)
    return {"completed": True}  # never reached: a failed check


FLEET_PARTS = {"a": _fleet_part_tfidf, "b": _fleet_part_exchange,
               "c": _fleet_part_kill, "d": _fleet_part_mitigate,
               "e": _fleet_part_traced, "t": _fleet_part_programs}


def fleet_rank_main(rank, port, fdir, parts):
    """One rank process of the fleet phase: join the gloo group, run the
    named parts in order, print one ``fleet-part`` JSON line each."""
    import traceback

    with open(os.path.join(fdir, "spec.json")) as f:
        spec = json.load(f)
    from dampr_tpu_torch import Dampr, faults, settings
    from dampr_tpu_torch.ops.text import DocFreq
    from dampr_tpu_torch.parallel import exchange as px
    from dampr_tpu_torch.parallel import mesh as pmesh
    from dampr_tpu_torch.runner import KERNELS

    settings.device = spec["device"]
    settings.mesh_devices = "{}*{}".format(spec["shard_device"], FLEET_LOCAL)
    rdir = os.path.join(fdir, "rank{}".format(rank))
    os.makedirs(rdir, exist_ok=True)
    settings.scratch_root = os.path.join(rdir, "scratch")
    t0 = time.perf_counter()
    pmesh.init_distributed("localhost:{}".format(port), FLEET_RANKS, rank)
    ctx = {"Dampr": Dampr, "DocFreq": DocFreq, "settings": settings,
           "faults": faults, "px": px, "pmesh": pmesh, "kernels": KERNELS, "rdir": rdir,
           "fdir": fdir, "head": spec["head"], "chunk": spec["chunk"],
           "head_df": dict(spec["head_df"])}
    print("fleet-part " + json.dumps({
        "part": "join", "rank": rank, "seconds": time.perf_counter() - t0,
        "process": pmesh.process_info(), "clock": pmesh.clock_sync}),
        flush=True)
    for part in parts:
        try:
            row = FLEET_PARTS[part](ctx)
        except Exception:
            traceback.print_exc()
            return 1
        row.update(part=part, rank=rank)
        print("fleet-part " + json.dumps(row), flush=True)
    return 0


def _fleet_pair(fdir, parts, device):
    """Start the two rank processes of ``parts`` and wait for both.
    Returns ``[(returncode, exit_time, rows)]`` by rank (the time each
    exit was seen, polled every 10 ms)."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.abspath(__file__)
    env = dict(os.environ, DAMPR_TPU_TORCH_DEVICE=device)
    env.pop("DAMPR_TPU_TORCH_COORDINATOR", None)
    procs, errs = [], []
    for r in range(FLEET_RANKS):
        err = open(os.path.join(fdir, "rank{}-{}.err".format(r, parts)),
                   "w")
        errs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, here, "--fleet-rank", str(r), "--fleet-port",
             str(port), "--fleet-dir", fdir, "--fleet-parts", parts],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env,
            cwd=os.path.dirname(here)))
    outs = [[] for _ in procs]
    exits = [None] * len(procs)
    import threading

    def drain(i):
        for line in procs[i].stdout:
            outs[i].append(line)

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    deadline = time.time() + FLEET_PAIR_TIMEOUT
    try:
        while None in exits:
            for i, p in enumerate(procs):
                if exits[i] is None and p.poll() is not None:
                    exits[i] = time.time()
            check(time.time() < deadline,
                  "fleet: rank processes of parts {} past {} s".format(
                      parts, FLEET_PAIR_TIMEOUT))
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=10)
        for e in errs:
            e.close()
    result = []
    for i, p in enumerate(procs):
        rows = {}
        for line in outs[i]:
            if line.startswith("fleet-part "):
                row = json.loads(line.split(" ", 1)[1])
                rows[row["part"]] = row
        result.append((p.returncode, exits[i], rows))
    return result


def _fleet_err_tail(fdir, rank, parts):
    with open(os.path.join(fdir, "rank{}-{}.err".format(rank, parts))) as f:
        return f.read()[-3000:]


def phase_fleet(Dampr, DocFreq, settings, workdir, head, head_df,
                head_n_lines, require_launches=True):
    """The mesh across processes: two rank processes on the
    one card, each with ``settings.mesh_devices = "cuda:0*2"`` (a global
    mesh of 4 shards), a gloo process group between them, over the
    corpus's 16 MB head; the first pair runs parts (a), (b), (d) and (e)
    in one process each (``import torch`` paid once) and times B7 and B8
    across the ranks, a second pair part (c):

    (a) TF-IDF through the mesh fold across both ranks: each rank's sink
        lines equal the one-process run's and the oracle; each rank's K1,
        K2 and B4 launches, K2 launched in each rank's fold;
    (b) group_by, an inner and a left join and sort_by through the byte
        exchange across the ranks, at the default budget and at 256 KiB:
        records equal the one-process run's on both ranks;
    (c) ``rank_kill`` on rank 1 at its first exchange step: rank 1 exits
        137, rank 0's watchdog exits 70 within twice
        ``exchange_timeout_ms`` of rank 1's death, both crashdumps
        validate and name their rank, and a ``resume="auto"`` rerun in
        this process (the stage kept on the host for the recorded
        timeout) reads back the records of a cold run;
    (d) ``mitigate = "on"`` with rank 1 slowed for a window of the run:
        the controllers engage, skip at least one window, probe and
        disengage, the same on both ranks, and the records equal the cold
        run's;
    (e) a traced run with rank 1 late at every step: rank 0's merge names
        rank 1 the straggler, aligned on the clock handshake, and the
        merged trace validates.

    Prints one ``fleet`` JSON line; returns each rank's kernel launches
    in part (a)."""
    fdir = os.path.join(workdir, "fleet")
    os.makedirs(fdir, exist_ok=True)
    chunk = os.path.getsize(head) // 8 + 1
    with open(os.path.join(fdir, "spec.json"), "w") as f:
        json.dump({"head": head, "chunk": chunk,
                   "head_df": sorted(head_df.items()),
                   "device": str(settings.device),
                   "shard_device": FLEET_DEVICE}, f)
    # -- the one-process runs the ranks are held against --------------------
    saved = {k: getattr(settings, k) for k in (
        "mesh_devices", "mesh_fold", "mesh_exchange", "scratch_root",
        "exchange_hbm_budget")}
    t0 = time.perf_counter()
    settings.scratch_root = os.path.join(fdir, "one", "scratch")
    ref = {}
    try:
        settings.mesh_devices = None
        settings.mesh_fold = "auto"
        settings.mesh_exchange = "off"
        one_dir = os.path.join(fdir, "one", "idf")
        tfidf_pipeline(Dampr, DocFreq, head, chunk, one_dir).run(
            name="fleet-one-tfidf")
        one_lines = part_lines(one_dir)
        check(one_lines == tfidf_oracle_lines(head_df, head_n_lines),
              "fleet: the one-process TF-IDF of the head differs from the "
              "oracle")
        ref["tfidf"] = records_digest(one_lines)
        pipes = mesh_exchange_pipes(Dampr, head, chunk, head_df)
        for name, pipe in pipes.items():
            em = pipe.run(name="fleet-one-" + name, memory_budget=(
                max(1 << 16, os.path.getsize(head) // 4)
                if name == "sort_by" else None))
            ref[name] = records_digest(em.read(),
                                       ordered=name == "sort_by")
        cold = fleet_kill_pipe(Dampr, head, chunk).run(name="fleet-cold")
        ref["kill"] = records_digest(cold.read())
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
    one_s = time.perf_counter() - t0

    # -- pair 1: parts a, b, d, e ----------------------------------------------
    t0 = time.perf_counter()
    pair = _fleet_pair(fdir, "abdet", str(settings.device))
    pair_s = time.perf_counter() - t0
    for r, (rc, _t, rows) in enumerate(pair):
        check(rc == 0, "fleet: rank {} exited {}: {}".format(
            r, rc, _fleet_err_tail(fdir, r, "abdet")))
        check(set(rows) == {"join", "a", "b", "d", "e", "t"},
              "fleet: rank {} printed parts {}".format(r, sorted(rows)))
    rows = [p[2] for p in pair]
    for r, rr in enumerate(rows):
        proc = rr["join"]["process"]
        check(proc["global_devices"] == FLEET_RANKS * FLEET_LOCAL
              and proc["multiprocess"],
              "fleet: rank {} sees {}".format(r, proc))
        a = rr["a"]
        check(a["sink"] == ref["tfidf"],
              "fleet (a): rank {}'s TF-IDF sink lines differ from the "
              "one-process run's".format(r))
        check(a["mesh"]["devices"] == FLEET_RANKS * FLEET_LOCAL
              and a["mesh"]["folds"] > 0,
              "fleet (a): rank {}'s fold did not run over the global mesh: "
              "{}".format(r, a["mesh"]))
        if require_launches:
            check(a["fold_segfold_launches"] > 0,
                  "fleet (a): K2 never launched in rank {}'s fold".format(r))
            for name, n in a["launches"].items():
                check(n > 0, "fleet (a): kernel {} never launched on rank "
                             "{}".format(name, r))
        for key, row in rr["b"]["runs"].items():
            name = key.rsplit("-", 1)[0]
            check(row["digest"] == ref[name],
                  "fleet (b): rank {}'s {} differs from the one-process "
                  "run's".format(r, key))
            check(row["exchanges"] > 0 and row["steps"] > 0,
                  "fleet (b): rank {}'s {} never crossed the mesh".format(
                      r, key))
        d = rr["d"]
        check(d["digest"] == ref["group_by"],
              "fleet (d): rank {}'s mitigated group_by differs from the "
              "cold run".format(r))
        mit = d["mitigation"]
        check(mit["engagements"] >= 1 and mit["windows_skipped"] >= 1
              and mit["disengagements"] >= 1 and not mit["engaged"],
              "fleet (d): rank {}'s mitigation did not engage, skip and "
              "disengage: {} over {} windows".format(r, mit, d["windows"]))
        check(mit["straggler_rank"] == 1,
              "fleet (d): the straggler is not rank 1: {}".format(mit))
        check(rr["e"]["digest"] == ref["group_by"],
              "fleet (e): rank {}'s traced group_by differs".format(r))
    shared = ("observations", "engagements", "disengagements",
              "windows_skipped", "straggler_rank", "downweighted_ranks")
    check({k: rows[0]["d"]["mitigation"][k] for k in shared}
          == {k: rows[1]["d"]["mitigation"][k] for k in shared},
          "fleet (d): the ranks' controllers disagree")
    e0 = rows[0]["e"]
    check(e0["merged"] and e0["missing_ranks"] == []
          and e0["alignment"] == "clock",
          "fleet (e): rank 0 did not merge both ranks on the clock: "
          "{}".format(e0))
    check(e0["straggler_rank"] == 1,
          "fleet (e): the merge names rank {} the straggler".format(
              e0["straggler_rank"]))
    validate_trace_file(e0["merged_trace_file"], "exchange")

    # -- pair 2: part c, the kill ---------------------------------------------
    t0 = time.perf_counter()
    kill = _fleet_pair(fdir, "c", str(settings.device))
    kill_s = time.perf_counter() - t0
    (rc0, t_0, _r0), (rc1, t_1, _r1) = kill
    check(rc1 == 137, "fleet (c): rank 1 exited {}, not 137: {}".format(
        rc1, _fleet_err_tail(fdir, 1, "c")))
    check(rc0 == 70, "fleet (c): rank 0 exited {}, not 70: {}".format(
        rc0, _fleet_err_tail(fdir, 0, "c")))
    latency = t_0 - t_1
    check(latency <= 2 * FLEET_TIMEOUT_MS / 1000.0,
          "fleet (c): rank 0 aborted {:.3f} s after rank 1's death, past "
          "{:.1f} s".format(latency, 2 * FLEET_TIMEOUT_MS / 1000.0))
    dumps = {
        0: os.path.join(fdir, "rank0", "scratch", "fleet-kill", "trace",
                        "crashdump.json"),
        1: os.path.join(fdir, "rank1", "scratch", "fleet-kill", "trace",
                        "rank1", "crashdump.rank1.json")}
    reasons = {}
    for r, path in dumps.items():
        check(os.path.isfile(path), "fleet (c): rank {} left no crashdump "
                                    "at {}".format(r, path))
        validate_trace_file(path)
        with open(path) as f:
            other = json.load(f)["otherData"]
        check(other["process"]["process_id"] == r,
              "fleet (c): rank {}'s crashdump names rank {}".format(
                  r, other["process"]["process_id"]))
        reasons[r] = other["crash"]["reason"]
    check(reasons == {0: "exchange-timeout", 1: "fault-injected-kill"},
          "fleet (c): crash reasons {}".format(reasons))
    saved = {k: getattr(settings, k) for k in (
        "mesh_devices", "mesh_fold", "mesh_exchange", "scratch_root")}
    t0 = time.perf_counter()
    try:
        # one process over the global mesh's shards: the planner has a mesh
        # to keep the stage off, for the recorded timeout
        settings.mesh_devices = "{}*{}".format(
            FLEET_DEVICE, FLEET_RANKS * FLEET_LOCAL)
        settings.mesh_fold = "off"
        settings.mesh_exchange = "auto"
        settings.scratch_root = os.path.join(fdir, "rank0", "scratch")
        em = fleet_kill_pipe(Dampr, head, chunk).run(name="fleet-kill",
                                                      resume="auto")
        resumed = records_digest(em.read())
        kinds = [s["kind"] for s in em.stats]
        shuffle = (em.stats().get("plan") or {}).get("shuffle") or {}
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
    resume_s = time.perf_counter() - t0
    check(any(k.startswith("resumed-") for k in kinds),
          "fleet (c): the rerun restored nothing: {}".format(kinds))
    degraded = [t for t in shuffle.get("targets") or ()
                if "fault-history" in (t.get("reason") or "")]
    check(degraded and all(t["target"] == "host" for t in degraded),
          "fleet (c): the rerun did not keep the stage on the host: "
          "{}".format(shuffle))
    check(resumed == ref["kill"],
          "fleet (c): the resumed run differs from the cold run")

    def per_rank(part, key):
        return [rows[r][part][key] for r in range(FLEET_RANKS)]

    line = {
        "run": "fleet", "ranks": FLEET_RANKS, "local_shards": FLEET_LOCAL,
        "global_shards": FLEET_RANKS * FLEET_LOCAL, "backend": "gloo",
        "head_bytes": os.path.getsize(head),
        "one_process_seconds": one_s, "pair_seconds": pair_s,
        "join_seconds": per_rank("join", "seconds"),
        "clock": per_rank("join", "clock"),
        "a": {"seconds": per_rank("a", "seconds"),
              "launches": per_rank("a", "launches"),
              "fold_segfold_launches": per_rank("a",
                                                "fold_segfold_launches"),
              "host_staging": [rows[r]["a"]["mesh"]["exchange"].get(
                  "host_staging") for r in range(FLEET_RANKS)]},
        "b": {key: {"seconds": [rows[r]["b"]["runs"][key]["seconds"]
                                for r in range(FLEET_RANKS)],
                    "steps": rows[0]["b"]["runs"][key]["steps"],
                    "bytes": rows[0]["b"]["runs"][key]["bytes"],
                    "staging_seconds": [
                        rows[r]["b"]["runs"][key]["staging_seconds"]
                        for r in range(FLEET_RANKS)],
                    "wire_seconds": [
                        rows[r]["b"]["runs"][key]["wire_seconds"]
                        for r in range(FLEET_RANKS)]}
              for key in rows[0]["b"]["runs"]},
        "c": {"seconds": kill_s, "abort_latency_seconds": latency,
              "bound_seconds": 2 * FLEET_TIMEOUT_MS / 1000.0,
              "resume_seconds": resume_s, "restored": kinds},
        "d": {"seconds": per_rank("d", "seconds"),
              "windows": per_rank("d", "windows"),
              "mitigation": per_rank("d", "mitigation")},
        "programs": {name: [rows[r]["t"][name]
                            for r in range(FLEET_RANKS)]
                     for name in ("B7", "B8", "B8-step")},
        "e": {"seconds": per_rank("e", "seconds"),
              "alignment": e0["alignment"],
              "straggler_rank": e0["straggler_rank"],
              "late_ratio": e0["late_ratio"],
              "skew_seconds": e0["skew_seconds"], "steps": e0["steps"]},
    }
    log("fleet " + json.dumps(line))
    return {name: [rows[r]["a"]["launches"][name]
                   for r in range(FLEET_RANKS)]
            for name in rows[0]["a"]["launches"]}


def phase_serve(Dampr, DocFreq, TokenCounts, settings, workdir, corpus,
                chunk, nbytes, df, tc, n_lines, plain_lines, seed):
    """The serve daemon and the cross-run cache on the card, at the full
    corpus, one ``serve`` line per step.  The daemon runs as its own
    process (2 worker slots, its own scratch root and cache directory,
    started after the kernels are built); each job runs in a worker
    process on the card.  Throughout, the daemon's pid never holds a
    CUDA context (``nvidia-smi --query-compute-apps``, polled), and with
    no job running the card lists no more contexts than before the
    daemon started (counted: a container's pids need not be the ones
    ``nvidia-smi`` reports).

    (a) ``serve-cold``: tenant A submits the TF-IDF pipeline through
        ``idf`` (read back): its lines equal the ``tfidf`` phase's sink
        and the oracle; the worker's stats show DocFreq lowered, K1, K2
        and B4 launched, stages published;
    (b) ``serve-hit``: tenant B, the same plan after A's job finished:
        equal, ``reuse.hits`` >= 1, no device batch and no launch;
    (c) ``serve-coalesce``: two tenants submit one (new) plan back to
        back: one job directory, one result, the coalesce counted once;
    (d) ``serve-concurrent``: TF-IDF and TokenCounts with the cache off,
        each alone and then both at once on two workers sharing the card:
        exact, each job's wall beside its wall alone;
    (e) ``serve-incremental``: TF-IDF over the corpus split into 8 files,
        then over the 8 plus a 9th: the DocFreq stage is incremental and
        the lines equal a cold in-process run over the 9 files with the
        cache off, and the oracle;
    (f) ``serve-cancel``: a TF-IDF job cancelled once its worker holds a
        context: exit 143, a crashdump that validates, the worker's
        context gone after the reap;
    (g) ``serve-metrics``: ``/metrics`` carries per-tenant labels,
        ``/healthz`` answers;
    (h) ``serve-overhead``: DocFreq over a 1 MB head, served (cache off)
        against the same plan run warm in this process: the worker's
        start-up; ``serve-startup`` splits it in a fresh process (``import
        torch``, the package, the CUDA context, the kernels' ``dlopen``,
        and a small fold's first run against its second).

    Returns the cold run's launches (the worker's counters)."""
    import urllib.request

    from dampr_tpu_torch.serve.client import ServeClient

    want = tfidf_oracle_lines(df, n_lines)
    check(plain_lines == want, "serve: the tfidf phase's lines are not the "
                               "oracle's")
    state_dir = os.path.join(workdir, "serve-state")
    scratch = os.path.join(workdir, "serve-scratch")
    cache = os.path.join(workdir, "serve-cache")
    watch = ContextWatch().start()
    proc, url, dpid = start_daemon(settings, workdir, state_dir, scratch,
                                   cache, 2)
    client = ServeClient(url)
    lines = {}
    idle = []

    def idle_check(label):
        """With no job running, the card lists no more contexts than
        before the daemon started: the daemon holds none, and a finished
        worker's is gone.  Counted, since a container's pids need not be
        the ones ``nvidia-smi`` reports."""
        deadline = time.time() + 30
        while client.health()["running"] and time.time() < deadline:
            time.sleep(0.1)
        n = None
        while time.time() < deadline:
            n = len(compute_apps())
            if n <= watch.baseline:
                break
            time.sleep(0.2)
        idle.append((label, n))
        check(n is not None and n <= watch.baseline,
              "serve: {} contexts listed with no job running after {} "
              "(baseline {}): the daemon or a finished worker holds one"
              .format(n, label, watch.baseline))

    def tfidf(path, ch):
        docs = Dampr.text(path, ch)
        doc_freq = (docs.custom_mapper(
            DocFreq(mode="word", lower=True, pair_values=False))
            .fold_values(operator.add))
        return doc_freq.cross_right(
            docs.len(),
            lambda d, total: (d[0], d[1],
                              math.log(1 + (float(total) / d[1]))),
            memory=True)

    def counts(path, ch):
        return (Dampr.text(path, ch)
                .custom_mapper(TokenCounts(mode="word", lower=True,
                                           pair_values=False))
                .fold_values(operator.add))

    try:
        check(client.health()["status"] == "ok", "serve: /healthz not ok")
        idle_check("start")
        # (a) cold
        job = tfidf(corpus, chunk).submit(url, tenant="tenant-a")
        row, meta, stats, secs = served(job, state_dir)
        check(row["state"] == "done", "serve-cold failed: {}".format(row))
        got = idf_lines(job.result())
        check(got == plain_lines == want,
              "serve-cold lines differ from the tfidf phase's")
        dev = stats.get("device") or {}
        check(dev.get("device_stages", 0) >= 1,
              "serve-cold: DocFreq did not lower in the worker")
        cold_launches = dict(dev.get("kernels") or {})
        for name in ("fnv", "segfold", "handoff", "rows"):
            check(cold_launches.get(name, 0) > 0,
                  "serve-cold: kernel {} never launched in the worker"
                  .format(name))
        ru = meta.get("reuse") or {}
        check(ru.get("enabled") and ru.get("bytes_published", 0) > 0,
              "serve-cold: nothing published: {}".format(ru))
        lines["cold"] = serve_line("serve-cold", row, meta, stats, secs,
                                   mb_per_s=nbytes / 1e6 / secs)

        # (b) hit
        job = tfidf(corpus, chunk).submit(url, tenant="tenant-b")
        row, meta, stats, secs = served(job, state_dir)
        check(row["state"] == "done", "serve-hit failed: {}".format(row))
        check(idf_lines(job.result()) == want,
              "serve-hit lines differ from the oracle")
        ru = meta.get("reuse") or {}
        dev = stats.get("device") or {}
        check(ru.get("hits", 0) >= 1, "serve-hit: no hit: {}".format(ru))
        check(dev.get("batches", -1) == 0
              and not any((dev.get("kernels") or {}).values()),
              "serve-hit: the worker dispatched to the card: {}".format(dev))
        lines["hit"] = serve_line("serve-hit", row, meta, stats, secs)
        idle_check("serve-hit")

        # (c) coalesce: a plan not cached yet, submitted twice at once
        jobs_before = set(os.listdir(os.path.join(state_dir, "jobs")))
        plan_c = counts(corpus, chunk)
        j1 = plan_c.submit(url, tenant="tenant-a")
        j2 = plan_c.submit(url, tenant="tenant-c")
        check(j2.state == "coalesced" and j2.primary == j1.id,
              "serve-coalesce: the second submission ran on its own: "
              "{} {}".format(j2.state, j2.primary))
        row, meta, stats, secs = served(j1, state_dir)
        row2 = j2.wait(timeout_s=600)
        check(row["state"] == row2["state"] == "done",
              "serve-coalesce failed: {} {}".format(row, row2))
        check(j1.result_bytes() == j2.result_bytes(),
              "serve-coalesce: the two clients read different bytes")
        check(sorted(j1.read()) == sorted(tc.items()),
              "serve-coalesce: TokenCounts differs from the oracle")
        new_dirs = set(os.listdir(os.path.join(state_dir, "jobs"))) \
            - jobs_before
        check(new_dirs == {j1.id},
              "serve-coalesce: job directories {}".format(sorted(new_dirs)))
        metrics = client.metrics()
        check('dampr_tpu_serve_events_total{code="serve-coalesce"} 1'
              in metrics, "serve-coalesce: not counted once")
        lines["coalesce"] = serve_line("serve-coalesce", row, meta, stats,
                                       secs, followers=row["coalesced"],
                                       job_dirs=len(new_dirs))
        idle_check("serve-coalesce")

        # (d) concurrent, the cache off: each alone, then both at once
        alone = {}
        for what, build, tenant in (("tfidf", tfidf, "tenant-a"),
                                    ("counts", counts, "tenant-b")):
            j = build(corpus, chunk).submit(url, tenant=tenant, reuse="off")
            r, m, s, sec = served(j, state_dir)
            check(r["state"] == "done", "serve-concurrent: {} alone "
                                        "failed: {}".format(what, r))
            alone[what] = (sec, r["wall_s"], m.get("wall_seconds"))
        t0 = time.perf_counter()
        ja = tfidf(corpus, chunk).submit(url, tenant="tenant-a",
                                         reuse="off")
        jb = counts(corpus, chunk).submit(url, tenant="tenant-b",
                                          reuse="off")
        ra, ma, sa, seca = served(ja, state_dir, t0)
        rb, mb, sb, secb = served(jb, state_dir, t0)
        both = time.perf_counter() - t0
        check(ra["state"] == rb["state"] == "done",
              "serve-concurrent failed: {} {}".format(ra, rb))
        check(idf_lines(ja.result()) == want,
              "serve-concurrent: TF-IDF differs from the oracle")
        check(sorted(jb.read()) == sorted(tc.items()),
              "serve-concurrent: TokenCounts differs from the oracle")
        check(ma.get("pid") != mb.get("pid"),
              "serve-concurrent: one worker process ran both jobs")
        for what, r, m, s, sec in (("tfidf", ra, ma, sa, seca),
                                   ("counts", rb, mb, sb, secb)):
            lines["concurrent-" + what] = serve_line(
                "serve-concurrent", r, m, s, sec, pipeline=what,
                alone_seconds=alone[what][0],
                alone_worker_wall=alone[what][1],
                alone_run_wall=alone[what][2], both_seconds=both)

        # (e) incremental: 8 files, then a 9th appended
        inc_dir = os.path.join(workdir, "serve-incremental")
        os.makedirs(inc_dir)
        with open(corpus) as f:
            all_lines = f.readlines()
        per = (len(all_lines) + 7) // 8
        for i in range(8):
            with open(os.path.join(inc_dir, "part{}.txt".format(i)),
                      "w") as f:
                f.writelines(all_lines[i * per:(i + 1) * per])
        del all_lines
        inc_chunk = os.path.getsize(os.path.join(inc_dir, "part0.txt")) + 1
        row, meta, stats, secs = served(
            tfidf(inc_dir, inc_chunk).submit(url, tenant="tenant-a"),
            state_dir)
        check(row["state"] == "done",
              "serve-incremental: the 8-file run failed: {}".format(row))
        lines["incremental-8"] = serve_line("serve-incremental", row, meta,
                                            stats, secs, files=8)
        ninth = os.path.join(workdir, "ninth.txt")
        make_corpus(ninth, 16, seed + 1)
        _tc9, df9, n9, _wc9 = oracle(ninth)
        shutil.move(ninth, os.path.join(inc_dir, "part8.txt"))
        job = tfidf(inc_dir, inc_chunk).submit(url, tenant="tenant-b")
        row, meta, stats, secs = served(job, state_dir)
        check(row["state"] == "done",
              "serve-incremental: the 9-file run failed: {}".format(row))
        got = idf_lines(job.result())
        old_reuse = settings.reuse
        settings.reuse = "off"
        try:
            cold = idf_lines(tfidf(inc_dir, inc_chunk).run(
                name="chip-serve-incremental-cold").dataset.read())
        finally:
            settings.reuse = old_reuse
        check(got == cold == tfidf_oracle_lines(df + df9, n_lines + n9),
              "serve-incremental: the 9-file lines differ from a cold run")
        ru = meta.get("reuse") or {}
        ops = {s_.get("stage"): s_.get("op")
               for s_ in stats.get("stages") or ()}
        incr = [d["stage"] for d in ru.get("decisions") or ()
                if d["decision"].startswith("incremental:")]
        check(ru.get("incremental_merges", 0) >= 1
              and any("DocFreq" in str(ops.get(s_)) for s_ in incr),
              "serve-incremental: DocFreq was not incremental: {} {}".format(
                  ru.get("decisions"), ops))
        lines["incremental-9"] = serve_line(
            "serve-incremental", row, meta, stats, secs, files=9,
            incremental_stages=incr)

        # (f) cancel a job whose worker holds a context
        before = {p for p, _m in compute_apps()}
        check(dpid not in before, "serve: the daemon holds a CUDA context")
        job = tfidf(corpus, chunk).submit(url, tenant="tenant-a",
                                          reuse="off")
        trace_dir = os.path.join(state_dir, "jobs", job.id, "trace")
        deadline = time.time() + 120
        holder = None
        while time.time() < deadline and holder is None:
            if os.path.isdir(trace_dir) and os.listdir(trace_dir):
                apps = compute_apps()
                fresh = [p for p, _m in apps if p not in before]
                if fresh or (not watch.own_visible
                             and len(apps) > len(before)):
                    holder = fresh[0] if fresh else -1
            time.sleep(0.1)
        check(holder is not None, "serve-cancel: the worker never held a "
                                  "CUDA context")
        time.sleep(0.5)
        t0 = time.perf_counter()
        job.cancel()
        row = job.wait(timeout_s=300, interval_s=0.05)
        secs = time.perf_counter() - t0
        check(row["state"] == "cancelled" and row["exit_code"] == 143,
              "serve-cancel: {}".format(row))
        check(row.get("crashdump") and os.path.isfile(row["crashdump"]),
              "serve-cancel: no crashdump")
        validate_trace_file(row["crashdump"])
        with open(os.path.join(state_dir, "jobs", job.id,
                               "error.json")) as f:
            err = json.load(f)
        gone = False
        deadline = time.time() + 30
        while time.time() < deadline and not gone:
            apps = compute_apps()
            gone = (err.get("pid") not in {p for p, _m in apps}
                    and (watch.own_visible or len(apps) <= len(before)))
            if not gone:
                time.sleep(0.2)
        check(gone, "serve-cancel: the cancelled worker's context is "
                    "still listed")
        lines["cancel"] = {"step": "serve-cancel", "seconds": secs,
                           "exit_code": row["exit_code"],
                           "crashdump": os.path.basename(row["crashdump"]),
                           "worker_pid": err.get("pid"),
                           "context_pid_seen": holder,
                           "error": err.get("type")}
        log("serve " + json.dumps(lines["cancel"]))

        # (g) metrics and health
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        for tenant in ("tenant-a", "tenant-b", "tenant-c"):
            check('dampr_tpu_serve_jobs{{tenant="{}",state="done"}}'
                  .format(tenant) in text,
                  "serve-metrics: no done jobs for {}".format(tenant))
        check('dampr_tpu_serve_reuse_hits_total{tenant="tenant-b"}' in text,
              "serve-metrics: tenant-b's hits are not exposed")
        health = client.health()
        check(health["status"] == "ok", "serve-metrics: /healthz {}".format(
            health))
        lines["metrics"] = {"step": "serve-metrics",
                            "exposition_lines": len(text.splitlines()),
                            "health": health}
        log("serve " + json.dumps(lines["metrics"]))
        idle_check("serve-cancel")

        # (h) the worker's start-up: trivial and small device plans
        head1 = os.path.join(workdir, "serve-head-1mb.txt")
        head_lines(corpus, head1, 1024 ** 2)
        for what, build in (
                ("docfreq-1mb", lambda: Dampr.text(head1).custom_mapper(
                    DocFreq(mode="word", lower=True, pair_values=False))
                 .fold_values(operator.add)),):
            local_secs = []
            for i in range(2):  # the first pays this process's first use
                t0 = time.perf_counter()
                local = build().run(name="chip-serve-local-" + what)
                local_recs = list(local.dataset.read())
                local_secs.append(time.perf_counter() - t0)
            job = build().submit(url, tenant="tenant-o", reuse="off")
            row, meta, stats, secs = served(job, state_dir)
            check(row["state"] == "done" and job.result() == local_recs,
                  "serve-overhead: {} served differs from in-process"
                  .format(what))
            lines["overhead-" + what] = serve_line(
                "serve-overhead", row, meta, stats, secs, plan=what,
                in_process_seconds=local_secs[1],
                in_process_first_seconds=local_secs[0],
                startup_seconds=secs - local_secs[1],
                outside_run_seconds=row["wall_s"] - meta["wall_seconds"])
        idle_check("serve-overhead")
        lines["startup"] = {"step": "serve-startup",
                            "seconds": startup_breakdown(settings)}
        log("serve " + json.dumps(lines["startup"]))
    finally:
        stop_daemon(proc)
        watch.stop()
    check(dpid not in watch.pids,
          "serve: the daemon's pid {} held a CUDA context".format(dpid))
    check(proc.returncode == 0, "serve: the daemon exited {}".format(
        proc.returncode))
    log("serve " + json.dumps({
        "step": "serve-contexts", "daemon_pid": dpid,
        "pids_seen": sorted(watch.pids), "samples": watch.samples,
        "baseline_apps": watch.baseline, "max_apps": watch.max_apps,
        "idle_checks": idle, "pid_match": watch.own_visible}))
    return cold_launches


TOOLING_TRIALS = 3


def tool_env(settings, scratch, **extra):
    """The environment of a ``python -m dampr_tpu_torch.cli`` process:
    this checkout on the path, this process's device, the given scratch
    root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({"DAMPR_TPU_TORCH_SCRATCH": scratch,
                "DAMPR_TPU_TORCH_DEVICE": str(settings.device)})
    env.update(extra)
    return env


def run_tools(env, calls, timeout):
    """``python -m dampr_tpu_torch.cli`` calls, all started at once (each
    pays ``import torch``): ``{name: (exit code, stdout, stderr,
    seconds)}`` for ``calls``, a ``{name: argv}`` map."""
    t0 = time.perf_counter()
    procs = {what: subprocess.Popen(
        [sys.executable, "-m", "dampr_tpu_torch.cli"] + list(argv),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for what, argv in calls.items()}
    out = {}
    try:
        for what, p in procs.items():
            stdout, stderr = p.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out[what] = (p.returncode, stdout, stderr,
                         time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def sentry_verdict(settings, scratch):
    """The exit code ``sentry bench-tfidf --strict`` must give: 2 when
    the sentry's ``detect`` finds a regression in the newest point of the
    bench's telemetry series under ``scratch``, else 0."""
    from dampr_tpu_torch.obs import sentry, timeseries

    old = settings.scratch_root
    settings.scratch_root = scratch
    try:
        points = timeseries.load("bench-tfidf")
    finally:
        settings.scratch_root = old
    check(len(points) == 1 + TOOLING_TRIALS, "tooling: {} telemetry points "
          "for the bench, wanted {}".format(len(points), 1 + TOOLING_TRIALS))
    series = timeseries.series(points, fingerprint=points[-1]["fingerprint"])
    return 2 if sentry.detect(series) else 0


def top_of_a_live_run(Dampr, DocFreq, settings, corpus, chunk, workdir):
    """``cli top --once --json`` (in this process) against the metrics
    endpoint of a TF-IDF run in flight on the card: the run's rank row,
    alive, naming the run."""
    import contextlib
    import io
    import socket
    import threading

    from dampr_tpu_torch import cli
    from dampr_tpu_torch.obs import top

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    old = settings.metrics_port
    settings.metrics_port = port
    errors = []

    def run():
        try:
            tfidf_pipeline(Dampr, DocFreq, corpus, chunk, os.path.join(
                workdir, "idf-top")).run(name="chip-top")
        except Exception as e:  # reported after the join
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        # until the endpoint answers with a sampled stage gauge
        live = False
        deadline = time.time() + 120
        while t.is_alive() and time.time() < deadline and not live:
            snap = top.scrape(port, timeout=0.5)
            live = "dampr_tpu_run_stage" in snap["metrics"]
            if not live:
                time.sleep(0.02)
        check(live, "tooling: the TF-IDF run never served its gauges")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["top", "--ports", str(port), "--once", "--json"])
    finally:
        t.join(600)
        settings.metrics_port = old
    check(not t.is_alive() and not errors,
          "tooling: the top run failed: {!r}".format(errors))
    doc = json.loads(buf.getvalue())
    row = doc["ranks"][0]
    check(rc == 0 and row["alive"] and row["run"] == "chip-top"
          and row.get("stage") is not None,
          "tooling: top --once --json read no live rank: {}".format(doc))
    return row


def phase_tooling(Dampr, DocFreq, settings, workdir, corpus, mb, chunk):
    """The port's tools on the card (:mod:`dampr_tpu_torch.cli`):

    (a) ``python -m dampr_tpu_torch.cli bench`` in its own process on the
        card, traced, with autotune on and :data:`TOOLING_TRIALS` trials,
        over this script's corpus (made by the bench's generator and
        seed, linked where the bench looks for it): its own exact check
        against the single-core baseline passes, the line has a lowered
        stage and a handoff edge, every trial is byte-identical,
        ``tools/check_bench.py`` accepts the line, and the winning run's
        ``stats.json`` shows K1, K2 and B4 launched;
    (b) over those runs: ``stats --series --prom --log``, ``doctor --json``
        (valid against ``docs/doctor_schema.json``) and ``history``, each
        exit 0 with output, and ``sentry --strict``, whose exit must be
        its verdict: 2 exactly when ``sentry.detect`` finds a regression
        in the bench's four points (a three-point baseline can have a
        MAD near 0, so a trial's noise can be a finding), else 0;
    (c) ``top --once --json`` against the metrics endpoint of a TF-IDF run
        in flight on the card.

    Prints one ``tooling`` JSON line and returns the winning run's
    launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench_dir = os.path.join(workdir, "bench")
    os.makedirs(bench_dir)
    os.link(corpus, os.path.join(bench_dir, "corpus_{}mb.txt".format(mb)))
    scratch = os.path.join(workdir, "tool-scratch")
    env = tool_env(settings, scratch, DAMPR_BENCH_DIR=bench_dir,
                   DAMPR_BENCH_MB=str(mb), DAMPR_TPU_TORCH_TRACE="1",
                   DAMPR_TPU_TORCH_AUTOTUNE="on",
                   DAMPR_TPU_TORCH_AUTOTUNE_TRIALS=str(TOOLING_TRIALS))
    rc, out, err, bench_s = run_tools(env, {"bench": ["bench"]},
                                      900)["bench"]
    check(rc == 0, "tooling: the bench exited {}: {}".format(rc, err[-3000:]))
    check("match baseline exactly" in err,
          "tooling: the bench's exact check did not run")
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["device_stages"] >= 1 and rec["handoff_edges"] >= 1,
          "tooling: the bench ran no lowered stage or no handoff edge: "
          "{}".format(rec))
    tune = rec["autotune"]
    check(tune["byte_identical"] and len(tune["trials"]) == TOOLING_TRIALS,
          "tooling: autotune trials not all byte-identical: {}".format(tune))
    line_path = os.path.join(workdir, "bench-line.json")
    with open(line_path, "w") as f:
        json.dump(rec, f)
    cb = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                      "check_bench.py"),
                         line_path, "--strict"], capture_output=True,
                        text=True, timeout=120)
    check(cb.returncode == 0, "tooling: check_bench refused the line: "
          "{}".format(cb.stdout + cb.stderr))
    with open(rec["stats_file"]) as f:
        winner = json.load(f)
    launches = dict(winner["device"]["kernels"])
    for name in ("fnv", "segfold", "handoff", "rows"):
        check(launches.get(name, 0) > 0, "tooling: kernel {} not launched "
              "in the winning run".format(name))

    stats_file = rec["stats_file"]
    calls = {"stats": ["stats", stats_file, "--series", "--prom", "--log"],
             "doctor": ["doctor", stats_file, "--json"],
             "history": ["history"],
             "history-run": ["history", "bench-tfidf"],
             "sentry": ["sentry", "bench-tfidf", "--strict"]}
    tools = {}
    for what, (rc, out, err, secs) in run_tools(env, calls, 300).items():
        argv = calls[what]
        # the sentry's strict exit is its verdict on the bench's points:
        # 2 exactly when this process's detect() finds a regression there
        want = sentry_verdict(settings, scratch) if what == "sentry" else 0
        check(rc == want and out.strip(), "tooling: {} exited {} (wanted "
              "{}; {} bytes out): {}".format(" ".join(argv), rc, want,
                                             len(out), err[-2000:]))
        tools[what] = {"seconds": secs, "stdout_bytes": len(out),
                       "exit": rc}
        if what == "doctor":
            report = json.loads(out)
            report_path = os.path.join(workdir, "doctor.json")
            with open(report_path, "w") as f:
                f.write(out)
            vd = subprocess.run(
                [sys.executable, os.path.join(root, "tools",
                                              "validate_doctor.py"),
                 report_path, "--no-settings"], capture_output=True,
                text=True, timeout=120)
            check(vd.returncode == 0, "tooling: the doctor's report is "
                  "not valid: {}".format(vd.stdout + vd.stderr))
            top_finding = (report["findings"] or [{}])[0]
        if what == "stats":
            check("# TYPE dampr_tpu_" in out and "series" in out,
                  "tooling: stats printed no exposition or series")
        if what == "sentry":
            sentry_out = out.strip().splitlines()
    row = top_of_a_live_run(Dampr, DocFreq, settings, corpus, chunk,
                            workdir)
    log("tooling " + json.dumps({
        "bench_seconds": bench_s, "value_mb_per_s": rec["value"],
        "vs_baseline": rec["vs_baseline"],
        "device_fraction": rec["device_fraction"],
        "handoff_edges": rec["handoff_edges"],
        "n_partitions": rec["n_partitions"],
        "autotune": {"winner": tune["winner"],
                     "improvement": tune["improvement"],
                     "trials": [{k: t.get(k) for k in (
                         "trial", "knobs", "wall_seconds", "mbps",
                         "byte_identical")} for t in tune["trials"]]},
        "winner_launches": launches,
        "doctor": {"bottleneck": report["bottleneck"],
                   "top_finding": {k: top_finding.get(k) for k in (
                       "stage", "bottleneck", "severity",
                       "impact_seconds", "evidence")}},
        "sentry": sentry_out, "tools": tools,
        "top": {k: row.get(k) for k in ("run", "alive", "stage",
                                        "jobs_done", "store_bytes")}}))
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=128,
                    help="corpus size for the end-to-end phase")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ws-mb", type=int, default=32,
                    help="corpus size for the word_stats phase")
    # 128 (cut from 256 when the tooling phase came: the script's time)
    ap.add_argument("--ooc-mb", type=int, default=128,
                    help="record file size (MiB) of the ooc phase's external "
                         "sort; its budgets, chunks and the fold and join "
                         "inputs scale with it")
    # a rank process of the fleet phase (started by the phase itself)
    ap.add_argument("--fleet-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fleet-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--fleet-dir", help=argparse.SUPPRESS)
    ap.add_argument("--fleet-parts", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.fleet_rank is not None:
        return fleet_rank_main(args.fleet_rank, args.fleet_port,
                               args.fleet_dir, args.fleet_parts)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from dampr_tpu_torch import (Dampr, Map, faults, runner, settings,
                                     storage)
        from dampr_tpu_torch.csrc import build
        from dampr_tpu_torch.ops import (fnv, handoff, hashing, lower,
                                         segfold)
        from dampr_tpu_torch.ops.text import (DocFreq, ParseNumbers,
                                              TokenCounts)
        from dampr_tpu_torch.runner import KERNELS
    except ImportError as e:
        print("chip_smoke: dampr_tpu_torch is not importable ({}); run "
              "from the repository root".format(e), file=sys.stderr)
        return 2
    import numpy as np

    settings.device = "cuda"
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: " + card)
    log("torch {} cuda {}; tolerance: exact (bit for bit) everywhere"
        .format(torch.__version__, torch.version.cuda))

    workdir = tempfile.mkdtemp(prefix="dampr-chip-smoke-")
    # every run's spills and run history under this script's own root: no
    # corpus of an earlier process sizes or prices a run here
    settings.scratch_root = os.path.join(workdir, "scratch")
    try:
        corpus = os.path.join(workdir, "corpus.txt")
        t0 = time.perf_counter()
        nbytes = make_corpus(corpus, args.mb, args.seed)
        log("phase corpus: {} bytes in {:.3f} s".format(
            nbytes, time.perf_counter() - t0))

        t0 = time.perf_counter()
        ablate = ablate_kernel(build)
        build.build_all(list(KERNELS.values()) + [ablate])
        log("phase build: {} kernels and the first table program in {:.3f} "
            "s".format(len(KERNELS), time.perf_counter() - t0))

        rng = np.random.RandomState(args.seed)
        t0 = time.perf_counter()
        err = {"fnv": check_fnv(torch, fnv, dev, rng),
               "segfold": check_segfold(torch, lower, fnv, segfold, dev,
                                        rng)}
        log("phase kernels: fnv and segfold equal their plain versions "
            "in {:.3f} s".format(time.perf_counter() - t0))

        t0 = time.perf_counter()
        batches = {d: corpus_batch(torch, corpus, dev, d)
                   for d in (True, False)}
        check_token_fold(torch, lower, fnv, segfold, batches)
        log("phase token_fold: six outputs equal, dedup and not, in {:.3f} "
            "s".format(time.perf_counter() - t0))

        t0 = time.perf_counter()
        uploads = check_rows(torch, fnv, dev, rng)
        times = {"rows": {}}
        for L, ((span, offs, lens, lines), moved) in uploads.items():

            def run(fn=fnv.build_rows, L=L, a=(span, offs, lens, lines)):
                return fn(*a, LOWER_BATCH, L)

            def plain(run=run):
                return run(fnv.build_rows_reference)

            t = timing(torch, run, args.reps, ROWS_NAMES)
            # about 6 launches a column: past the launch queue at the
            # widest, where only the events around one call time it
            t["plain"] = (timing(torch, plain, args.reps, launches=6 * L)
                          if 6 * L < 500 else
                          {"ms": time_ms(torch, plain, args.reps),
                           "device_ms": None, "host_ms": None})
            t["shape"] = [LOWER_BATCH, L]
            t["bound"] = bound_ms(moved, 0)
            times["rows"][L] = t
            log("rows at {}: {}".format(t["shape"], json.dumps(t)))
        log("phase rows: the row builder equals its plain version at "
            "widths {} and timed, in {:.3f} s".format(
                list(ROWS_WIDTHS), time.perf_counter() - t0))

        # -- timings at the main path's batch and at 2^22 ------------------
        mat, lens, lines, ntok = batches[True]
        N, L = mat.shape
        sizes = {"main": (mat, lens, lines),
                 "2^22": random_batch(torch, dev, rng, 1 << 22, L)}
        t0 = time.perf_counter()
        times.update({"fnv": {}, "segfold": {}})
        for label, (m, ln, li) in sizes.items():
            n = m.shape[0]
            live_bytes = int(ln.clamp(0, L).sum())
            low, high = fnv.fnv_sort_keys(m, ln, li)
            perm, shigh = lower.sort_segments(low, high)
            fold_args = (perm, shigh, low, m, ln, True)
            k1 = timing(torch, lambda: fnv.fnv_sort_keys(m, ln, li),
                        args.reps, K1_NAMES)
            p1 = timing(torch, lambda: fnv.fnv_sort_keys_reference(m, ln, li),
                        args.reps, launches=20 * L)
            k2 = timing(torch, lambda: segfold.segfold_gather(*fold_args),
                        args.reps, K2_NAMES, launches=2)
            p2 = timing(torch, lambda: segfold.segfold_gather_reference(
                *fold_args), args.reps, launches=60)
            times["fnv"][label] = dict(
                k1, plain=p1, shape=[n, L],
                bound=bound_ms(n * L + 4 * n + 4 * n + 16 * n,
                               4 * live_bytes))
            times["segfold"][label] = dict(
                k2, plain=p2, shape=[n],
                bound=bound_ms(28 * n + n * L + 17 * n, 4 * n))
            for name in ("fnv", "segfold"):
                t = times[name][label]
                log("{} at {}: {}".format(name, t["shape"], json.dumps(t)))
        for shape_L in (16, 32):
            m2 = torch.from_numpy(rng.randint(0, 256, size=(N, shape_L))
                                  .astype(np.uint8)).to(dev)
            l2 = torch.from_numpy(rng.randint(1, shape_L + 1, size=N)
                                  .astype(np.int32)).to(dev)
            b_ms, _ = bound_ms(N * shape_L + 8 * N + 16 * N,
                               4 * int(l2.sum()))
            t = timing(torch, lambda: fnv.fnv_sort_keys(m2, l2, lines),
                       args.reps, K1_NAMES)
            log("fnv at [{}, {}]: {} (bound {:.6f} ms)".format(
                N, shape_L, json.dumps(t), b_ms))
        prog = timing(torch, lambda: lower.token_fold(mat, lens, lines, True),
                      args.reps, launches=30)
        prog_plain = timing(torch, lambda: lower.token_fold(
            mat, lens, lines, True, hash_fn=fnv.fnv_sort_keys_reference,
            fold_fn=segfold.segfold_gather_reference), args.reps,
            launches=30 + 20 * L + 60)
        sort_key = fnv.fnv_sort_keys(mat, lens, lines)[1]
        sort_ms = time_ms(torch, lambda: torch.sort(sort_key, stable=True),
                          args.reps)
        live_bytes = int(lens.clamp(0, L).sum())
        pbound = bound_ms(N * L + 8 * N + 17 * N + 8, 4 * live_bytes)
        # K1's lanes entry at the wc batch (the map-side combine's hash)
        wm, wl = wc_batch(torch, hashing, corpus, dev)
        for g, w in zip(fnv.fnv(wm, wl), fnv.fnv_reference(wm, wl)):
            ok, e = exact(torch, g, w)
            err["fnv"] = max(err["fnv"], e)
            check(ok, "fnv lanes disagree with the plain version at the wc "
                      "batch")
        wn, wL = wm.shape
        lanes = timing(torch, lambda: fnv.fnv(wm, wl), args.reps, K1_NAMES)
        lanes_plain = timing(torch, lambda: fnv.fnv_reference(wm, wl),
                             args.reps, launches=20 * wL)
        times["fnv"]["wc"] = dict(
            lanes, plain=lanes_plain, shape=[wn, wL],
            bound=bound_ms(wn * wL + 4 * wn + 8 * wn,
                           4 * int(wl.clamp(0, wL).sum())))
        log("fnv lanes at the wc batch {}: {}".format(
            [wn, wL], json.dumps(times["fnv"]["wc"])))
        log(json.dumps({"programs": [{
            "name": "token_fold", "shape": [N, L], "tokens": ntok,
            "ms": prog["ms"], "device_ms": prog["device_ms"],
            "host_ms": prog["host_ms"], "plain_ms": prog_plain["ms"],
            "plain_device_ms": prog_plain["device_ms"],
            "plain_host_ms": prog_plain["host_ms"], "bound_ms": pbound[0],
            "bound_by": pbound[1], "library_ms": sort_ms,
            "library_call": "torch.sort(int64 [N], stable=True)"}]}))
        log("phase timings: {:.3f} s".format(time.perf_counter() - t0))

        # -- the main path end to end -------------------------------------
        t0 = time.perf_counter()
        tc, df, n_lines, wc = oracle(corpus)
        log("phase oracle: {} distinct tokens in {:.3f} s".format(
            len(tc), time.perf_counter() - t0))

        # -- the handoff's table program (B4) -------------------------------
        t0 = time.perf_counter()
        vocabs = {"sorted": corpus_vocab(np, df),
                  "first-seen": first_seen_vocab(np, corpus, df)}
        err["handoff"], n_cases = check_handoff(
            torch, np, handoff, hashing, dev, rng, batches[True][:3], vocabs)
        log("phase handoff kernel: the table program equals its plain "
            "version, {} cases x 3 variants x {} runs, in {:.3f} s".format(
                n_cases, HANDOFF_REPEATS, time.perf_counter() - t0))
        t0 = time.perf_counter()
        times["handoff"] = {"main": time_handoff(
            torch, np, ablate, handoff, hashing, dev, batches[True][:3],
            vocabs, args.reps)}
        ht = times["handoff"]["main"]
        ablations = ht.pop("ablations")
        log("handoff-ablations " + json.dumps(ablations))
        # the first design, timed in this run beside the redesign
        ht["previous_device_ms"] = ablations["sorted"]["WINDOW"]["as is"]
        log("handoff at {}: {}".format(ht["shape"], json.dumps(ht)))
        log("phase handoff timings: {:.3f} s".format(
            time.perf_counter() - t0))
        chunk = os.path.getsize(corpus) // 8 + 1
        for k in KERNELS.values():
            k.launches = 0
        runs = []
        for scanner, want in (
                (DocFreq(mode="word", lower=True, pair_values=False), df),
                (TokenCounts(mode="word", lower=True, pair_values=False),
                 tc)):
            t0 = time.perf_counter()
            em = run_pipeline(Dampr, scanner, corpus, chunk)
            got = em.read()
            secs = time.perf_counter() - t0
            stats = em.stats()
            em.delete()
            name = type(scanner).__name__
            check(got == sorted(want.items()),
                  "{} results differ from the Counter oracle".format(name))
            dstat = stats["device"]
            check(dstat["device_stages"] >= 1,
                  "{}: no stage lowered to the device".format(name))
            runs.append({"scanner": name, "seconds": secs,
                         "mb_per_s": nbytes / 1e6 / secs,
                         "device_fraction": dstat["device_fraction"],
                         "host_phase_seconds": dstat["host_phase_seconds"],
                         "combine_seconds": stats["combine_seconds"],
                         "stage_seconds": stage_seconds(stats),
                         "batches": dstat["batches"],
                         "fallbacks": dstat["fallbacks"],
                         "h2d_bytes": dstat["h2d_bytes"],
                         "d2h_bytes": dstat["d2h_bytes"],
                         "kernels": dstat["kernels"]})
            log("e2e " + json.dumps(runs[-1]))
        launches = {k: kern.launches for k, kern in KERNELS.items()}
        for name, count in launches.items():
            check(count > 0, "kernel {} never launched on the main path"
                  .format(name))

        # The same DocFreq run with one job thread: its per-phase host
        # seconds show what the phases cost without other jobs' threads
        # contending for the interpreter.
        t0 = time.perf_counter()
        em = (Dampr.text(corpus, chunk)
              .custom_mapper(DocFreq(mode="word", lower=True,
                                     pair_values=False))
              .fold_values(operator.add).run(name="chip-one-job", n_maps=1))
        check(em.read() == sorted(df.items()),
              "one-job DocFreq differs from the Counter oracle")
        secs = time.perf_counter() - t0
        dstat = em.stats()["device"]
        log("e2e-one-job " + json.dumps({
            "scanner": "DocFreq", "jobs": 1, "seconds": secs,
            "mb_per_s": nbytes / 1e6 / secs,
            "host_phase_seconds": dstat["host_phase_seconds"],
            "combine_seconds": em.stats()["combine_seconds"],
            "batches": dstat["batches"]}))
        em.delete()

        sink_dir = os.path.join(workdir, "tsv")
        (Dampr.text(corpus, chunk)
         .custom_mapper(DocFreq(mode="word", lower=True, pair_values=False))
         .fold_values(operator.add).sink_tsv(sink_dir).run(name="chip-sink"))
        check(part_lines(sink_dir) == sorted(
            "{}\t{}".format(k, c) for k, c in df.items()),
            "sink_tsv lines differ from the oracle")
        log("phase e2e: DocFreq and TokenCounts exact; sink_tsv exact")

        # -- the TF-IDF benchmark's pipeline --------------------------------
        t0 = time.perf_counter()
        tfidf_launches = phase_tfidf(Dampr, DocFreq, KERNELS, corpus, chunk,
                                     nbytes, df, n_lines,
                                     os.path.join(workdir, "idf"))
        log("phase tfidf: {} sink lines exact, DocFreq lowered, every "
            "kernel launched, one shared window pass, in {:.3f} s".format(
                len(df), time.perf_counter() - t0))

        # -- the handoff: off and auto, a degrade, a kill -------------------
        t0 = time.perf_counter()
        handoff_launches = phase_handoff(
            Dampr, DocFreq, settings, KERNELS, corpus, chunk, nbytes, df,
            n_lines, workdir, part_lines(os.path.join(workdir, "idf")))
        head = os.path.join(workdir, "corpus_16mb.txt")
        head_lines(corpus, head, 16 * 1024 ** 2)
        head_oracle = oracle(head)
        head_df = head_oracle[1]
        phase_handoff_degrade(Dampr, DocFreq, settings, KERNELS, head,
                              head_df)
        phase_handoff_kill(torch, Dampr, DocFreq, storage, handoff, head)
        check_ref_offload(torch, np, storage, handoff, hashing)
        log("phase handoff: TF-IDF off and auto equal and exact, the auto "
            "run's counts on the card from map to fold; degrade exact; kill "
            "left no device bytes; an offloaded ref freed its lanes; in "
            "{:.3f} s".format(
                time.perf_counter() - t0))

        # -- observability: traced runs and the card's timeline -------------
        t0 = time.perf_counter()
        obs_launches = phase_obs(
            torch, Dampr, DocFreq, settings, storage, handoff, KERNELS,
            corpus, chunk, nbytes, df, n_lines, workdir,
            part_lines(os.path.join(workdir, "idf")), head)
        log("phase obs: traced and untraced TF-IDF equal in lines, copies "
            "and launches; the trace and the crashdump validate; the "
            "profiler accounts for the counters; in {:.3f} s".format(
                time.perf_counter() - t0))

        # -- keyed joins ------------------------------------------------------
        t0 = time.perf_counter()
        phase_joins(Dampr, Map, DocFreq, TokenCounts, corpus, chunk, tc, df,
                    args.seed)
        log("phase joins: words and integer keys exact, in {:.3f} s".format(
            time.perf_counter() - t0))

        # -- examples/wc.py and examples/word_stats.py ----------------------
        t0 = time.perf_counter()
        wc_launches = phase_wc(Dampr, KERNELS, corpus, chunk, nbytes, wc)
        log("wc-breakdown " + json.dumps(wc_breakdown(corpus, chunk)))
        log("phase wc: {} words exact, one fused map stage, fnv launched "
            "{} times, in {:.3f} s".format(len(wc), wc_launches["fnv"],
                                          time.perf_counter() - t0))
        t0 = time.perf_counter()
        if args.ws_mb == args.mb:
            ws_corpus, ws_bytes, ws_wc = corpus, nbytes, wc
        else:
            ws_corpus = os.path.join(workdir, "corpus_ws.txt")
            ws_bytes = make_corpus(ws_corpus, args.ws_mb, args.seed)
            ws_wc = oracle(ws_corpus)[3]
        phase_word_stats(Dampr, runner, KERNELS, ws_corpus,
                         os.path.getsize(ws_corpus) // 8 + 1, ws_bytes, ws_wc)
        log("phase word_stats: four outputs exact on {} bytes, in {:.3f} s"
            .format(ws_bytes, time.perf_counter() - t0))

        # -- the out-of-core tier -------------------------------------------
        t0 = time.perf_counter()
        ooc_launches = phase_ooc(
            Dampr, ParseNumbers, DocFreq, settings, KERNELS, workdir,
            args.ooc_mb, corpus, chunk, nbytes, df, n_lines,
            part_lines(os.path.join(workdir, "idf")))
        log("phase ooc: sort, fold, join and tfidf out of core exact, in "
            "{:.3f} s".format(time.perf_counter() - t0))

        # -- compressed taps ------------------------------------------------
        t0 = time.perf_counter()
        ingest_launches = phase_ingest(
            Dampr, DocFreq, settings, KERNELS, workdir, corpus, nbytes, df,
            n_lines, part_lines(os.path.join(workdir, "idf")))
        log("phase ingest: BGZF TF-IDF equal to the plain run and the "
            "oracle in one shared read, plain gzip DocFreq exact, in {:.3f} "
            "s".format(time.perf_counter() - t0))

        # -- the static analyzer and the certified lane chain (B11) ---------
        t0 = time.perf_counter()
        phase_analyze(torch, np, Dampr, settings, KERNELS, workdir, corpus,
                      chunk, args.seed, args.reps)
        log("phase analyze: the integer and float chains exact on and off, "
            "every batch dispatched and verified; lint clean; in {:.3f} s"
            .format(time.perf_counter() - t0))

        # -- the run-history corpus and the adaptive plan -------------------
        t0 = time.perf_counter()
        adapt_launches = phase_adapt(
            Dampr, DocFreq, settings, KERNELS, workdir, corpus, chunk,
            nbytes, df, n_lines, part_lines(os.path.join(workdir, "idf")),
            head, head_df)
        log("phase adapt: three named TF-IDF runs exact, the third priced "
            "from the corpus; a sized run adapted; early-fold and chain "
            "edges streamed, equal to staged; explain() ran nothing; in "
            "{:.3f} s".format(time.perf_counter() - t0))

        # -- faults, retries and resume -----------------------------------
        t0 = time.perf_counter()
        faults_launches = phase_faults(
            torch, Dampr, DocFreq, settings, faults, runner, handoff,
            KERNELS, workdir, corpus, chunk, nbytes, df, n_lines,
            part_lines(os.path.join(workdir, "idf")), head, head_df)
        log("phase faults: a retried table-mode job, absorbed spill I/O "
            "faults, a failed run resumed from DocFreq's checkpoint and "
            "an auto-resumed run, all exact, memory back each time; in "
            "{:.3f} s".format(time.perf_counter() - t0))

        # -- the mesh in one process: B7-B10 over 4 shards of the card ------
        t0 = time.perf_counter()
        phase_mesh(torch, np, Dampr, DocFreq, settings, KERNELS, workdir,
                   corpus, chunk, nbytes, df, n_lines,
                   part_lines(os.path.join(workdir, "idf")), head, head_df,
                   args.reps)
        log("phase mesh: TF-IDF over {} shards equal to D = 1 and the "
            "oracle, the fold's retry exact, group_by, joins and sort_by "
            "through the exchange, rings and SGD exact; in {:.3f} s".format(
                MESH_SHARDS, time.perf_counter() - t0))

        # -- the mesh across processes: two ranks on the card, gloo ---------
        t0 = time.perf_counter()
        fleet_launches = phase_fleet(Dampr, DocFreq, settings, workdir,
                                     head, head_df, head_oracle[2])
        log("phase fleet: two ranks over {} shards: TF-IDF, group_by, joins "
            "and sort_by equal one process; a killed rank aborted its peer "
            "in bound and the rerun resumed exactly; the mitigation engaged "
            "and disengaged exactly; the merge named the straggler; in "
            "{:.3f} s".format(FLEET_RANKS * FLEET_LOCAL,
                              time.perf_counter() - t0))

        # -- the serve daemon and the cross-run cache -----------------------
        t0 = time.perf_counter()
        serve_launches = phase_serve(
            Dampr, DocFreq, TokenCounts, settings, workdir, corpus, chunk,
            nbytes, df, tc, n_lines,
            part_lines(os.path.join(workdir, "idf")), args.seed)
        log("phase serve: a served TF-IDF run on the card, then mounted by "
            "a second tenant with no launch; coalesced, concurrent and "
            "incremental runs exact; a cancelled worker's context gone; "
            "the daemon never on the card; in {:.3f} s".format(
                time.perf_counter() - t0))

        # -- the tools: bench, stats, doctor, history, sentry, top --------
        t0 = time.perf_counter()
        tooling_launches = phase_tooling(Dampr, DocFreq, settings, workdir,
                                         corpus, args.mb, chunk)
        log("phase tooling: the bench exact on the card with autotune, "
            "its runs read by stats, doctor, history and sentry; top read "
            "a live run; in {:.3f} s".format(time.perf_counter() - t0))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    sources = {"fnv": ("dampr_tpu_torch/csrc/fnv.cu",
                       "dampr_tpu/ops/pallas_fnv.py:94",
                       "fnv_sort_keys(mat, lens, lines)"),
               "segfold": ("dampr_tpu_torch/csrc/segfold.cu",
                           "dampr_tpu/ops/pallas_segfold.py:262",
                           "segfold_gather(perm, shigh, low, mat, lens, "
                           "dedup=True)")}
    kernels = []
    for name in ("fnv", "segfold"):
        main_t, big_t = times[name]["main"], times[name]["2^22"]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "entry": sources[name][2],
            "shape": main_t["shape"], "launches": launches[name],
            "launches_tfidf": tfidf_launches[name],
            "launches_wc": wc_launches[name],
            "launches_ooc": ooc_launches[name],
            "launches_ingest": ingest_launches[name],
            "launches_obs": obs_launches[name],
            "launches_adapt": adapt_launches[name],
            "launches_faults": faults_launches[name],
            "launches_serve": serve_launches.get(name, 0),
            "launches_tooling": tooling_launches[name],
            "launches_fleet": fleet_launches[name],
            "max_abs_err": err[name], "ms": main_t["ms"],
            "device_ms": main_t["device_ms"], "host_ms": main_t["host_ms"],
            "profiler_ms": main_t["profiler_ms"],
            "plain_ms": main_t["plain"]["ms"],
            "plain_device_ms": main_t["plain"]["device_ms"],
            "plain_host_ms": main_t["plain"]["host_ms"],
            "bound_ms": main_t["bound"][0], "bound_by": main_t["bound"][1],
            "library_ms": None,
            "at_2_22": {"shape": big_t["shape"], "ms": big_t["ms"],
                        "device_ms": big_t["device_ms"],
                        "host_ms": big_t["host_ms"],
                        "profiler_ms": big_t["profiler_ms"],
                        "plain_device_ms": big_t["plain"]["device_ms"],
                        "bound_ms": big_t["bound"][0],
                        "bound_by": big_t["bound"][1]}})
    ht = times["handoff"]["main"]
    kernels.append({
        "name": "handoff", "route": "cuda",
        "source": "dampr_tpu_torch/csrc/handoff.cu",
        "replaces": "dampr_tpu/ops/handoff.py:119",
        "entry": "table_probe(mat, lens, lines, tab_h1, tab_slot, tab_mat, "
                 "tab_lens, acc, dedup=True, dedup_k=16)",
        "shape": ht["shape"], "table": ht["table"],
        "launches": launches["handoff"],
        "launches_tfidf": tfidf_launches["handoff"],
        "launches_wc": wc_launches["handoff"],
        "launches_ooc": ooc_launches["handoff"],
        "launches_ingest": ingest_launches["handoff"],
        "launches_handoff": handoff_launches["handoff"],
        "launches_obs": obs_launches["handoff"],
        "launches_adapt": adapt_launches["handoff"],
        "launches_faults": faults_launches["handoff"],
        "launches_serve": serve_launches.get("handoff", 0),
        "launches_tooling": tooling_launches["handoff"],
        "launches_fleet": fleet_launches["handoff"],
        "max_abs_err": err["handoff"], "ms": ht["ms"],
        "device_ms": ht["device_ms"], "host_ms": ht["host_ms"],
        "profiler_ms": ht["profiler_ms"], "plain_ms": ht["plain"]["ms"],
        "plain_device_ms": ht["plain"]["device_ms"],
        "plain_host_ms": ht["plain"]["host_ms"],
        "bound_ms": ht["bound"][0], "bound_by": ht["bound"][1],
        "library_ms": None, "variants": ht["variants"],
        "previous_device_ms": ht["previous_device_ms"],
        "previous_source": "tools/handoff_ablate.cu"})
    rows_t = times["rows"][ROWS_WIDTHS[0]]
    wide_t = times["rows"][ROWS_WIDTHS[-1]]
    kernels.append({
        "name": "rows", "route": "cuda",
        "source": "dampr_tpu_torch/csrc/fnv.cu",
        "replaces": None,
        "replaces_host": "dampr_tpu/ops/lower.py DeviceTokenFoldSink"
                         "._pad_batch (host padding; no TPU kernel)",
        "entry": "build_rows(span, offs, lens, lines, npad, L)",
        "shape": rows_t["shape"],
        "launches": launches["rows"],
        "launches_tfidf": tfidf_launches["rows"],
        "launches_wc": wc_launches["rows"],
        "launches_ooc": ooc_launches["rows"],
        "launches_ingest": ingest_launches["rows"],
        "launches_obs": obs_launches["rows"],
        "launches_adapt": adapt_launches["rows"],
        "launches_faults": faults_launches["rows"],
        "launches_serve": serve_launches.get("rows", 0),
        "launches_tooling": tooling_launches["rows"],
        "launches_fleet": fleet_launches["rows"],
        "max_abs_err": 0, "ms": rows_t["ms"],
        "device_ms": rows_t["device_ms"], "host_ms": rows_t["host_ms"],
        "profiler_ms": rows_t["profiler_ms"],
        "plain_ms": rows_t["plain"]["ms"],
        "plain_device_ms": rows_t["plain"]["device_ms"],
        "plain_host_ms": rows_t["plain"]["host_ms"],
        "bound_ms": rows_t["bound"][0], "bound_by": rows_t["bound"][1],
        "library_ms": None,
        "at_widest": {"shape": wide_t["shape"], "ms": wide_t["ms"],
                      "device_ms": wide_t["device_ms"],
                      "host_ms": wide_t["host_ms"],
                      "profiler_ms": wide_t["profiler_ms"],
                      "plain_device_ms": wide_t["plain"]["device_ms"],
                      "bound_ms": wide_t["bound"][0],
                      "bound_by": wide_t["bound"][1]}})
    lanes = times["fnv"]["wc"]
    kernels[0]["at_wc_batch"] = {
        "entry": "fnv(mat, lens)", "shape": lanes["shape"],
        "launches": wc_launches["fnv"], "ms": lanes["ms"],
        "device_ms": lanes["device_ms"], "host_ms": lanes["host_ms"],
        "profiler_ms": lanes["profiler_ms"],
        "plain_ms": lanes["plain"]["ms"],
        "plain_device_ms": lanes["plain"]["device_ms"],
        "bound_ms": lanes["bound"][0], "bound_by": lanes["bound"][1],
        "library_ms": None}
    log("card: " + card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print("chip_smoke: FAILED: {}".format(e), file=sys.stderr)
        sys.exit(1)
