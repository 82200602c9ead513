#!/usr/bin/env python3
"""Smoke test of dampr_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--mb 128] [--seed 1234] [--reps 20] [--ooc-mb 256]

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
   versions: all six outputs equal, with and without per-line dedup;
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
   profiler's K1/K2/B4 kernels equal to the launch counters; (c) a traced
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
    every sink line equal to the oracle.

K1's lanes entry is also checked and timed at the ``wc`` batch shape (the
corpus's first 65,536 words, padded as the combine pads them).  Every
tolerance is exact: all outputs are integers, bytes or one float
division of equal integers.  The handoff is at its default (``auto``:
on, on the card) in every phase but ``ooc-tfidf`` and the ``handoff``
phase's "off" run.  Prints a
``{"kernels": [...]}`` JSON line second to last (``launches_faults``: the
retried TF-IDF run's) and
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


def oracle(path):
    """Pure-Python token counts, document frequencies (per line), the line
    count, and the ``split()`` word counts ``examples/wc.py`` computes."""
    rx = re.compile(r"[^\w]+")
    tc = collections.Counter()
    df = collections.Counter()
    wc = collections.Counter()
    n_lines = 0
    with open(path) as f:
        for line in f:
            toks = [t for t in rx.split(line.rstrip("\n").lower()) if t]
            tc.update(toks)
            df.update(set(toks))
            wc.update(line.split())
            n_lines += 1
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
    device sink pads it (N = 2^18 rows)."""
    import numpy as np

    from dampr_tpu_torch.ops import lower as L
    from dampr_tpu_torch.ops.text import _LOWER, _token_bounds, line_ids

    with open(path, "rb") as f:
        data = f.read(8 * 1024 ** 2)
    data = data[:data.rfind(b"\n") + 1]
    buf = _LOWER[np.frombuffer(data, dtype=np.uint8)]
    starts, lens = _token_bounds(buf, "word")
    lines = line_ids(buf, starts)
    bounds = L._batch_bounds(lines, len(starts), LOWER_BATCH)
    a, b = bounds[0]
    sink = L.DeviceTokenFoldSink({"mode": "word", "lower": True,
                                  "dedup": dedup, "pair_values": False},
                                 device=dev)
    mat, ln, li = sink._pad_batch(buf, starts[a:b], lens[a:b],
                                  lines[a:b] if dedup else None)
    return mat.to(dev), ln.to(dev), li.to(dev), b - a


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
           "stream_fraction": dstat["stream_fraction"],
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
                  collide=False):
    """A vocabulary table as the handoff lays it out: ``(tab_h1 uint32,
    tab_slot, tab_mat, tab_lens)`` numpy lanes for token rows ``vrows``
    (uint8 [V, >= max(vlens)], zero past each length).  ``dup_h1`` puts
    every 97th slot under its neighbour's h1 (the leftmost must win, the
    other one's tokens miss); ``collide`` flips a byte of every 89th slot's
    row, so its tokens meet their h1 with other bytes and miss."""
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


def handoff_batch(np, rng, vrows, vlens, n, L, fresh=0.1, max_line=6):
    """A padded batch (``mat``, ``lens``, ``lines``) of ``n`` rows: 7/8 of
    them tokens, Zipf over the vocabulary rows (each at most L bytes) or,
    a ``fresh`` share, digit strings no vocabulary holds; lines of 1 to
    ``max_line`` tokens; the rest pad rows."""
    n_tok = n - n // 8
    V = len(vlens)
    mat = np.zeros((n, L), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    if V:
        probs = 1.0 / np.arange(1, V + 1) ** 1.1
        ids = rng.choice(V, size=n_tok, p=probs / probs.sum())
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
    """The corpus's own vocabulary as token rows (its words are ASCII)."""
    words = sorted(df)
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


def check_handoff(torch, np, handoff, hashing, dev, rng, corpus_inputs, df):
    """The table program against its plain version, bit for bit (``acc``,
    ``miss``, ``n_miss``), every case in all three variants, each
    HANDOFF_REPEATS times.  Returns the max abs error seen."""
    worst = 0.0
    n = 1 << 18
    cvrows, cvlens = corpus_vocab(np, df)
    ccap = max(4096, 1 << (len(cvlens) - 1).bit_length())
    cases = [("corpus batch, corpus vocabulary", corpus_inputs,
              handoff_table(np, hashing, cvrows, cvlens, ccap, 8), ccap)]
    for name, L, Lcap, V, opts in (
            ("random L=8", 8, 8, 20000, {}),
            ("random L=16", 16, 16, 20000, {}),
            ("random L=256", 256, 256, 4000, {}),
            ("duplicate h1 lanes", 8, 8, 20000, {"dup_h1": True}),
            ("h1 collisions, other bytes", 8, 8, 20000, {"collide": True}),
            ("Lcap > L", 8, 32, 20000, {}),
            ("Lcap < L", 16, 8, 20000, {}),
            ("empty table", 8, 8, 0, {}),
            ("all miss", 8, 8, 20000, {"fresh": 1.0})):
        vrows, vlens = random_vocab(np, rng, V, min(L, Lcap))
        cap = max(4096, 1 << max(0, (V - 1).bit_length()))
        fresh = opts.pop("fresh", 0.1)
        mat, lens, lines = handoff_batch(np, rng, vrows, vlens, n, L,
                                         fresh=fresh)
        inputs = [torch.from_numpy(x).to(dev) for x in (mat, lens, lines)]
        cases.append((name, inputs,
                      handoff_table(np, hashing, vrows, vlens, cap, Lcap,
                                    **opts), cap))
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
    return worst


def time_handoff(torch, np, handoff, hashing, dev, corpus_inputs, df, reps):
    """The table program at the main path's batch (the corpus's first,
    DocFreq's variant: the 16-token window) against the corpus's
    vocabulary, beside its plain version and its byte bound."""
    mat, lens, lines = corpus_inputs
    N, L = mat.shape
    cvrows, cvlens = corpus_vocab(np, df)
    cap = max(4096, 1 << (len(cvlens) - 1).bit_length())
    Lcap = 8
    tabs = table_args(torch, np, dev,
                      handoff_table(np, hashing, cvrows, cvlens, cap, Lcap),
                      cap)
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
    t["table"] = {"cap": cap, "Lcap": Lcap, "slots": len(cvlens)}
    return t


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
                  "handoff": HANDOFF_NAMES}


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
    gpu, launch_ts = [], {}
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
    check(gpu, "torch.profiler recorded no kernel or copy on the card")
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
    profiler's K1/K2/B4 kernels must equal the launch counters.  (c) A
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
    check(tl["kernel_counts"] == l2, "obs: the profiler's kernels {} differ "
          "from the launch counters {}".format(tl["kernel_counts"], l2))
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=128,
                    help="corpus size for the end-to-end phase")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ws-mb", type=int, default=32,
                    help="corpus size for the word_stats phase")
    ap.add_argument("--ooc-mb", type=int, default=256,
                    help="record file size (MiB) of the ooc phase's external "
                         "sort; its budgets, chunks and the fold and join "
                         "inputs scale with it")
    args = ap.parse_args(argv)

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
        build.build_all(list(KERNELS.values()))
        log("phase build: {} kernels in {:.3f} s".format(
            len(KERNELS), time.perf_counter() - t0))

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

        # -- timings at the main path's batch and at 2^22 ------------------
        mat, lens, lines, ntok = batches[True]
        N, L = mat.shape
        sizes = {"main": (mat, lens, lines),
                 "2^22": random_batch(torch, dev, rng, 1 << 22, L)}
        t0 = time.perf_counter()
        times = {"fnv": {}, "segfold": {}}
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
        err["handoff"] = check_handoff(torch, np, handoff, hashing, dev, rng,
                                       batches[True][:3], df)
        log("phase handoff kernel: the table program equals its plain "
            "version, {} cases x 3 variants x {} runs, in {:.3f} s".format(
                10, HANDOFF_REPEATS, time.perf_counter() - t0))
        t0 = time.perf_counter()
        times["handoff"] = {"main": time_handoff(
            torch, np, handoff, hashing, dev, batches[True][:3], df,
            args.reps)}
        log("handoff at {}: {}".format(times["handoff"]["main"]["shape"],
                                       json.dumps(times["handoff"]["main"])))
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
                         "stream_fraction": dstat["stream_fraction"],
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
            "stream_fraction": dstat["stream_fraction"],
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
        head_df = oracle(head)[1]
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
            "profiler's kernels equal the counters; in {:.3f} s".format(
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
        "max_abs_err": err["handoff"], "ms": ht["ms"],
        "device_ms": ht["device_ms"], "host_ms": ht["host_ms"],
        "profiler_ms": ht["profiler_ms"], "plain_ms": ht["plain"]["ms"],
        "plain_device_ms": ht["plain"]["device_ms"],
        "plain_host_ms": ht["plain"]["host_ms"],
        "bound_ms": ht["bound"][0], "bound_by": ht["bound"][1],
        "library_ms": None})
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
