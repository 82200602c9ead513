#!/usr/bin/env python3
"""Smoke test of dampr_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--mb 128] [--seed 1234] [--reps 20]

Run from the repository root on a machine with an NVIDIA card (Hopper:
the kernels build for sm_90a).  Phases, each of which must pass:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main path from ``dampr_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and report the build time;
3. K1 (FNV) against its plain torch version, bit for bit, at the main
   path's shapes ([2^18, 16], [2^18, 32], the corpus batch) and on ragged
   lengths, high bytes, empty rows and unaligned bases;
4. K2 (segmented fold) against its plain torch version, bit for bit, at
   N = 2^18, a ragged N, one segment spanning many blocks, an all-invalid
   tail and single-element segments;
5. ``token_fold`` with the kernels against ``token_fold`` with the plain
   versions: all six outputs equal, with and without per-line dedup;
6. times (CUDA events, warm, median of ``--reps``) of each kernel, its
   plain version and the program, beside the least time the card could
   take (bytes over 3.35 TB/s, operations over the peak rate);
7. the main path end to end on a ``--mb`` corpus made from ``--seed``
   (the TF-IDF benchmark's generator): DocFreq and TokenCounts through
   ``Dampr.text(...).custom_mapper(...).fold_values(operator.add)``, held
   exactly against a pure-Python Counter oracle, plus a ``sink_tsv``
   readback; launch counters are zeroed just before and read just after,
   and every kernel must have launched.

Every tolerance is exact: all outputs are integers or bytes.  Prints a
``{"kernels": [...]}`` JSON line second to last and
``{"ok": true, "device": {...}}`` last; exits non-zero, printing no
result, if there is no card or any phase fails.
"""

import argparse
import collections
import json
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
    """Median CUDA-event time of ``fn()`` over ``reps`` warm runs."""
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
    """Pure-Python token counts and document frequencies (per line)."""
    rx = re.compile(r"[^\w]+")
    tc = collections.Counter()
    df = collections.Counter()
    with open(path) as f:
        for line in f:
            toks = [t for t in rx.split(line.rstrip("\n").lower()) if t]
            tc.update(toks)
            df.update(set(toks))
    return tc, df


def exact(torch, a, b):
    """(equal, max |a - b|) of two integer/bool tensors."""
    if a.shape != b.shape:
        return False, float("inf")
    if a.numel() == 0:
        return True, 0.0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
    return d == 0, float(d)


def check_fnv(torch, fnv, dev, rng):
    """K1 vs its plain version; returns the max abs error seen."""
    import numpy as np

    worst = 0.0
    cases = []
    for n, L in ((1 << 18, 16), (1 << 18, 32)):
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
    for name, mat, lens in cases:
        m = torch.from_numpy(mat.astype(np.uint8)).to(dev)
        ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
        got = fnv.fnv(m, ln)
        want = fnv.fnv_reference(m, ln)
        for g, w in zip(got, want):
            ok, err = exact(torch, g, w)
            worst = max(worst, err)
            check(ok, "fnv disagrees with fnv_reference: " + name)
    # an 8-byte-aligned (not 16) base: the kernel must take 8-byte loads
    n, L = 5000, 16
    flat = torch.from_numpy(rng.randint(0, 256, size=n * L + 8)
                            .astype(np.uint8)).to(dev)
    m = flat[8:].view(n, L)
    ln = torch.from_numpy(rng.randint(0, 17, size=n).astype(np.int32)).to(dev)
    check(fnv._vec_width(m) == 8, "unaligned base did not pick 8-byte loads")
    for g, w in zip(fnv.fnv(m, ln), fnv.fnv_reference(m, ln)):
        ok, err = exact(torch, g, w)
        worst = max(worst, err)
        check(ok, "fnv disagrees with fnv_reference: unaligned base")
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


def check_segfold(torch, segfold, dev, rng):
    worst = 0.0
    n = 1 << 18
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    distinct = torch.arange(n, dtype=torch.int32, device=dev)
    cases = [
        ("random N=2^18", sorted_case(torch, dev, rng, n, 20000, 1000)),
        ("ragged N", sorted_case(torch, dev, rng, 100003, 50000, 7)),
        ("one segment over many blocks", [zeros, zeros, ones, zeros]),
        ("all-invalid tail",
         sorted_case(torch, dev, rng, n, 3000, n // 2)),
        ("all invalid", [zeros, zeros, ones, ones]),
        ("single-element segments", [distinct, distinct,
                                     torch.full_like(ones, 3), zeros]),
        ("one record", sorted_case(torch, dev, rng, 1, 1, 0)),
        ("tile edge", sorted_case(torch, dev, rng, 2049, 2049, 0)),
    ]
    for name, (h1, h2, v, inv) in cases:
        got = segfold.segfold(h1, h2, v, inv)
        want = segfold.segfold_reference_torch(h1, h2, v, inv)
        for g, w in zip(got, want):
            ok, err = exact(torch, g, w)
            worst = max(worst, err)
            check(ok, "segfold disagrees with its plain version: " + name)
    tot, live = segfold.segfold(zeros, zeros, ones, zeros)
    check(int(live.sum()) == 1 and int(tot[-1]) == n,
          "one giant segment must total N at its single end")
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
                                hash_fn=fnv.fnv_reference,
                                fold_fn=segfold.segfold_reference_torch)
        names = ("sh1", "sh2", "tot", "live", "rep_orig", "collisions")
        for name, g, w in zip(names, got, want):
            ok, _ = exact(torch, g, w)
            check(ok, "token_fold output {} differs between the kernels "
                      "and the plain versions (dedup={})".format(name,
                                                                 dedup))
        check(int(got[5]) == 0, "unexpected collision in the corpus batch")
    torch.cuda.synchronize()


def run_pipeline(Dampr, scanner, path, chunk):
    em = (Dampr.text(path, chunk).custom_mapper(scanner)
          .fold_values(operator.add).run(name="chip-smoke"))
    return em


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=128,
                    help="corpus size for the end-to-end phase")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from dampr_tpu_torch import Dampr, settings
        from dampr_tpu_torch.csrc import build
        from dampr_tpu_torch.ops import fnv, lower, segfold
        from dampr_tpu_torch.ops.text import DocFreq, TokenCounts
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
        err = {"fnv": check_fnv(torch, fnv, dev, rng),
               "segfold": check_segfold(torch, segfold, dev, rng)}
        log("phase kernels: fnv and segfold equal their plain versions")

        batches = {d: corpus_batch(torch, corpus, dev, d)
                   for d in (True, False)}
        check_token_fold(torch, lower, fnv, segfold, batches)
        log("phase token_fold: six outputs equal, dedup and not")

        # -- timings at the main path's shapes ---------------------------
        mat, lens, lines, ntok = batches[True]
        N, L = mat.shape
        live_bytes = int(lens.clamp(0, L).sum())
        h1, h2 = fnv.fnv(mat, lens)
        # K2's main-path input, exactly as token_fold builds it
        _perm, sh1, sh2, sinv, v, _sp = lower.sort_segments(
            h1, h2, lens, lines, True)
        sort_key = ((lens <= 0).to(torch.int64) << 32) | (
            h1.to(torch.int64) & 0xFFFFFFFF)
        times = {}
        times["fnv"] = (time_ms(torch, lambda: fnv.fnv(mat, lens), args.reps),
                        time_ms(torch, lambda: fnv.fnv_reference(mat, lens),
                                args.reps))
        times["segfold"] = (
            time_ms(torch, lambda: segfold.segfold(sh1, sh2, v, sinv),
                    args.reps),
            time_ms(torch, lambda: segfold.segfold_reference_torch(
                sh1, sh2, v, sinv), args.reps))
        prog = (time_ms(torch, lambda: lower.token_fold(mat, lens, lines,
                                                        True), args.reps),
                time_ms(torch, lambda: lower.token_fold(
                    mat, lens, lines, True, hash_fn=fnv.fnv_reference,
                    fold_fn=segfold.segfold_reference_torch), args.reps))
        sort_ms = time_ms(torch, lambda: torch.sort(sort_key, stable=True),
                          args.reps)
        for shape_L in (16, 32):
            m2 = torch.from_numpy(rng.randint(0, 256, size=(N, shape_L))
                                  .astype(np.uint8)).to(dev)
            l2 = torch.from_numpy(rng.randint(1, shape_L + 1, size=N)
                                  .astype(np.int32)).to(dev)
            b_ms, _ = bound_ms(N * shape_L + 12 * N,
                               4 * int(l2.sum()))
            log("fnv at [{}, {}]: {:.6f} ms (bound {:.6f} ms)".format(
                N, shape_L, time_ms(torch, lambda: fnv.fnv(m2, l2),
                                    args.reps), b_ms))
        kbound = {
            "fnv": bound_ms(N * L + 4 * N + 8 * N, 4 * live_bytes),
            "segfold": bound_ms(16 * N + 5 * N, 4 * N),
        }
        pbound = bound_ms(N * L + 8 * N + 25 * N + 8, 4 * live_bytes)
        log(json.dumps({"programs": [{
            "name": "token_fold", "shape": [N, L], "tokens": ntok,
            "ms": prog[0], "plain_ms": prog[1], "bound_ms": pbound[0],
            "bound_by": pbound[1], "library_ms": sort_ms,
            "library_call": "torch.sort(int64 [N], stable=True)"}]}))

        # -- the main path end to end -------------------------------------
        t0 = time.perf_counter()
        tc, df = oracle(corpus)
        log("phase oracle: {} distinct tokens in {:.3f} s".format(
            len(tc), time.perf_counter() - t0))
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
                         "stage_seconds": [(s["kind"], s["seconds"])
                                           for s in stats["stages"]],
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
        lines_out = []
        for part in sorted(os.listdir(sink_dir)):
            with open(os.path.join(sink_dir, part)) as f:
                lines_out.extend(f.read().splitlines())
        check(sorted(lines_out) == sorted(
            "{}\t{}".format(k, c) for k, c in df.items()),
            "sink_tsv lines differ from the oracle")
        log("phase e2e: DocFreq and TokenCounts exact; sink_tsv exact")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    sources = {"fnv": ("dampr_tpu_torch/csrc/fnv.cu",
                       "dampr_tpu/ops/pallas_fnv.py:94"),
               "segfold": ("dampr_tpu_torch/csrc/segfold.cu",
                           "dampr_tpu/ops/pallas_segfold.py:262")}
    kernels = []
    for name in ("fnv", "segfold"):
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": kbound[name][0],
            "bound_by": kbound[name][1], "library_ms": None})
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
