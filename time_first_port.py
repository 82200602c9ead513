#!/usr/bin/env python3
"""Time the first port's kernels on one CUDA card, as chip_smoke.py times
this tree's.

    git archive af2fa24 | tar -x -C _archive/first_port
    python3 time_first_port.py _archive/first_port [--seed 1234] [--reps 20]

The first port (commit af2fa24) hashed with ``fnv(mat, lens)`` (int32
lanes), sorted with ``sort_segments(h1, h2, lens, lines, dedup)`` in torch
and folded with ``segfold(h1, h2, v, inv)`` in three launches; those are
the entries this script calls, so DIR must hold that commit.  The script
loads DIR's ``dampr_tpu_torch`` under another name, builds its kernels into
this tree's ``csrc/_build`` (libraries are named by a hash of their source,
so nothing collides, and nothing is written into DIR) and times, with
``chip_smoke.py``'s timers, its K1, its K2 and its ``token_fold`` (with
dedup) on the corpus's first batch (N = 2^18, L = 8) and on a random batch
of N = 2^22.  Each bound counts that tree's own function: each input read
and each output written once.  Run it in the same call as ``chip_smoke.py``
to compare the two trees on one card.  Prints the card, then one JSON
line; exits non-zero when there is no card.
"""

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

#: The first port's kernel names in the profiler's table.
K1_NAMES = r"fnv_kernel"
K2_NAMES = r"tile_aggregates|scan_aggregates|tile_totals"


def load_first_port(root, build_dir):
    """DIR's ``dampr_tpu_torch`` as the package ``first_port``: its
    ``fnv``, ``segfold`` and ``lower`` modules, built into ``build_dir``."""
    alias = "first_port"
    init = os.path.join(root, "dampr_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    mods = {name: importlib.import_module("{}.ops.{}".format(alias, name))
            for name in ("fnv", "segfold", "lower")}
    build = importlib.import_module(alias + ".csrc.build")
    build.BUILD_DIR = build_dir
    build.build_all([mods["fnv"].KERNEL, mods["segfold"].KERNEL])
    return mods


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("first_port", metavar="DIR",
                    help="a checkout of commit af2fa24")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_first_port: no CUDA card visible", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from dampr_tpu_torch.csrc import build

    sys.dont_write_bytecode = True  # write nothing into DIR
    old = load_first_port(os.path.abspath(args.first_port), build.BUILD_DIR)
    fnv, segfold, lower = old["fnv"], old["segfold"], old["lower"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: " + card, flush=True)

    dev = torch.device("cuda")
    workdir = tempfile.mkdtemp(prefix="dampr-first-port-")
    try:
        corpus = os.path.join(workdir, "corpus.txt")
        cs.make_corpus(corpus, 8, args.seed)  # the batch reads its first 8 MiB
        mat, lens, lines, _ = cs.corpus_batch(torch, corpus, dev, True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rng = np.random.RandomState(args.seed)
    sizes = {"main": (mat, lens, lines),
             "2^22": cs.random_batch(torch, dev, rng, 1 << 22, mat.shape[1])}
    out = []
    for label, (m, ln, li) in sizes.items():
        n, L = m.shape
        live_bytes = int(ln.clamp(0, L).sum())
        h1, h2 = fnv.fnv(m, ln)
        _p, sh1, sh2, sinv, v, _sp = lower.sort_segments(h1, h2, ln, li, True)
        entry = {"size": label, "shape": [n, L],
                 "fnv": cs.timing(torch, lambda: fnv.fnv(m, ln), args.reps,
                                  K1_NAMES),
                 "fnv_bound": cs.bound_ms(n * L + 12 * n, 4 * live_bytes),
                 "segfold": cs.timing(torch, lambda: segfold.segfold(
                     sh1, sh2, v, sinv), args.reps, K2_NAMES, launches=3),
                 "segfold_bound": cs.bound_ms(21 * n, 4 * n)}
        if label == "main":
            entry["token_fold"] = cs.timing(
                torch, lambda: lower.token_fold(m, ln, li, True), args.reps,
                launches=60)
        out.append(entry)
    print(json.dumps({"first_port": args.first_port, "card": card,
                      "sizes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
