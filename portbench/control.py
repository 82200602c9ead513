"""The controls of ``correct``: each cell's reference, with the one step
down that would tempt a later change, put in the program's place and held
to the same comparison.  A control has to come out not correct.

    python3 -m portbench.control --workload tfidf-20x --seeds 11 12 13

prints one JSON line a seed with the compared numbers (the run's
``checks``).  The TF-IDF control computes idf in float32 where the
configuration states float64; the word count's groups tokens by their
first 16 bytes where the configuration states exact keys.
"""

import argparse
import json
import sys
import tempfile

from portbench import check, registry


def readings(bench, workload, seed):
    """The control's compared numbers on one seed, at the cell's size."""
    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    ref = bench.module("reference", cell["config"])
    with tempfile.TemporaryDirectory() as work:
        truth = bench.maker(traffic).make(traffic, seed, work, bench)["truth"]
    want = ref.expected(*truth)
    got = ref.control(*truth)
    return {"{}_rows".format(k): v
            for k, v in check.mismatches(got, want).items()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = registry.Bench()
    for seed in args.seeds:
        r = readings(bench, args.workload, seed)
        r.update(workload=args.workload, seed=seed,
                 correct=all(v == 0 for v in r.values()))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
