"""Plain reference of upstream Dampr's ``benchmarks/tf-idf-dampr.py``.

Per line, the set of lower-cased ``[^\\w]+`` tokens (the empty token at a
line's edges dropped); a token's document frequency is the number of lines
that hold it; idf = log(1 + lines / df) in float64, printed by ``str`` as
the sink prints it.  The corpus is ``factor`` copies of the base, so the
base is counted once and scaled.  Imports nothing of the port.
"""

import math
import os
import re
from collections import Counter

import numpy as np

RX = re.compile(r"[^\w]+")


def _lines(base):
    lines = base.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def _doc_freq(base):
    c = Counter()
    for line in _lines(base):
        c.update(t for t in set(RX.split(line.lower())) if t)
    return c, len(_lines(base))


def expected(base, factor):
    """``{token: (df, str(idf))}`` over the corpus."""
    c, n = _doc_freq(base)
    total = n * factor
    return {w: (k * factor, str(math.log(1 + float(total) / (k * factor))))
            for w, k in c.items()}


def control(base, factor):
    """The reference one precision down: idf in float32, not float64."""
    c, n = _doc_freq(base)
    total = np.float32(n * factor)
    one = np.float32(1)
    return {w: (k * factor,
                str(float(np.log(one + total / np.float32(k * factor)))))
            for w, k in c.items()}


def load(output):
    """The program's sink (a directory of TSV part files) as rows."""
    got = {}
    for part in sorted(os.listdir(output)):
        with open(os.path.join(output, part)) as f:
            for line in f:
                w, c, idf = line.rstrip("\n").split("\t")
                got[w] = (int(c), idf)
    return got


def work(base, factor):
    """What the lowered fold must do, counted from the corpus: every
    token's bytes read once, every distinct token's count (8 bytes)
    written once."""
    tokens = token_bytes = 0
    for line in _lines(base):
        for t in RX.split(line.lower()):
            if t:
                tokens += 1
                token_bytes += len(t)
    distinct = len(_doc_freq(base)[0])
    return {"tokens": tokens * factor, "token_bytes": token_bytes * factor,
            "distinct_keys": distinct,
            "bytes": token_bytes * factor + 8 * distinct}
