"""Plain reference of upstream Dampr's ``examples/wc.py``: every
whitespace-split token of every line, counted.  The corpus is ``factor``
copies of the base, so the base is counted once and scaled.  Imports
nothing of the port.
"""

from collections import Counter

#: The control's lane: keys cut to the 16 bytes a padded lane of that
#: width holds (the tempting step of capping the lane width).
CONTROL_LANE = 16


def expected(base, factor):
    """``{token: count}`` over the corpus."""
    return {w: k * factor for w, k in Counter(base.split()).items()}


def control(base, factor):
    """The reference with its guarantee of exact keys broken: tokens are
    grouped by their first 16 bytes."""
    c = Counter()
    for w, k in Counter(base.split()).items():
        c[w[:CONTROL_LANE]] += k * factor
    return dict(c)


def load(output):
    """The program's records (``(token, count)`` pairs) as rows."""
    got = {}
    for w, k in output:
        if w in got:  # a key twice is a wrong row, not a sum
            got[w] = None
        else:
            got[w] = k
    return got


def work(base, factor):
    tokens = base.split()
    return {"tokens": len(tokens) * factor,
            "token_bytes": sum(map(len, tokens)) * factor,
            "distinct_keys": len(set(tokens)),
            "bytes": sum(map(len, tokens)) * factor + 8 * len(set(tokens))}
