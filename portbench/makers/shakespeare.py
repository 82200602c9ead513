"""The Shakespeare-shaped text: a base text made from the seed, stored as
``factor`` copies, plain or BGZF.  The maker of every traffic file that
names no ``maker``.

A traffic file gives the base's shape under ``base``, or the name of
another traffic file whose ``base`` it shares; how many copies of it make
the corpus under ``factor``; and, under ``storage``, how the corpus is
stored: ``"plain"`` (the default) or ``"bgzf"`` (see
:func:`portbench.corpus.write_copies`).  Every count in the text is fixed
by the base alone: the word lengths of the vocabulary, each word's number
of occurrences, the words per line, the blank, indented and upper-case
lines, and the punctuation.  The seed chooses only the letters of each
word and the order of everything.  So every seed gives the same bytes,
lines and tokens, in another order, and the lane widths the port pads to
are the same for every seed.

Shape of ``base`` (all keys required):

- ``bytes``: the base's exact size; the last line is padded with spaces.
- ``word_lengths``: ``{length: number of distinct words}``; the sum is the
  number of distinct lower-case words.
- ``zipf``: ``{"a", "s", "q"}``; the word of rank r occurs
  ``max(1, round(a / (r + q) ** s))`` times.
- ``length_rank_sigma``: short words take the frequent ranks: ranks are
  ordered by ``log(length)`` plus normal noise of this deviation.
- ``line_words``: ``{words: weight}``, the words on a non-blank line.
- ``blank_share``, ``indent_share``, ``indent``, ``upper_share``: blank
  lines, lines indented by ``indent`` spaces, and lines in capitals, each
  as a share of the non-blank lines (blank lines of all lines).
- ``comma_share``: tokens followed by a comma, as a share of the tokens
  that do not end a line.
- ``line_end``: ``{mark: weight}``, what follows a line's last word
  (``""`` for nothing).
- ``layout_seed``: the seed of the fixed counts above (not ``--seed``).

Each line's first word is capitalised.  Words are lower-case ASCII
letters, so splitting on ``[^\\w]+`` after lowering gives exactly the
vocabulary.  The truth the references read is ``(base text, factor)``.
"""

import os

import numpy as np

from portbench import corpus

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def _fixed_counts(weights, total, rng):
    """Whole counts for ``{key: weight}`` summing to ``total`` (largest
    remainders, ties broken by ``rng``)."""
    keys = list(weights)
    w = np.array([float(weights[k]) for k in keys])
    raw = w / w.sum() * total
    base = np.floor(raw).astype(np.int64)
    left = int(total - base.sum())
    order = np.lexsort((rng.random(len(keys)), -(raw - base)))
    base[order[:left]] += 1
    return dict(zip(keys, base.tolist()))


class Layout(object):
    """What every seed shares: per rank its word length and count, the
    lines' word counts, and how many lines and tokens carry each mark."""

    def __init__(self, base):
        rng = np.random.default_rng(int(base["layout_seed"]))
        hist = {int(k): int(v) for k, v in base["word_lengths"].items()}
        lengths = np.repeat(np.array(sorted(hist), dtype=np.int64),
                            [hist[k] for k in sorted(hist)])
        self.n_words = len(lengths)
        key = np.log(lengths) + rng.normal(0.0, base["length_rank_sigma"],
                                           self.n_words)
        self.rank_lengths = lengths[np.argsort(key, kind="stable")]
        z = base["zipf"]
        r = np.arange(1, self.n_words + 1, dtype=np.float64)
        self.rank_counts = np.maximum(
            1, np.rint(z["a"] / (r + z["q"]) ** z["s"])).astype(np.int64)
        self.n_tokens = int(self.rank_counts.sum())
        # words per non-blank line: a fixed multiset summing to n_tokens
        lw = {int(k): float(v) for k, v in base["line_words"].items()}
        mean = sum(k * v for k, v in lw.items()) / sum(lw.values())
        n_lines = int(round(self.n_tokens / mean))
        per = _fixed_counts(lw, n_lines, rng)
        words = np.repeat(np.array(sorted(per), dtype=np.int64),
                          [per[k] for k in sorted(per)])
        diff = self.n_tokens - int(words.sum())
        i = 0
        while diff:  # spread the remainder one word at a time
            step = 1 if diff > 0 else -1
            j = i % len(words)
            if words[j] + step >= 1:
                words[j] += step
                diff -= step
            i += 1
        self.line_words = words
        self.n_text_lines = len(words)
        self.n_blank = int(round(base["blank_share"] * self.n_text_lines /
                                 (1.0 - base["blank_share"])))
        self.n_indent = int(round(base["indent_share"] * self.n_text_lines))
        self.indent = int(base["indent"])
        self.n_upper = int(round(base["upper_share"] * self.n_text_lines))
        self.n_comma = int(round(base["comma_share"] *
                                 (self.n_tokens - self.n_text_lines)))
        self.line_end = _fixed_counts(base["line_end"], self.n_text_lines,
                                      rng)
        self.bytes = int(base["bytes"])
        self.unpadded = (int((self.rank_lengths * self.rank_counts).sum())
                         + (self.n_tokens - self.n_text_lines)  # spaces
                         + self.n_comma
                         + sum(len(m) * c for m, c in self.line_end.items())
                         + self.n_indent * self.indent
                         + self.n_text_lines + self.n_blank)  # newlines
        if self.unpadded > self.bytes:
            raise ValueError("the base's shape needs {} bytes, over its "
                             "stated {}".format(self.unpadded, self.bytes))

    @property
    def n_lines(self):
        return self.n_text_lines + self.n_blank


def _vocabulary(layout, rng):
    """Distinct lower-case words, one per rank, with the rank's length."""
    words = [None] * layout.n_words
    for length in np.unique(layout.rank_lengths):
        ranks = np.flatnonzero(layout.rank_lengths == length)
        n = len(ranks)
        length = int(length)
        if 26 ** length < 4 * n:  # small spaces: draw without replacement
            if 26 ** length < n:
                raise ValueError("{} distinct words of {} letters".format(
                    n, length))
            codes = rng.choice(26 ** length, size=n, replace=False)
            digits = (codes[:, None] // 26 ** np.arange(length)[None, :]) % 26
        else:
            seen, rows = set(), []
            while len(rows) < n:
                draw = rng.integers(0, 26, size=(n - len(rows), length))
                for row in draw:
                    key = row.tobytes()
                    if key not in seen:
                        seen.add(key)
                        rows.append(row)
            digits = np.array(rows)
        text = LETTERS[digits].tobytes().decode("ascii")
        for i, rank in enumerate(ranks):
            words[rank] = text[i * length:(i + 1) * length]
    return words


def base_text(base, seed):
    """The base text (``str``) for one seed: ``len`` is ``base["bytes"]``."""
    layout = Layout(base)
    rng = corpus._seed_rng(seed)
    vocab = _vocabulary(layout, rng)
    ids = np.repeat(np.arange(layout.n_words), layout.rank_counts)
    rng.shuffle(ids)
    tokens = [vocab[i] for i in ids.tolist()]
    words = layout.line_words.copy()
    rng.shuffle(words)
    ends = np.cumsum(words)
    starts = ends - words
    # commas after tokens that do not end a line
    inner = np.ones(layout.n_tokens, dtype=bool)
    inner[ends - 1] = False
    for i in rng.choice(np.flatnonzero(inner), size=layout.n_comma,
                        replace=False).tolist():
        tokens[i] += ","
    for i in starts.tolist():
        tokens[i] = tokens[i].capitalize()
    marks = np.repeat(np.array(list(layout.line_end), dtype=object),
                      list(layout.line_end.values()))
    rng.shuffle(marks)
    upper = np.zeros(layout.n_text_lines, dtype=bool)
    upper[rng.choice(layout.n_text_lines, size=layout.n_upper,
                     replace=False)] = True
    indent = np.zeros(layout.n_text_lines, dtype=bool)
    indent[rng.choice(layout.n_text_lines, size=layout.n_indent,
                      replace=False)] = True
    pad = " " * layout.indent
    lines = []
    for j, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
        line = " ".join(tokens[a:b]) + marks[j]
        if upper[j]:
            line = line.upper()
        lines.append(pad + line if indent[j] else line)
    # blank lines between text lines, never first
    slots = np.sort(rng.choice(np.arange(1, layout.n_text_lines),
                               size=layout.n_blank, replace=True))
    out, prev = [], 0
    for s in slots.tolist():
        out.extend(lines[prev:s])
        out.append("")
        prev = s
    out.extend(lines[prev:])
    out[-1] += " " * (layout.bytes - layout.unpadded)
    text = "\n".join(out) + "\n"
    if len(text) != layout.bytes:
        raise AssertionError("base text is {} bytes, not {}".format(
            len(text), layout.bytes))
    return text


def make(traffic, seed, work_dir, bench):
    """The corpus of ``traffic`` for ``seed`` in ``work_dir`` (the maker
    contract: :func:`portbench.registry.Bench.maker`)."""
    base = traffic["base"]
    if isinstance(base, str):  # another traffic file's base, by name
        base = bench.traffic(base)["base"]
    text = base_text(base, seed)
    factor = int(traffic["factor"])
    storage = traffic.get("storage", "plain")
    path = os.path.join(work_dir, "corpus" + corpus.SUFFIX[storage])
    about = corpus.write_copies(path, text.encode("ascii"), factor,
                                storage)
    size = about.pop("stored_bytes")
    about.update(storage=storage, copies=factor, base_bytes=len(text))
    return {"input": path, "bytes": len(text) * factor,
            "stored_bytes": size, "truth": (text, factor), "about": about}
