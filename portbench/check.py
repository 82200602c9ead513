"""The comparison that decides ``correct``: the program's rows against the
reference's, key by key and exactly."""


def mismatches(got, want):
    """Rows missing from ``got``, rows it has that ``want`` lacks, and rows
    whose value differs, between two ``{key: value}`` dicts."""
    missing = sum(1 for k in want if k not in got)
    extra = sum(1 for k in got if k not in want)
    wrong = sum(1 for k, v in want.items() if k in got and got[k] != v)
    return {"missing": missing, "extra": extra, "wrong": wrong}


def total(counts):
    return counts["missing"] + counts["extra"] + counts["wrong"]
