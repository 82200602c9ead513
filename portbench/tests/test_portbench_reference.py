import math

from portbench import check, registry

TEXT = "The cat, the hat.\n\nA CAT sat\nhat hat hat\n"


def test_tfidf_reference_by_hand():
    ref = registry.load_module("reference", "tfidf-shakespeare")
    got = ref.expected(TEXT, 2)
    lines = 8  # 4 lines (one blank) twice
    # df: the 2 lines x2, cat 2 x2, hat 2 x2, a 1 x2, sat 1 x2
    want = {"the": 2, "cat": 4, "hat": 4, "a": 2, "sat": 2}
    assert {w: v[0] for w, v in got.items()} == want
    for w, n in want.items():
        assert got[w][1] == str(math.log(1 + float(lines) / n))
    work = ref.work(TEXT, 2)
    assert work["tokens"] == 2 * 10
    assert work["distinct_keys"] == 5


def test_tfidf_control_differs_in_its_precision():
    ref = registry.load_module("reference", "tfidf-shakespeare")
    counts = check.mismatches(ref.control(TEXT, 2), ref.expected(TEXT, 2))
    assert counts["missing"] == counts["extra"] == 0
    assert counts["wrong"] == 5


def test_wc_reference_by_hand():
    ref = registry.load_module("reference", "wordcount-shakespeare")
    got = ref.expected(TEXT, 3)
    assert got == {"The": 3, "cat,": 3, "the": 3, "hat.": 3, "A": 3,
                   "CAT": 3, "sat": 3, "hat": 9}
    assert ref.load([("a", 1), ("b", 2)]) == {"a": 1, "b": 2}
    # a key the program emits twice is one wrong row
    assert check.total(check.mismatches(ref.load([("a", 1), ("a", 1)]),
                                        {"a": 2})) == 1


def test_wc_control_breaks_exact_keys():
    ref = registry.load_module("reference", "wordcount-shakespeare")
    text = "abcdefghijklmnopq abcdefghijklmnopr x\n"
    counts = check.mismatches(ref.control(text, 1), ref.expected(text, 1))
    assert counts["missing"] == 2 and counts["extra"] == 1


def test_references_import_nothing_of_the_port():
    import ast
    import os

    for name in os.listdir(os.path.join(registry.HERE, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(registry.HERE, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "dampr_tpu_torch", "dampr_tpu", "jax", "portbench"), \
                    (name, m)
