"""The ported plan step and host record path against the JAX package.

The port's lowering decisions (the granularity guards of
``dampr_tpu/plan/lower.py``) must match the reference's stage by stage,
the combiner hoist must keep the scanner lowered, and the host record
path (``fold_by``, ``map``) must read back the reference's records.
Tolerance: exact.
"""

import operator

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu.ops import text as ref_text
from dampr_tpu.plan import lower as ref_plan_lower
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import text as port_text
from dampr_tpu_torch.plan import lower as port_plan_lower


@pytest.fixture(autouse=True)
def cpu_device():
    old = port_settings.device
    port_settings.device = "cpu"
    yield
    port_settings.device = old


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _word_lines(tmp_path, seed):
    """One word per line (the record path's keys), as a text file."""
    rng = np.random.RandomState(seed)
    words = rng.choice(["a", "bb", "Cc", "d_d", "é"], 500)
    return _write(tmp_path, "words.txt",
                  ("\n".join(words) + "\n").encode())


class TestRecordPathParity:
    """The host record path the slice ports for fold_by / map / sink."""

    def test_fold_by_word_count(self, tmp_path):
        path = _word_lines(tmp_path, 1)

        def run(pkg):
            return (pkg.Dampr.text(path, 700)
                    .fold_by(lambda w: w, operator.add, lambda w: 1).read())

        assert run(dampr_tpu_torch) == run(dampr_tpu)

    @pytest.mark.parametrize("binop", [operator.add, min, max,
                                       lambda a, b: a * 31 + b])
    def test_fold_by_ops(self, tmp_path, binop):
        path = _word_lines(tmp_path, 2)

        def run(pkg):
            return (pkg.Dampr.text(path, 900)
                    .fold_by(lambda w: w, binop, lambda w: len(w) * 7 + 1)
                    .map(lambda kv: (kv[0], kv[1] % 1000003)).read())

        assert run(dampr_tpu_torch) == run(dampr_tpu)

    def test_text_fold_by_line_length(self, tmp_path):
        path = _word_lines(tmp_path, 3)

        def run(pkg):
            return (pkg.Dampr.text(path, 5000)
                    .fold_by(lambda line: len(line), operator.add,
                             lambda line: 1).read())

        assert run(dampr_tpu_torch) == run(dampr_tpu)


def _ref_graph(kind, path):
    docs = dampr_tpu.Dampr.text(path, 1000)
    x = docs.custom_mapper(ref_text.DocFreq(mode="word", lower=True,
                                            pair_values=False))
    return _shape(kind, x, docs)


def _port_graph(kind, path):
    docs = dampr_tpu_torch.Dampr.text(path, 1000)
    x = docs.custom_mapper(port_text.DocFreq(mode="word", lower=True,
                                             pair_values=False))
    return _shape(kind, x, docs)


def _shape(kind, x, docs):
    if kind == "sum":
        out = x.fold_values(operator.add)
        return out.pmer.graph, ()
    if kind == "min":
        out = x.fold_values(min)
        return out.pmer.graph, ()
    if kind == "opaque_fold":
        out = x.fold_values(lambda a, b: a + b)
        return out.pmer.graph, ()
    if kind == "branched":
        folded = x.fold_values(operator.add)
        # a branch no analyzer certifies as a numeric lane program
        branch = x.map(lambda c: "%d" % c)
        return folded.pmer.graph.union(branch.pmer.graph), ()
    if kind == "requested":
        return x.pmer.graph, (x.source,)
    if kind == "tfidf":
        # the tap feeds DocFreq and the len() scan; the cross has two
        # inputs
        idf = x.fold_values(operator.add).cross_right(
            docs.len(), lambda d, t: (d[0], d[1], t), memory=True)
        return idf.pmer.graph, (idf.source,)
    if kind == "join":
        out = (x.fold_values(operator.add)
               .join(docs.group_by(lambda line: line.split(" ")[0]))
               .outer_reduce(lambda l, r: (list(l), list(r))))
        return out.pmer.graph, (out.source,)
    raise ValueError(kind)


class TestLoweringDecisions:
    @pytest.mark.parametrize("kind", ["sum", "min", "opaque_fold",
                                      "branched", "requested", "tfidf",
                                      "join"])
    def test_targets_match_reference(self, tmp_path, kind):
        path = _write(tmp_path, "c.txt", b"a b\n")
        rg, routs = _ref_graph(kind, path)
        pg, pouts = _port_graph(kind, path)
        want = [(d["kind"], d["target"])
                for d in ref_plan_lower.analyze(rg, outputs=routs)]
        got = [(d["kind"], d["target"])
               for d in port_plan_lower.analyze(pg, outputs=pouts)]
        assert got == want

    def test_kill_switch_keeps_scanner_on_host(self, tmp_path):
        path = _write(tmp_path, "c.txt", b"a b\n")
        pipe = (dampr_tpu_torch.Dampr.text(path)
                .custom_mapper(port_text.DocFreq(), lower=False)
                .fold_values(operator.add))
        decisions = port_plan_lower.analyze(pipe.pmer.graph)
        scanner = [d for d in decisions if d["kind"] == "map"][0]
        assert scanner["target"] == "host"
        assert "lower=False" in scanner["reason"]

    def test_hoisted_sum_combiner_still_lowers(self, tmp_path):
        from dampr_tpu_torch.plan import passes

        path = _write(tmp_path, "c.txt", b"a b\n")
        pipe = (dampr_tpu_torch.Dampr.text(path)
                .custom_mapper(port_text.DocFreq(pair_values=False))
                .fold_values(operator.add))
        graph, report = passes.optimize(pipe.pmer.graph, [pipe.source])
        assert report["rules"] == {"fuse_maps": 0, "hoist_combiners": 1,
                                   "fuse_sinks": 0, "dead_stages": 0}
        assert len(graph.stages) == len(pipe.pmer.graph.stages) - 1
        decisions = port_plan_lower.analyze(graph, outputs=[pipe.source])
        assert [(d["kind"], d["target"]) for d in decisions] == [
            ("map", "device"), ("reduce", "device")]
