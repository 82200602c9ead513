"""Checkpoint/resume of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_resume.py`` and
``tests/test_writer_pool.py::TestResumeConsistency``, with
``test_hbm_tier.py::test_resume_persists_device_refs`` (here with the
handoff's device refs too) and
``test_observability.py::test_checkpoint_spans_on_resume``.  A run that
dies mid-pipeline reruns under the same name and skips every stage it
completed; a change to the pipeline's code, parameters or input files
invalidates exactly the affected suffix.

Each scenario runs through both packages (each under its own scratch
root, the same run names, 8 partitions): the records, the sink bytes, the
number of times a traced UDF ran and which stages restored are equal.
The port's device is the CPU.  Every comparison is exact.
"""

import functools
import json
import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import resume, settings, storage
from dampr_tpu_torch.runner import MTRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = (("ref", dampr_tpu, ref_settings),
        ("port", dampr_tpu_torch, settings))


@pytest.fixture(autouse=True)
def knobs(tmp_path):
    old = {tag: (s.partitions, s.scratch_root) for tag, _p, s in PKGS}
    old_dev = settings.device
    old_mesh = (ref_settings.mesh_fold, ref_settings.mesh_exchange)
    for tag, _p, s in PKGS:
        s.partitions = 8
        s.scratch_root = str(tmp_path / (tag + "-scratch"))
    settings.device = "cpu"
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    yield
    for tag, _p, s in PKGS:
        s.partitions, s.scratch_root = old[tag]
    settings.device = old_dev
    ref_settings.mesh_fold, ref_settings.mesh_exchange = old_mesh


@pytest.fixture
def workdir(tmp_path):
    d = tmp_path / "work"
    d.mkdir()
    return str(d)


def _inc(v):
    return v + 1


def _dec(v):
    return v - 1


def _scaled(kv, factor):
    return (kv[0], kv[1] * factor)


def _run_root(s, name):
    return os.path.join(s.scratch_root, name.replace("/", "_"))


def _trace_mapper(trace_path):
    """A per-record side effect through a captured PATH (a constant: file
    contents are not fingerprinted, so recording executions does not
    invalidate the stage)."""
    def fn(x):
        with open(trace_path, "a") as f:
            f.write("m\n")
        return (x % 5, 1)
    return fn


def _count(path):
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)


def _boom_if(flag_path):
    def fn(kv):
        if os.path.exists(flag_path):
            raise RuntimeError("injected failure")
        return (kv[0], kv[1] * 10)
    return fn


def _restored(em):
    return [s["kind"] for s in em.stats if s["kind"].startswith("resumed-")]


def _both(scenario, workdir):
    """``{"ref": scenario(pkg, s, wd), "port": ...}``, each package in its
    own work directory."""
    out = {}
    for tag, pkg, s in PKGS:
        wd = os.path.join(workdir, tag)
        os.makedirs(wd, exist_ok=True)
        out[tag] = scenario(pkg, s, wd)
    return out


class TestResume:
    def test_requires_name(self):
        for _tag, pkg, _s in PKGS:
            with pytest.raises(ValueError):
                pkg.Dampr.memory([1, 2, 3]).run(resume=True)
            with pytest.raises(ValueError):
                pkg.Dampr.run(pkg.Dampr.memory([1, 2]), resume=True)

    def test_crash_then_resume_skips_completed_stages(self, workdir):
        def scenario(pkg, s, wd):
            trace = os.path.join(wd, "trace")
            flag = os.path.join(wd, "boom")

            def build():
                counted = (pkg.Dampr.memory(list(range(40)), partitions=4)
                           .map(_trace_mapper(trace))
                           .fold_by(lambda kv: kv[0],
                                    value=lambda kv: kv[1],
                                    binop=lambda a, b: a + b))
                return counted.map(_boom_if(flag)).group_by(
                    lambda kv: kv[0]).reduce(
                        lambda k, vs: (k, sum(v[1] for v in vs)))

            open(flag, "w").close()
            with pytest.raises(RuntimeError):
                build().run(name="resume-crash", resume=True)
            first_pass = _count(trace)
            os.unlink(flag)
            out = build().run(name="resume-crash", resume=True)
            got = dict(out.stream())
            kinds = [st["kind"] for st in out.stats]
            return first_pass, got, _count(trace), kinds

        out = _both(scenario, workdir)
        first_pass, got, after, kinds = out["port"]
        assert first_pass == 40  # the fold stage completed before the crash
        assert got == {k: (k, 80) for k in range(5)}
        assert after == first_pass  # restored, not run again
        assert any(k.startswith("resumed-") for k in kinds)
        assert kinds.index("reduce") > 0  # the crashed suffix really ran
        assert out["port"][:3] == out["ref"][:3]
        assert [k for k in kinds if k.startswith("resumed-")] == \
            [k for k in out["ref"][3] if k.startswith("resumed-")]

    def test_rerun_after_success_serves_outputs(self, workdir):
        def scenario(pkg, s, wd):
            trace = os.path.join(wd, "trace")

            def build():
                return (pkg.Dampr.memory(list(range(30)), partitions=3)
                        .map(_trace_mapper(trace))
                        .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                 binop=lambda a, b: a + b))

            first = dict(build().run(name="resume-rerun",
                                     resume=True).stream())
            n1 = _count(trace)
            second = build().run(name="resume-rerun", resume=True)
            return (first, dict(second.stream()), n1, _count(trace),
                    _restored(second),
                    all(st["kind"].startswith("resumed-") or st["jobs"] == 0
                        for st in second.stats))

        out = _both(scenario, workdir)
        first, second, n1, n2, restored, none_ran = out["port"]
        assert second == first and n2 == n1 and none_ran and restored
        assert out["port"] == out["ref"]

    def test_changed_lambda_invalidates_only_downstream(self, workdir):
        def scenario(pkg, s, wd):
            trace = os.path.join(wd, "trace")

            def build(scale):
                base = (pkg.Dampr.memory(list(range(20)), partitions=2)
                        .map(_trace_mapper(trace))
                        .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                 binop=lambda a, b: a + b))
                return base.map(lambda kv: (kv[0], kv[1] * scale))

            a = dict(build(2).run(name="resume-invalidate",
                                  resume=True).stream())
            n1 = _count(trace)
            em = build(3).run(name="resume-invalidate", resume=True)
            return a, dict(em.stream()), n1, _count(trace), _restored(em)

        out = _both(scenario, workdir)
        a, b, n1, n2, restored = out["port"]
        assert n2 == n1  # the upstream fold restored
        assert b == {k: v * 3 // 2 for k, v in a.items()}
        assert restored
        assert out["port"] == out["ref"]

    def test_switching_global_helper_invalidates(self, workdir):
        """Two lambdas calling different module-level helpers compile to
        identical bytecode; only co_names and the helpers' own
        fingerprints tell them apart."""
        def scenario(pkg, s, wd):
            a = dict((pkg.Dampr.memory(list(range(10)), partitions=2)
                      .map(lambda x: (x % 2, _inc(x)))
                      .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                               binop=lambda a, b: a + b))
                     .run(name="resume-conames", resume=True).stream())
            b = dict((pkg.Dampr.memory(list(range(10)), partitions=2)
                      .map(lambda x: (x % 2, _dec(x)))
                      .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                               binop=lambda a, b: a + b))
                     .run(name="resume-conames", resume=True).stream())
            return a, b

        out = _both(scenario, workdir)
        a, b = out["port"]
        assert a == {0: sum(x + 1 for x in range(0, 10, 2)),
                     1: sum(x + 1 for x in range(1, 10, 2))}
        assert b == {0: sum(x - 1 for x in range(0, 10, 2)),
                     1: sum(x - 1 for x in range(1, 10, 2))}
        assert out["port"] == out["ref"]

    def test_changed_partial_invalidates(self, workdir):
        """``functools.partial`` hides its state from an attribute walk;
        its func, args and keywords still drive the fingerprint."""
        def scenario(pkg, s, wd):
            def run(factor):
                return dict(
                    (pkg.Dampr.memory(list(range(12)), partitions=2)
                     .map(lambda x: (x % 3, 1))
                     .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                              binop=lambda a, b: a + b)
                     .map(functools.partial(_scaled, factor=factor)))
                    .run(name="resume-partial", resume=True).stream())

            return run(2), run(5)

        out = _both(scenario, workdir)
        assert out["port"] == ({k: 8 for k in range(3)},
                               {k: 20 for k in range(3)})
        assert out["port"] == out["ref"]

    def test_edit_rerun_cycles_prune_superseded_blocks(self, workdir):
        """N edit/rerun cycles keep one copy of each stage's output in the
        checkpoint tree, not N."""
        def scenario(pkg, s, wd):
            def run(factor):
                return dict(
                    (pkg.Dampr.memory(list(range(50)), partitions=2)
                     .map(lambda x: (x % 5, 1))
                     .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                              binop=lambda a, b: a + b)
                     .map(functools.partial(_scaled, factor=factor)))
                    .run(name="resume-prune", resume=True).stream())

            counts, results = [], []
            for factor in (1, 2, 3, 4):
                results.append(run(factor))
                counts.append(sum(len(fs) for _d, _s, fs in os.walk(
                    os.path.join(_run_root(s, "resume-prune"), "ckpt"))))
            return counts, results

        out = _both(scenario, workdir)
        counts, results = out["port"]
        assert counts[-1] == counts[0], counts
        assert results == out["ref"][1]

    def test_changed_input_file_invalidates(self, workdir):
        def scenario(pkg, s, wd):
            path = os.path.join(wd, "data.txt")
            with open(path, "w") as f:
                f.write("a b\nb c\n")

            def build():
                return (pkg.Dampr.text(path)
                        .flat_map(lambda line: line.split())
                        .fold_by(lambda t: t, value=lambda t: 1,
                                 binop=lambda a, b: a + b))

            a = dict(build().run(name="resume-input", resume=True).stream())
            with open(path, "w") as f:
                f.write("c c\n")
            os.utime(path, (1, 1))  # a visible mtime change regardless
            b = dict(build().run(name="resume-input", resume=True).stream())
            return a, b

        out = _both(scenario, workdir)
        assert out["port"] == ({"a": 1, "b": 2, "c": 1}, {"c": 2})
        assert out["port"] == out["ref"]

    def test_sink_and_multi_output_resume(self, workdir):
        def scenario(pkg, s, wd):
            trace = os.path.join(wd, "trace")
            sinkdir = os.path.join(wd, "out")

            def build():
                base = (pkg.Dampr.memory(list(range(24)), partitions=2)
                        .map(_trace_mapper(trace)))
                counts = base.fold_by(lambda kv: kv[0],
                                      value=lambda kv: kv[1],
                                      binop=lambda a, b: a + b)
                sunk = counts.map(
                    lambda kv: "{}\t{}".format(*kv)).sink(sinkdir)
                return counts, sunk

            c1, s1 = build()
            r1 = pkg.Dampr.run(c1, s1, name="resume-sink", resume=True)
            n1 = _count(trace)
            want = dict(r1[0].stream())
            c2, s2 = build()
            r2 = pkg.Dampr.run(c2, s2, name="resume-sink", resume=True)
            lines = sorted(
                line for p in os.listdir(sinkdir)
                for line in open(os.path.join(sinkdir, p)).read()
                .splitlines())
            parts = sorted(os.listdir(sinkdir))
            return (want, dict(r2[0].stream()), n1, _count(trace), lines,
                    bool(parts) and all(p.startswith("part-")
                                        for p in parts))

        out = _both(scenario, workdir)
        want, got, n1, n2, lines, parts_ok = out["port"]
        assert want == {k: len(range(k, 24, 5)) for k in range(5)}
        assert got == want and n2 == n1 and parts_ok
        assert out["port"] == out["ref"]

    def test_resume_under_tiny_budget_spills(self, workdir):
        """Checkpointed blocks double as spill files: the run stays exact
        under a budget far below the data, and the rerun restores."""
        def scenario(pkg, s, wd):
            def build():
                return (pkg.Dampr.memory(list(range(5000)), partitions=4)
                        .map(lambda x: (x % 97, 1))
                        .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                 binop=lambda a, b: a + b))

            a = dict(build().run(name="resume-budget", resume=True,
                                 memory_budget=1 << 14).stream())
            em = build().run(name="resume-budget", resume=True,
                             memory_budget=1 << 14)
            return a, dict(em.stream()), _restored(em)

        out = _both(scenario, workdir)
        a, b, restored = out["port"]
        assert a == {k: len(range(k, 5000, 97)) for k in range(97)}
        assert b == a and restored
        assert out["port"] == out["ref"]

    def test_partition_count_change_invalidates(self, workdir):
        """A restored partition set must co-partition with what is
        computed fresh: a new partition count invalidates."""
        def scenario(pkg, s, wd):
            def build():
                left = pkg.Dampr.memory(
                    [("k%d" % (i % 4), i) for i in range(20)],
                    partitions=3).group_by(lambda x: x[0])
                right = pkg.Dampr.memory(
                    [("k%d" % (i % 4), 100 + i) for i in range(8)],
                    partitions=2).group_by(lambda x: x[0])
                return left.join(right).reduce(
                    lambda lit, rit: (len(list(lit)), len(list(rit))))

            a = build().run(name="resume-parts", resume=True,
                            n_partitions=4)
            b = build().run(name="resume-parts", resume=True,
                            n_partitions=7)
            return dict(a.stream()), dict(b.stream()), _restored(b)

        out = _both(scenario, workdir)
        want = {"k%d" % k: (5, 2) for k in range(4)}
        assert out["port"] == (want, want, [])
        assert out["port"] == out["ref"]

    def test_resume_with_scan_shared_branches(self, workdir):
        """Two branches over one text tap run as one scan-shared group;
        both persist, and a rerun restores both without reading the
        tap."""
        def scenario(pkg, s, wd):
            path = os.path.join(wd, "data.txt")
            with open(path, "w") as f:
                for i in range(50):
                    f.write("a b c\n" if i % 2 else "a\n")

            def build():
                docs = pkg.Dampr.text(path)
                wc = (docs.flat_map(lambda line: line.split())
                      .fold_by(lambda t: t, value=lambda t: 1,
                               binop=lambda a, b: a + b))
                return wc, docs.len()

            w1, n1 = build()
            r1 = pkg.Dampr.run(w1, n1, name="resume-scanshare", resume=True)
            first = (dict(r1[0].stream()), list(r1[1].stream()))
            w2, n2 = build()
            r2 = pkg.Dampr.run(w2, n2, name="resume-scanshare", resume=True)
            second = (dict(r2[0].stream()), list(r2[1].stream()))
            return first, second, all(
                st["kind"].startswith("resumed-") or st["jobs"] == 0
                for st in r2[0].stats), _restored(r2[0])

        out = _both(scenario, workdir)
        first, second, none_ran, restored = out["port"]
        assert first == ({"a": 50, "b": 25, "c": 25}, [50])
        assert second == first and none_ran and restored
        assert out["port"] == out["ref"]

    def test_resume_off_is_default_and_untouched(self, workdir):
        def scenario(pkg, s, wd):
            out = (pkg.Dampr.memory(list(range(10)))
                   .map(lambda x: (x % 2, 1))
                   .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                            binop=lambda a, b: a + b)
                   .run(name="resume-off"))
            return dict(out.stream()), os.path.isdir(os.path.join(
                _run_root(s, "resume-off"), "manifest"))

        out = _both(scenario, workdir)
        assert out["port"] == ({0: 5, 1: 5}, False)
        assert out["port"] == out["ref"]

    def test_interrupted_chain_restores_the_same_stages(self, workdir):
        """A four-stage pipeline failing at each stage in turn: the rerun
        restores the same stages in both packages and gives equal
        records."""
        def scenario(pkg, s, wd):
            flag = os.path.join(wd, "boom")
            seen = []
            for fail_at in range(3):
                def build():
                    def gate(i):
                        def fn(kv):
                            if (os.path.exists(flag)
                                    and open(flag).read() == str(i)):
                                raise RuntimeError("dies at {}".format(i))
                            return kv
                        return fn

                    a = (pkg.Dampr.memory(list(range(300)), partitions=3)
                         .map(lambda x: (x % 11, x)).map(gate(0))
                         .checkpoint(force=True))
                    b = a.fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                  binop=lambda x, y: x + y).map(gate(1))
                    return b.map(gate(2)).checkpoint(force=True).map(
                        lambda kv: (kv[0], kv[1] * 2))

                name = "resume-chain-{}".format(fail_at)
                with open(flag, "w") as f:
                    f.write(str(fail_at))
                with pytest.raises(RuntimeError):
                    build().run(name=name, resume=True)
                os.unlink(flag)
                em = build().run(name=name, resume=True)
                seen.append((sorted(em.read()), _restored(em)))
            return seen

        out = _both(scenario, workdir)
        assert out["port"] == out["ref"]
        want = {}
        for x in range(300):
            want[x % 11] = want.get(x % 11, 0) + x
        for records, restored in out["port"]:
            assert records == sorted((k, 2 * v) for k, v in want.items())
        # each later failure point restores at least as much
        assert [len(r) for _rec, r in out["port"]] == sorted(
            len(r) for _rec, r in out["port"])


class TestFingerprintSharpness:
    """Fingerprints never collide across semantically different captured
    state, and equal the JAX package's verdicts (volatile or not)."""

    def test_big_array_content_change_invalidates(self):
        a = np.zeros(1 << 18, dtype=np.float64)  # 2 MB
        b = a.copy()
        assert resume._fp(a) == resume._fp(b)
        b[12345] = 1.0  # same shape and dtype, other contents
        assert resume._fp(a) != resume._fp(b)

    def test_noncontiguous_array_fingerprints_by_content(self):
        base = np.arange(64).reshape(8, 8)
        view = base[:, ::2]  # non-contiguous
        assert resume._fp(view) == resume._fp(view.copy())

    def test_depth_cap_is_volatile(self):
        deep = "leaf"
        for _ in range(resume._MAX_DEPTH + 2):
            deep = [deep]
        fp1, fp2 = resume._fp(deep), resume._fp(deep)
        assert resume.is_volatile(fp1) and resume.is_volatile(fp2)
        assert fp1 != fp2

    @pytest.mark.parametrize("value", [
        1, 2.5, "x", b"y", None, (1, (2, 3)), [1, 2], {"a": [1]},
        frozenset([3, 1]), {4, 2}, np.arange(10), np.float32(1.5),
        functools.partial(_scaled, factor=3)])
    def test_plain_data_fingerprints_equal_reference(self, value):
        """Plain data and module-level code hash to the same digest in
        both packages (the fingerprint is a pure function of content)."""
        from dampr_tpu import resume as ref_resume

        assert resume._fp(value) == ref_resume._fp(value)

    def test_same_size_same_mtime_edit_detected(self, workdir):
        path = os.path.join(workdir, "data.txt")
        with open(path, "w") as f:
            f.write("aaaa\nbbbb\n")
        st = os.stat(path)
        fp1 = resume._stat_fp(path)
        with open(path, "w") as f:
            f.write("aaaa\ncccc\n")  # same size
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert resume._stat_fp(path) != fp1  # the content probe sees it

    def test_volatile_stage_blocks_are_pruned(self, workdir):
        """A stage capturing unfingerprintable state persists no manifest;
        its spilled blocks are deleted at cleanup, not kept forever."""
        class Opaque:
            # no attributes, not picklable: _fp is volatile
            __slots__ = ()

            def __reduce__(self):
                raise TypeError("nope")

            def __call__(self, x):
                return (x % 3, 1)

        def scenario(pkg, s, wd):
            def build():
                return (pkg.Dampr.memory(list(range(30)), partitions=4)
                        .map(Opaque())
                        .fold_by(lambda kv: kv[0], value=lambda kv: kv[1],
                                 binop=lambda a, b: a + b))

            def blk_files():
                found = []
                for d, _dirs, fs in os.walk(
                        _run_root(s, "resume-volatile-prune")):
                    found.extend(f for f in fs if f.endswith(".blk"))
                return found

            got1 = dict(build().run(name="resume-volatile-prune",
                                    resume=True, memory_budget=1).stream())
            n1 = len(blk_files())
            got2 = dict(build().run(name="resume-volatile-prune",
                                    resume=True, memory_budget=1).stream())
            return got1, got2, n1, len(blk_files())

        out = _both(scenario, workdir)
        got1, got2, n1, n2 = out["port"]
        assert got1 == got2 == {0: 10, 1: 10, 2: 10}
        assert n2 <= n1
        assert out["ref"][:2] == out["port"][:2]


class TestChainDepth:
    def test_long_op_chains_stay_resumable(self):
        """Eleven chained per-record ops do not fingerprint volatile: fused
        chains flatten before the depth budget applies."""
        from dampr_tpu_torch.base import Filter, ValueMap, fuse

        ops = [ValueMap(lambda x, i=i: x + i) for i in range(10)]
        ops.insert(5, Filter(lambda x: x % 2 == 0))
        fp1 = resume._fp(fuse(ops))
        assert not resume.is_volatile(fp1), "11-op chain went volatile"
        assert resume._fp(fuse([ValueMap(lambda x, i=i: x + i)
                                for i in range(10)]
                               + [Filter(lambda x: x % 2 == 0)])) != fp1


class TestResumeConsistency:
    @staticmethod
    def _build(pkg, mark):
        return (pkg.Dampr.memory(list(range(5000)), partitions=8)
                .map(lambda x: x + mark)
                .checkpoint(force=True))

    def test_checkpoint_persist_through_pool_restores(self):
        """resume=True persists stage outputs through the writer pool; the
        manifests reference only durable, loadable files (which the JAX
        package's reader loads too)."""
        from dampr_tpu.storage import load_block as ref_load_block

        name = "pool-resume"
        got1 = sorted(self._build(dampr_tpu_torch, 0).run(
            name=name, resume=True, memory_budget=1 << 14).read())
        root = _run_root(settings, name)
        mdir = os.path.join(root, "manifest")
        manifests = sorted(os.listdir(mdir))
        assert manifests
        seen_blocks = 0
        for m in manifests:
            with open(os.path.join(mdir, m)) as f:
                man = json.load(f)
            for entry in man.get("blocks", ()):
                p = os.path.join(root, entry[1])
                assert os.path.exists(p), p
                assert len(storage.load_block(p)) == entry[2]
                assert len(ref_load_block(p)) == entry[2]
                seen_blocks += 1
        assert seen_blocks > 0
        got2 = sorted(self._build(dampr_tpu_torch, 0).run(
            name=name, resume=True, memory_budget=1 << 14).read())
        assert got1 == got2
        assert got1 == sorted(self._build(dampr_tpu, 0).run(
            name=name, resume=True, memory_budget=1 << 14).read())

    def test_pre_frame_checkpoint_dir_restores(self):
        """A checkpoint written in the pre-frame wire format (gzip'd or
        plain pickle-window streams) restores and resumes."""
        import gzip
        import pickle

        name = "pool-oldfmt"
        got1 = sorted(self._build(dampr_tpu_torch, 0).run(
            name=name, resume=True, memory_budget=1 << 30).read())
        root = _run_root(settings, name)
        rewritten = 0
        for dirpath, _dirs, files in os.walk(root):
            for fname in files:
                if not fname.endswith(".blk"):
                    continue
                p = os.path.join(dirpath, fname)
                blk = storage.load_block(p)
                plain = (blk.keys.dtype != object
                         and blk.values.dtype != object)
                opener = open if plain else gzip.open
                with opener(p, "wb") as f:
                    for at in range(0, len(blk), storage.SPILL_WINDOW):
                        w = blk.slice(at, at + storage.SPILL_WINDOW)
                        pickle.dump((w.keys, w.values, w.h1, w.h2), f,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                rewritten += 1
        assert rewritten > 0
        em = self._build(dampr_tpu_torch, 0).run(
            name=name, resume=True, memory_budget=1 << 30)
        assert sorted(em.read()) == got1
        assert _restored(em)


class TestDeviceRefs:
    def test_resume_persists_device_refs(self, monkeypatch):
        """resume=True checkpoints device-resident stage outputs (their
        host block is None: persistence goes through get(), one counted
        fetch of the value lane)."""
        monkeypatch.setattr(settings, "hbm_budget", 64 << 20)
        monkeypatch.setattr(settings, "pipeline", "off")
        monkeypatch.setattr(storage, "HBM_MIN_RECORDS", 1)

        def keyf(x):
            return x % 7

        pipe = (dampr_tpu_torch.Dampr.memory(list(range(20000)),
                                             partitions=8).count(keyf))
        runner = MTRunner("hbm-resume", pipe.pmer.graph, resume=True)
        out = runner.run([pipe.source])
        got = dict(v for _k, v in out[0].read())
        assert got == {i: len(range(i, 20000, 7)) for i in range(7)}
        assert runner.store.h2d_bytes > 0
        # every device ref the run kept was released once its checkpoint
        # landed
        assert runner.store._dev_bytes == 0
        runner2 = MTRunner("hbm-resume", pipe.pmer.graph, resume=True)
        out2 = runner2.run([pipe.source])
        assert dict(v for _k, v in out2[0].read()) == got
        assert [s.kind for s in runner2.stats if
                s.kind.startswith("resumed-")]

    def test_handoff_refs_persist_and_restore(self, tmp_path, monkeypatch):
        """DocFreq's counts held on the device by the handoff: the map
        stage's checkpoint fetches them once, the rerun restores the map
        stage and launches nothing."""
        from dampr_tpu_torch.ops import text as port_text

        monkeypatch.setattr(settings, "lower", "on")
        monkeypatch.setattr(settings, "handoff", "on")
        monkeypatch.setattr(settings, "pipeline", "off")
        rng = np.random.RandomState(3)
        words = ["w%d" % i for i in range(120)]
        path = str(tmp_path / "c.txt")
        with open(path, "w") as f:
            for _ in range(2000):
                f.write(" ".join(rng.choice(words, size=rng.randint(1, 9)))
                        + "\n")

        def build(pkg, text):
            docs = pkg.Dampr.text(path, os.path.getsize(path) // 3 + 1)
            return docs.custom_mapper(text.DocFreq(
                mode="word", lower=True, pair_values=False)).fold_values(
                    operator.add)

        em = build(dampr_tpu_torch, port_text).run(name="handoff-resume",
                                                   resume=True)
        first = sorted(em.read())
        s1 = em.stats()
        assert s1["device"]["handoff_bytes"] > 0
        assert s1["device"]["d2h_bytes"] > 0
        em2 = build(dampr_tpu_torch, port_text).run(name="handoff-resume",
                                                    resume=True)
        assert sorted(em2.read()) == first
        assert _restored(em2)
        assert sum(sum(st["launches"].values()) for st in em2.stats) == 0
        old = ref_settings.lower
        ref_settings.lower = "1"
        try:
            from dampr_tpu.ops import text as ref_text

            want = sorted(build(dampr_tpu, ref_text).run().read())
        finally:
            ref_settings.lower = old
        assert first == want


class TestCheckpointSpans:
    def test_checkpoint_spans_on_resume(self, monkeypatch, tmp_path):
        """Durable runs record checkpoint persist spans; reruns record
        restores."""
        monkeypatch.setattr(settings, "trace", True)
        monkeypatch.setattr(settings, "trace_dir", str(tmp_path / "tr"))

        def load(em):
            with open(em.stats()["trace_file"]) as f:
                return json.load(f)

        src = dampr_tpu_torch.Dampr.memory(list(range(500))).map(
            lambda x: x + 1)
        em = src.run(name="obs-ckpt", resume=True)
        doc = load(em)
        assert "checkpoint" in {ev.get("cat") for ev in doc["traceEvents"]}
        em2 = src.run(name="obs-ckpt", resume=True)
        restores = [ev for ev in load(em2)["traceEvents"]
                    if ev.get("cat") == "checkpoint"
                    and ev.get("name") == "restore"]
        assert restores, "rerun should restore from checkpoint"
        em2.delete()
