"""dampr_tpu_torch stands alone: no JAX, nothing of dampr_tpu, and no
silent CPU run when the card it was told to use is missing."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|dampr_tpu)(?:[\s.,]|$)",
    re.MULTILINE)


def _port_sources():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                           "time_first_port.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "dampr_tpu_torch")):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_port_imports_without_jax_or_the_jax_package(tmp_path):
    """Every port module imports with ``jax`` made unimportable, and no
    ``dampr_tpu`` module is loaded along the way, not even when the
    two-input stages run (the TF-IDF pipeline's cross and ``len()``, the
    joins) and the out-of-core paths (spill frames through the writer
    pool, a streaming fold and join, sorted runs), the static analyzer
    (a certified chain's lane program, ``validate()``) and the adaptive
    plan (a named run sized from its history, ``explain()``) and faults
    and resume (a retried job, a restored rerun, ``validate(resume=True)``),
    on the CPU."""
    code = r"""
import importlib, json, math, operator, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import dampr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dampr_tpu_torch.__path__,
                                                "dampr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.ops.text import DocFreq
settings.device = "cpu"
settings.lower = "on"
docs = Dampr.text(sys.argv[1], 4)
df = docs.custom_mapper(DocFreq(pair_values=False)).fold_values(operator.add)
idf = df.cross_right(docs.len(), lambda d, t: (d[0], d[1], t), memory=True)
left = Dampr.memory([("a", 1), ("b", 2)]).group_by(lambda x: x[0])
right = Dampr.memory([("b", 3), ("c", 4)]).group_by(lambda x: x[0])
joins = [left.join(right).reduce(lambda l, r: (list(l), list(r))),
         left.join(right).left_reduce(lambda l, r: (list(l), list(r))),
         left.join(right).outer_reduce(lambda l, r: (list(l), list(r))),
         Dampr.memory([1, 2, 3]).cross_set(Dampr.memory([2]),
                                            lambda x, y: x in y)]
from dampr_tpu_torch.utils import filter_by_count
words = docs.flat_map(lambda line: line.split())
records = {"count": words.count().read(),
           "mean": words.mean(len, len).read(),
           "sorted": [c for _w, c in
                      words.count().sort_by(lambda wc: -wc[1]).read()],
           "kept": filter_by_count(words, lambda w: w, lambda c: c > 1).read()}
chain = (Dampr.memory(list(range(5000)), partitions=1)
         .map(lambda x: x * 3 + 1).filter(lambda x: x % 2 == 0))
records["chain"] = sum(chain.read())
records["validate"] = [d.code for d in chain.validate()]
settings.scratch_root = sys.argv[2]
adapt = [words.count().run(name="iso").stats()["plan"]["adaptive"]["applied"]
         for _ in range(2)]
records["adapt"] = adapt + [bool(words.count().explain(name="iso"))]
from dampr_tpu_torch import faults
settings.job_retries = 1
faults.install(faults.FaultPlan("fold:nth=1"))
r1 = words.count().run(name="iso-resume", resume=True)
faults.clear()
r2 = words.count().run(name="iso-resume", resume=True)
records["resume"] = [r1.read(), r1.stats()["faults"]["job_retries"],
                     [s["kind"] for s in r2.stats], r2.read(),
                     [d.code for d in chain.validate(resume=True)]]
settings.job_retries = 0
settings.streaming_reduce_threshold = 1
ooc = {"fold": words.count().run(memory_budget=1).read(),
       "join": left.join(right).reduce(lambda l, r: (list(l), list(r)))
       .run(memory_budget=1).read(),
       "sort": Dampr.memory([3, 1, 2] * 50).sort_by(lambda x: x)
       .run(memory_budget=1).read()[::50]}
loaded = sorted(m for m in sys.modules
                if m == "dampr_tpu" or m.startswith("dampr_tpu."))
print(json.dumps({"modules": names, "reference": loaded,
                  "idf": idf.read(), "len": docs.len().read(),
                  "joins": [j.read() for j in joins], "records": records,
                  "ooc": ooc}))
"""
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"a b\nb\n\nc a")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code, str(corpus),
                          str(tmp_path / "scratch")], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["reference"] == []
    for name in ("ops.lower", "ops.text", "ops.devtime", "csrc.build",
                 "base", "dampr", "dataset", "inputs", "runner", "plan.lower",
                 "plan.passes", "plan.ir", "utils", "utils.common",
                 "utils.indexer", "io", "io.codecs", "io.frames",
                 "io.writer", "storage", "obs", "obs.critpath",
                 "obs.export", "obs.flightrec", "obs.log", "obs.metrics",
                 "obs.profile", "obs.progress", "obs.sampler", "obs.trace",
                 "analyze", "analyze.assoc", "analyze.lint",
                 "analyze.pickleprobe", "analyze.props", "analyze.torchtrace",
                 "analyze.validate", "obs.history", "plan.cost",
                 "plan.model", "plan.pipeline", "plan.explain", "faults",
                 "resume"):
        assert "dampr_tpu_torch." + name in report["modules"]
    assert report["idf"] == [["a", 2, 4], ["b", 2, 4], ["c", 1, 4]]
    assert report["len"] == [4]
    pair = [["b", [[["b", 2]], [["b", 3]]]]]
    assert report["joins"] == [
        pair, [["a", [[["a", 1]], []]]] + pair,
        [["a", [[["a", 1]], []]]] + pair + [["c", [[], [["c", 4]]]]],
        [True]]
    assert report["records"] == {
        "count": [["a", 2], ["b", 2], ["c", 1]],
        "mean": [[1, 1.0]],
        "sorted": [2, 2, 1],
        "kept": ["a", "a", "b", "b"],
        "chain": sum(v for v in (x * 3 + 1 for x in range(5000))
                     if v % 2 == 0),
        "validate": ["DTA501", "DTA501"],
        "resume": [[["a", 2], ["b", 2], ["c", 1]], 1, ["resumed-reduce"],
                   [["a", 2], ["b", 2], ["c", 1]], ["DTA501", "DTA501"]],
        "adapt": [False, True, True]}
    assert report["ooc"] == {"fold": [["a", 2], ["b", 2], ["c", 1]],
                             "join": pair, "sort": [1, 2, 3]}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_dampr_tpu(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert not _FORBIDDEN.findall(src), path


def test_cuda_device_without_a_card_raises():
    """device='cuda' on a machine without a card fails the run up front —
    it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card case cannot occur")
    import operator

    from dampr_tpu_torch import Dampr, settings
    from dampr_tpu_torch.ops.text import DocFreq

    path = os.path.join(ROOT, "chip_smoke.py")  # any text file will do

    old = settings.device
    settings.device = "cuda"
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            settings.resolve_device()
        with pytest.raises(RuntimeError, match="is_available"):
            (Dampr.text(path)
             .custom_mapper(DocFreq(pair_values=False))
             .fold_values(operator.add).read())
    finally:
        settings.device = old


def test_cuda_join_without_a_card_raises():
    """A join (a host-only stage shape) asked to run on a missing card
    fails up front too: the device is resolved before any stage runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card case cannot occur")
    from dampr_tpu_torch import Dampr, settings

    old = settings.device
    settings.device = "cuda"
    try:
        left = Dampr.memory([("a", 1), ("b", 2)]).group_by(lambda x: x[0])
        right = Dampr.memory([("b", 3)]).group_by(lambda x: x[0])
        with pytest.raises(RuntimeError, match="is_available"):
            left.join(right).reduce(lambda l, r: (list(l), list(r))).read()
        with pytest.raises(RuntimeError, match="is_available"):
            Dampr.run(left.join(right), Dampr.memory([1]).len())
    finally:
        settings.device = old


def test_cuda_record_ops_without_a_card_raise():
    """The batched record path and its keyed combine asked to run on a
    missing card fail up front too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card case cannot occur")
    from dampr_tpu_torch import Dampr, settings

    old = settings.device
    settings.device = "cuda"
    try:
        words = Dampr.memory(["a b", "b c"]).flat_map(lambda s: s.split())
        with pytest.raises(RuntimeError, match="is_available"):
            words.count().read()
        with pytest.raises(RuntimeError, match="is_available"):
            Dampr.run(words.count(), words.filter(bool).sort_by(len))
    finally:
        settings.device = old


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """A wrapper runs its plain version only for a CPU tensor; any other
    non-CUDA device raises rather than falling back."""
    from dampr_tpu_torch.ops import fnv, segfold

    mat = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    lens = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fnv.fnv(mat, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        fnv.fnv_sort_keys(mat, lens, lens)
    lane = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segfold.segfold(lane, lane, lane, lane)
    key = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segfold.segfold_gather(key, key, key, mat, lens, True)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result when there is no
    card, and when run from a directory holding nothing but itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
