"""The port's static analyzer (``dampr_tpu_torch.analyze``) against the JAX
package's (``dampr_tpu.analyze``), on the CPU.

One parametrised corpus of UDFs goes through both packages' classifiers
(purity, determinism and their evidence must be equal) and, for the
side-effect-free ones, both traceability probes (equal certification,
apart from the stated array-API exception); a corpus of fold binops
through both associativity probes (equal tier and evidence); a corpus of
captures through both pickle probes (equal variable names and errors).
The same pipelines built with both packages must give equal
``validate()`` diagnostics as ``(code, severity, sid, evidence)`` and
equal plan-report ``analysis`` sections; each case also keeps the JAX
suite's own assertion on the port's side (``tests/test_analyze.py``'s
``TestClassifier``, ``TestAssoc``, ``TestPickleProbe``, ``TestJaxTrace``,
``TestValidator`` and ``TestLint``).  The lint cases lint the port's own
pipelines and check the ``--json`` report against
``docs/lint_schema.json``.  Tolerance: exact everywhere.
"""

import datetime
import functools
import importlib.util
import json
import math
import operator
import os
import random
import textwrap
import threading
import time
import uuid

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import base as ref_base
from dampr_tpu import settings as ref_settings
from dampr_tpu.analyze import assoc as ref_assoc
from dampr_tpu.analyze import jaxtrace as ref_trace
from dampr_tpu.analyze import pickleprobe as ref_pickle
from dampr_tpu.analyze import props as ref_props
from dampr_tpu.plan import passes as ref_passes
from dampr_tpu_torch import base as port_base
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.analyze import PreflightError
from dampr_tpu_torch.analyze import assoc, lint, pickleprobe, props
from dampr_tpu_torch.analyze import torchtrace
from dampr_tpu_torch.analyze import validate as av
from dampr_tpu_torch.plan import passes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def knobs():
    old = (ref_settings.analyze, port_settings.analyze, port_settings.device,
           ref_settings.lower, port_settings.lower)
    ref_settings.analyze = port_settings.analyze = True
    port_settings.device = "cpu"
    yield
    (ref_settings.analyze, port_settings.analyze, port_settings.device,
     ref_settings.lower, port_settings.lower) = old


def _lint_json(argv, capsys):
    lint.main(argv)
    return capsys.readouterr().out


def _codes(diags):
    return [d.code for d in diags]


def _rows(diags):
    return [(d.code, d.severity, d.sid, d.evidence) for d in diags]


# ---------------------------------------------------------------------------
# The UDF corpus: classification and certification
# ---------------------------------------------------------------------------

_COUNTER = {"n": 0}
_ACC = []
_CACHE = {}
_CFG = {"scale": 3}


def _impure_global(x):
    global _G_SINK
    _G_SINK = x
    return x


def _counter_update(x):
    _COUNTER["n"] += 1
    return x


def _os_remove(p):
    os.remove(p)
    return p


def _local_mutation(vals):
    seen = set()
    out = []
    for v in vals:
        if v not in seen:
            seen.add(v)
            out.append(v * 2)
    out.sort()
    return out


def _local_container_global_value(v):
    d = {}
    d["k"] = _COUNTER
    return len(d) + v


def _datetime_now(x):
    return (x, datetime.datetime.now())


def _np_random(x):
    return x + np.random.rand() * 0


class _Box(object):
    pass


class _Stepper(object):
    def step(self, x):
        self.total = getattr(self, "total", 0) + x
        return self.total


def _closures():
    """UDFs whose hazard sits in a closure cell."""
    box = _Box()
    cache = {}
    rng = random.Random()
    cfg = {"scale": 3}

    def box_attr(x):
        box.last = x
        return x

    def cache_write(x):
        cache[x] = x * 2
        return cache[x]

    def rng_use(x):
        return x + rng.random() * 0

    def local_into_container(v):
        out = {}
        out[v] = cfg
        return len(out)

    return {"box_attr": box_attr, "cache_write": cache_write,
            "rng_use": rng_use, "local_into_container": local_into_container,
            "acc_append": lambda x: (_ACC.append(x), x)[1]}


_CL = _closures()

#: (id, udf, lane kind, certifies) — certifies is None for a UDF the
#: probe must not run (it has side effects), else the verdict both
#: packages must give; "array-api" marks the stated exception: the JAX
#: package certifies it (a JAX array has ``.astype`` and ``__round__``),
#: the port does not (a torch tensor has neither) and keeps it on host.
CORPUS = [
    ("affine", lambda x: x * 3 + 1, "map", True),
    ("even", lambda x: x % 2 == 0, "filter", True),
    ("sqrt_pow", lambda x: x ** 0.5, "map", True),
    ("abs", abs, "map", True),
    ("floordiv", lambda x: x // 3, "map", True),
    ("recip", lambda x: 1.0 / x, "map", True),
    ("mask_mul", lambda x: (x > 0) * x, "map", True),
    ("bitand", lambda x: x & 1, "filter", True),
    ("const_value", lambda v: 1, "value", True),
    ("sum_value", lambda v: v.sum(), "value", True),
    ("branch", lambda x: x * 2 if x > 0 else -x, "map", False),
    ("max0", lambda x: max(x, 0), "map", False),
    ("float", lambda x: float(x), "map", False),
    ("math_sqrt", lambda x: math.sqrt(x), "map", False),
    ("str", lambda x: str(x), "map", False),
    ("tuple", lambda x: (x, x), "map", False),
    ("const_map", lambda v: 1, "map", False),
    ("float_filter", lambda x: x * 0.5, "filter", False),
    ("np_sqrt", lambda x: np.sqrt(x), "map", False),
    ("local_mutation", _local_mutation, "map", False),
    ("astype", lambda x: x.astype("float32") + 1, "map", "array-api"),
    ("round", lambda x: round(x), "map", "array-api"),
    ("store_global", _impure_global, "map", None),
    ("counter_update", _counter_update, "map", None),
    ("print", lambda x: print(x) or x, "map", None),
    ("open", lambda p: open(p).read(), "map", None),
    ("os_remove", _os_remove, "map", None),
    ("acc_append", _CL["acc_append"], "map", None),
    ("box_attr", _CL["box_attr"], "map", None),
    ("cache_write", _CL["cache_write"], "map", None),
    ("local_global_value", _local_container_global_value, "map", True),
    ("local_into_container", _CL["local_into_container"], "map", None),
    ("self_attr", _Stepper.step, "map", None),
    ("random", lambda x: x + random.random(), "map", None),
    ("time", lambda x: x + time.time() * 0, "map", None),
    ("uuid", lambda x: (x, uuid.uuid4().hex)[0], "map", None),
    ("datetime_now", _datetime_now, "map", None),
    ("np_random", _np_random, "map", None),
    ("rng_closure", _CL["rng_use"], "map", None),
    ("bound_rng", random.Random(7).random, "map", None),
    ("partial_impure", functools.partial(
        lambda scale, x: (_ACC.append(x), x * scale)[1], 3), "map", None),
    ("builtin_len", len, "map", False),
    ("str_lower", str.lower, "map", None),
    ("operator_add", operator.add, "map", None),
]

_IDS = [c[0] for c in CORPUS]


class TestClassifier:
    @pytest.mark.parametrize("case", CORPUS, ids=_IDS)
    def test_verdict_equals_reference(self, case):
        _name, f, _kind, _cert = case
        got = props.classify_callable(f).to_dict()
        want = ref_props.classify_callable(f).to_dict()
        assert got == want

    def test_local_mutation_is_pure(self):
        v = props.classify_callable(_local_mutation)
        assert v.pure and v.deterministic, v

    def test_store_global_is_impure(self):
        v = props.classify_callable(_impure_global)
        assert not v.pure and v.deterministic
        assert any("global" in e for e in v.impure_evidence)

    def test_closure_mutator_method_named(self):
        acc = []
        v = props.classify_callable(lambda x: (acc.append(x), x)[1])
        assert not v.pure
        assert any("'acc'" in e and "append" in e
                   for e in v.impure_evidence), v.impure_evidence

    def test_io_and_os_are_impure(self):
        for name, frag in (("print", "print"), ("open", "open"),
                           ("os_remove", "os.remove")):
            f = CORPUS[_IDS.index(name)][1]
            v = props.classify_callable(f)
            assert not v.pure and any(frag in e for e in v.impure_evidence)

    def test_closure_writes_name_the_variable(self):
        for name, var in (("box_attr", "'box'"), ("cache_write", "'cache'")):
            v = props.classify_callable(_CL[name])
            assert not v.pure and any(var in e for e in v.impure_evidence)

    def test_nonlocal_value_into_local_container_is_pure(self):
        for f in (_local_container_global_value,
                  _CL["local_into_container"]):
            v = props.classify_callable(f)
            assert v.pure, v.impure_evidence

    def test_self_attr_write_is_exempt(self):
        assert props.classify_callable(_Stepper.step).pure

    @pytest.mark.parametrize("name,frag", [
        ("random", "random"), ("time", "time.time"), ("uuid", "uuid"),
        ("np_random", "numpy.random"), ("rng_closure", "'rng'")])
    def test_nondet_sources(self, name, frag):
        f = CORPUS[_IDS.index(name)][1]
        v = props.classify_callable(f)
        assert not v.deterministic
        assert any(frag in e for e in v.nondet_evidence), v.nondet_evidence

    def test_datetime_and_bound_rng_nondet(self):
        assert not props.classify_callable(_datetime_now).deterministic
        assert not props.classify_callable(
            random.Random(7).random).deterministic

    def test_builtins_are_benign(self):
        for f in (len, str.lower, operator.add, abs):
            v = props.classify_callable(f)
            assert v.pure and v.deterministic, (f, v)

    def test_verdict_cache_returns_fresh_clones(self):
        f = lambda x: x + 1  # noqa: E731
        a = props.classify_callable(f)
        a.name = "renamed"
        a.impure("poisoned")
        b = props.classify_callable(f)
        assert b.pure and b.name != "renamed"


class TestTorchTrace:
    """The port's counterpart of ``TestJaxTrace``."""

    @pytest.mark.parametrize(
        "case", [c for c in CORPUS if c[3] is not None],
        ids=[c[0] for c in CORPUS if c[3] is not None])
    def test_certification_equals_reference(self, case):
        _name, f, kind, cert = case
        ok, why = torchtrace.certify_callable(f, kind)
        ref_ok, _ = ref_trace.certify_callable(f, kind)
        if cert == "array-api":
            assert ref_ok and not ok and why
        else:
            assert ok == ref_ok == cert, why
            assert bool(why) == (not ok)

    def test_chain_claims_requires_lane_vocabulary(self):
        pipe = dampr_tpu_torch.Dampr.memory(list(range(10))).flat_map(
            lambda x: [x, x])
        spec, why = torchtrace.chain_claims(pipe.pmer.graph.stages[-1].mapper)
        assert spec is None and "vocabulary" in why

    def test_chain_claims_rejects_nondet_udf(self):
        pipe = dampr_tpu_torch.Dampr.memory(list(range(10))).map(
            lambda x: x + random.random() * 0)
        spec, why = torchtrace.chain_claims(pipe.pmer.graph.stages[-1].mapper)
        assert spec is None and "nondeterministic" in why

    @pytest.mark.parametrize("build", ["map_filter", "fold_by", "count",
                                       "rekey_then_map", "impure"])
    def test_chain_claims_equal_reference(self, build):
        """The same chain built in both packages: equal verdict, equal
        reason where it certifies (the DTA501 evidence)."""
        acc = []

        def pipe(pkg):
            m = pkg.Dampr.memory(list(range(10)))
            if build == "map_filter":
                return m.map(lambda x: x * 2).filter(lambda x: x > 5)
            if build == "fold_by":
                return m.map(lambda x: x + 1).fold_by(lambda x: x % 3,
                                                      operator.add)
            if build == "count":
                return m.count(lambda x: x % 5)
            if build == "rekey_then_map":
                return m.sort_by(lambda x: -x).map(lambda x: x + 1)
            return m.map(lambda x: (acc.append(x), x)[1])

        def claims(pkg, mod, opt):
            p = pipe(pkg)
            g, _ = opt.optimize(p.pmer.graph, [p.source])
            out = []
            for s in g.stages:
                if hasattr(s, "mapper") and len(s.inputs) == 1:
                    spec, why = mod.chain_claims(s.mapper)
                    out.append((spec is not None,
                                why if spec is not None else None))
            return out

        got = claims(dampr_tpu_torch, torchtrace, passes)
        assert got == claims(dampr_tpu, ref_trace, ref_passes)
        # a re-key fused before a map leaves the value lane: no claim
        assert any(ok for ok, _ in got) == (
            build not in ("impure", "rekey_then_map"))

    def _program(self, pkg, mod, opt, values, *fns):
        pipe = pkg.Dampr.memory(values)
        for kind, f in fns:
            pipe = getattr(pipe, kind)(f)
        g, _ = opt.optimize(pipe.pmer.graph, [pipe.source])
        return mod.stage_program([s for s in g.stages
                                  if hasattr(s, "mapper")][-1])

    def test_chain_program_exactness_with_filter_mask(self):
        fns = (("map", lambda x: x * 3 + 1), ("filter", lambda x: x % 2 == 0))
        prog = self._program(dampr_tpu_torch, torchtrace, passes,
                             list(range(64)), *fns)
        ref = self._program(dampr_tpu, ref_trace, ref_passes,
                            list(range(64)), *fns)
        ks = list(range(64))
        out = prog.run_batch(ks, list(ks))
        exp = [(k, v * 3 + 1) for k, v in zip(ks, ks) if (v * 3 + 1) % 2 == 0]
        assert list(zip(out[0], out[1])) == exp
        assert out == ref.run_batch(ks, list(ks))

    def test_chain_program_nonnumeric_batch_falls_back(self):
        prog = self._program(dampr_tpu_torch, torchtrace, passes,
                             list(range(8)), ("map", lambda x: x * 2))
        assert prog.run_batch([0, 1], ["a", "b"]) is None
        assert prog.counters["fallback"] >= 1

    def test_zero_divide_batch_falls_back_not_inf(self):
        fns = (("map", lambda v: 1.0 / v),)
        prog = self._program(dampr_tpu_torch, torchtrace, passes,
                             [1.0, 2.0], *fns)
        ks = [0, 1, 2]
        assert prog.run_batch(ks, [4.0, 2.0, 0.0]) is None
        assert prog.counters["fallback"] >= 1
        out = prog.run_batch(ks, [4.0, 2.0, 1.0])
        assert out == (ks, [0.25, 0.5, 1.0])
        ref = self._program(dampr_tpu, ref_trace, ref_passes, [1.0, 2.0],
                            *fns)
        assert out == ref.run_batch(ks, [4.0, 2.0, 1.0])

    @pytest.mark.parametrize("dtype", ["int64", "float64"])
    def test_device_program_verified_on_the_cpu_device(self, dtype):
        """A lane of the dispatch floor goes to the device program (here
        the CPU device) and is verified against the host evaluation;
        ints beyond int32 dispatch too (the card has int64)."""
        rng = np.random.RandomState(5)
        n = 4096
        if dtype == "int64":
            vals = rng.randint(-2 ** 40, 2 ** 40, size=n).tolist()
            fns = (("map", lambda x: x * 3 + 1),
                   ("filter", lambda x: x % 2 == 0))
        else:
            vals = rng.standard_normal(n).tolist()
            fns = (("map", lambda v: v * 0.5 + 3.0),
                   ("filter", lambda v: v > 3.0))
        prog = self._program(dampr_tpu_torch, torchtrace, passes, vals, *fns)
        ks = list(range(n))
        out = prog.run_batch(ks, vals)
        exp = [(k, v) for k, v in zip(ks, (fns[0][1](x) for x in vals))
               if fns[1][1](v)]
        assert list(zip(out[0], out[1])) == exp
        assert prog.counters["device_dispatched"] == 1
        assert prog.counters["device_verified"] == 1
        assert prog.counters["device_mismatch"] == 0

    def test_device_mismatch_keeps_the_host_result(self):
        """An int lane times a Python float computes float32 in torch
        (float64 in numpy): the check counts a mismatch and the 64-bit
        host result stands."""
        n = 4096
        prog = self._program(dampr_tpu_torch, torchtrace, passes,
                             list(range(n)), ("map", lambda x: x * 0.1))
        vals = list(range(n))
        out = prog.run_batch(vals, vals)
        assert out[1] == [x * 0.1 for x in vals]
        assert prog.counters["device_mismatch"] == 1
        assert prog.counters["device_verified"] == 0


# ---------------------------------------------------------------------------
# Associativity
# ---------------------------------------------------------------------------

_CALLS = []

BINOPS = [
    ("add", operator.add), ("min", min), ("max", max),
    ("sub", lambda a, b: a - b), ("rev_add", lambda a, b: b + a),
    ("mul", lambda a, b: a * b), ("avg", lambda a, b: (a + b) / 2),
    ("pow", lambda a, b: a ** 2 + b), ("first", lambda a, b: a),
    ("merge", lambda a, b: a.merge(b)),
    ("impure", lambda a, b: (_CALLS.append((a, b)), a + b)[1]),
    ("py_max", lambda a, b: a if a >= b else b),
]


class TestAssoc:
    @pytest.mark.parametrize("case", BINOPS, ids=[b[0] for b in BINOPS])
    def test_tier_and_evidence_equal_reference(self, case):
        _name, fn = case
        assert assoc.classify_binop(fn) == ref_assoc.classify_binop(fn)

    def test_tiers(self):
        tiers = {name: assoc.classify_binop(fn)["assoc"]
                 for name, fn in BINOPS}
        assert tiers["add"] == "yes" and tiers["min"] == "yes"
        assert tiers["sub"] == "no" and tiers["rev_add"] == "probably"
        assert tiers["merge"] == "unknown"
        assert "counterexample" in assoc.classify_binop(
            BINOPS[3][1])["evidence"]

    def test_probe_is_deterministic(self):
        f = lambda a, b: a - b  # noqa: E731
        assert assoc.classify_binop(f) == assoc.classify_binop(f)

    def test_impure_binop_is_never_executed(self):
        calls = []
        out = assoc.classify_binop(
            lambda a, b: (calls.append((a, b)), a + b)[1])
        assert out["assoc"] == "unknown" and "impure" in out["evidence"]
        assert calls == []


# ---------------------------------------------------------------------------
# Pickle probe
# ---------------------------------------------------------------------------

class _LockHolder(object):
    def __init__(self):
        self.handle = threading.Lock()

    def __call__(self, x):
        return x

    def meth(self, x):
        return x


def _captures():
    lock = threading.Lock()
    k = 3
    return [
        ("clean", lambda x: x * k),
        ("lock_closure", lambda x: x if lock else x),
        ("partial_kwarg", functools.partial(lambda x, res=None: x,
                                            res=threading.Lock())),
        ("partial_arg", functools.partial(lambda res, x: x,
                                          threading.Lock())),
        ("callable_object", _LockHolder()),
        ("bound_receiver", _LockHolder().meth),
        ("default_arg", lambda x, res=threading.Lock(): x),
    ]


_CAPTURES = _captures()


class TestPickleProbe:
    @pytest.mark.parametrize("case", _CAPTURES, ids=[c[0] for c in _CAPTURES])
    def test_problems_equal_reference(self, case):
        _name, f = case
        assert pickleprobe.probe_callable(f) == ref_pickle.probe_callable(f)

    def test_clean_closure_probes_empty(self):
        assert pickleprobe.probe_callable(_CAPTURES[0][1]) == []

    def test_lock_closure_names_the_variable(self):
        probs = pickleprobe.probe_callable(_CAPTURES[1][1])
        assert len(probs) == 1 and "lock" in probs[0]["variable"]
        assert "pickle" in probs[0]["error"].lower() \
            or "TypeError" in probs[0]["error"]

    def test_partial_and_object_state_probed(self):
        assert any("res" in p["variable"]
                   for p in pickleprobe.probe_callable(_CAPTURES[2][1]))
        assert any("handle" in p["variable"]
                   for p in pickleprobe.probe_callable(_CAPTURES[4][1]))


# ---------------------------------------------------------------------------
# The validator over the same pipelines built in both packages
# ---------------------------------------------------------------------------

def _pipelines(pkg, base):
    """{name: (handle, validate kwargs)} built with one package."""
    acc = []
    lock = threading.Lock()

    def overridden(x):
        acc.append(x)
        return x + random.random() * 0

    m = pkg.Dampr.memory(list(range(50)))
    return {
        "non_assoc_fold": (m.fold_by(lambda x: x % 3, lambda a, b: a - b),
                           {}),
        "assume_associative": (m.fold_by(lambda x: x % 3,
                                         lambda a, b: a - b,
                                         assume_associative=True), {}),
        "probably_assoc": (m.fold_by(lambda x: x % 3,
                                     lambda a, b: b + a), {}),
        "impure": (m.map(lambda x: (acc.append(x), x)[1]), {}),
        "nondet": (m.map(lambda x: x + random.random() * 0), {}),
        "lock": (m.map(lambda x: x if lock else x), {}),
        "lock_2proc": (m.map(lambda x: x if lock else x),
                       {"num_processes": 2}),
        "lock_noprobe": (m.map(lambda x: x if lock else x),
                         {"probe": False}),
        "traceable": (m.map(lambda x: x * 2).filter(lambda x: x > 5), {}),
        "overrides": (m.custom_mapper(base.ValueMap(overridden),
                                      assume_pure=True,
                                      assume_deterministic=True), {}),
        "word_count": (pkg.Dampr.memory(["a b", "b c"])
                       .flat_map(lambda s: s.split()).count(), {}),
        "count_mean": (m.map(lambda x: x + 1).mean(lambda x: x % 2), {}),
    }


_PIPES = sorted(_pipelines(dampr_tpu_torch, port_base))


class TestValidator:
    @pytest.mark.parametrize("name", _PIPES)
    def test_diagnostics_equal_reference(self, name):
        port, kw = _pipelines(dampr_tpu_torch, port_base)[name]
        ref, _ = _pipelines(dampr_tpu, ref_base)[name]
        assert _rows(port.validate(**kw)) == _rows(ref.validate(**kw))

    def test_non_associative_fold_is_an_error(self):
        pipe = _pipelines(dampr_tpu_torch, port_base)["non_assoc_fold"][0]
        diags = pipe.validate()
        errs = [d for d in diags if d.code == "DTA101"]
        assert len(errs) == 1 and errs[0].severity == "error"
        assert any("counterexample" in e for e in errs[0].evidence)
        assert diags[0].code == "DTA101"

    def test_pipeline_diagnostics(self):
        p = _pipelines(dampr_tpu_torch, port_base)
        assert "DTA101" not in _codes(p["assume_associative"][0].validate())
        d201 = [d for d in p["impure"][0].validate() if d.code == "DTA201"]
        assert len(d201) == 1 and any("'acc'" in e for e in d201[0].evidence)
        d301 = [d for d in p["nondet"][0].validate() if d.code == "DTA301"]
        assert len(d301) == 1 and any("random" in e
                                      for e in d301[0].evidence)
        d401 = [d for d in p["lock"][0].validate() if d.code == "DTA401"]
        assert len(d401) == 1 and d401[0].severity == "warn"
        assert any("'lock'" in e for e in d401[0].evidence)
        d401 = [d for d in p["lock"][0].validate(num_processes=2)
                if d.code == "DTA401"]
        assert d401 and d401[0].severity == "error"
        d501 = [d for d in p["traceable"][0].validate() if d.code == "DTA501"]
        assert d501 and any("certified" in e for d in d501
                            for e in d.evidence)
        codes = _codes(p["overrides"][0].validate())
        assert "DTA201" not in codes and "DTA301" not in codes

    def test_probe_false_skips_serialization(self):
        attempts = []

        class Tattler(object):
            def __reduce__(self):
                attempts.append(1)
                raise TypeError("unpicklable sentinel")

        big = Tattler()
        pipe = dampr_tpu_torch.Dampr.memory(list(range(50))).map(
            lambda x: x if big else x)
        assert "DTA401" not in _codes(pipe.validate(probe=False))
        assert attempts == []
        assert "DTA401" in _codes(pipe.validate())
        assert attempts

    def test_resume_check_is_not_ported(self):
        """The resume check (DTA402) is ported: ``validate(resume=True)``
        gives the JAX package's rows on every pipeline of the corpus."""
        for name in _PIPES:
            port, kw = _pipelines(dampr_tpu_torch, port_base)[name]
            ref, _ = _pipelines(dampr_tpu, ref_base)[name]
            kw = dict(kw, resume=True)
            assert _rows(port.validate(**kw)) == _rows(ref.validate(**kw)), \
                name

    def test_resume_flags_volatile_fingerprint(self):
        pipe = _pipelines(dampr_tpu_torch, port_base)["lock"][0]
        assert "DTA402" in _codes(pipe.validate(resume=True))
        ref = _pipelines(dampr_tpu, ref_base)["lock"][0]
        assert "DTA402" in _codes(ref.validate(resume=True))

    def test_preflight_dispatch_check_names_everything(self):
        pipe = _pipelines(dampr_tpu_torch, port_base)["lock"][0]
        with pytest.raises(PreflightError) as ei:
            av.preflight_dispatch_check(pipe.pmer.graph, 2)
        msg = str(ei.value)
        assert "lock" in msg and "ValueMap" in msg and "DTA401" in msg
        ref = _pipelines(dampr_tpu, ref_base)["lock"][0]
        from dampr_tpu.analyze import validate as ref_av

        with pytest.raises(ref_av.PreflightError) as ref_ei:
            ref_av.preflight_dispatch_check(ref.pmer.graph, 2)
        assert _rows(ei.value.diagnostics) == _rows(
            ref_ei.value.diagnostics)

    def test_preflight_noop_single_process_or_disabled(self):
        pipe = _pipelines(dampr_tpu_torch, port_base)["lock"][0]
        av.preflight_dispatch_check(pipe.pmer.graph, 1)
        port_settings.analyze = False
        av.preflight_dispatch_check(pipe.pmer.graph, 2)


def _comparable(section):
    """The section with the tracing library's own exception text cut from
    each uncertified stage's ``traceable_why`` (torch and JAX word their
    errors differently; the UDF and the verdict stay)."""
    out = json.loads(json.dumps(section))
    for rec in out["stages"]:
        why = rec.get("traceable_why", "")
        if not rec.get("traceable", True) and " not traceable: " in why:
            rec["traceable_why"] = why.split(" not traceable: ")[0]
    return out


class TestReportSection:
    """``em.stats()["plan"]["analysis"]`` of the same run in both
    packages."""

    @pytest.mark.parametrize("name,lower", [
        ("impure", False), ("nondet", False), ("traceable", True),
        ("count_mean", True), ("word_count", False)])
    def test_section_equals_reference(self, tmp_path, name, lower):
        port_settings.lower = "on" if lower else "off"
        ref_settings.lower = "1" if lower else "0"
        port = _pipelines(dampr_tpu_torch, port_base)[name][0]
        ref = _pipelines(dampr_tpu, ref_base)[name][0]
        em = port.run(name="analysis-port")
        got = em.stats()["plan"]["analysis"]
        records = em.read()
        em.delete()
        ref_em = ref.run(name="analysis-ref")
        want = ref_em.stats()["plan"]["analysis"]
        ref_records = ref_em.read()
        ref_em.delete()
        assert _comparable(got) == _comparable(want)
        assert got["enabled"] and got["stages"]
        assert records == ref_records
        assert any("traceable" in r for r in got["stages"]) == lower

    def test_disabled_section(self):
        port_settings.analyze = False
        em = dampr_tpu_torch.Dampr.memory([1, 2]).map(
            lambda x: x + 1).run(name="analysis-off")
        assert em.stats()["plan"]["analysis"] == av.empty_section()
        em.delete()


# ---------------------------------------------------------------------------
# The linter
# ---------------------------------------------------------------------------

def _validate_lint():
    spec = importlib.util.spec_from_file_location(
        "validate_lint", os.path.join(ROOT, "tools", "validate_lint.py"))
    vl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vl)
    with open(os.path.join(ROOT, "docs", "lint_schema.json")) as f:
        return vl, json.load(f)


#: A module building the port's ``wc``, ``word_stats`` and TF-IDF
#: pipelines (``examples/wc.py``, ``examples/word_stats.py``,
#: ``dampr_tpu/bench_tfidf.py:135-147``) over a corpus path.
PORT_PIPELINES = '''
import math
import operator

from dampr_tpu_torch import Dampr
from dampr_tpu_torch.ops.text import DocFreq

CORPUS = {corpus!r}


def wc_pipeline():
    return (Dampr.text(CORPUS)
            .flat_map(lambda line: line.split())
            .fold_by(lambda w: w, binop=lambda x, y: x + y,
                     value=lambda w: 1))


def word_stats_pipelines():
    words = Dampr.text(CORPUS).flat_map(lambda line: line.split())
    top_words = (words.count(lambda x: x)
                 .sort_by(lambda word_count: -word_count[1]))
    total_count = top_words.fold_by(key=lambda word: 1,
                                    value=lambda x: x[1],
                                    binop=lambda x, y: x + y)
    word_lengths = (top_words
                    .fold_by(lambda tc: len(tc[0]), value=lambda tc: tc[1],
                             binop=lambda x, y: x + y)
                    .sort_by(lambda cl: cl[0]))
    avg_word_lengths = (word_lengths
                        .map(lambda wl: wl[0] * wl[1])
                        .a_group_by(lambda x: 1)
                        .sum()
                        .join(total_count)
                        .reduce(lambda awl, tc:
                                next(awl)[1] / float(next(tc)[1])))
    return total_count, top_words, word_lengths, avg_word_lengths


def _idf(df, total):
    return df[0], df[1], math.log(1 + float(total) / df[1])


def tfidf_pipeline(out):
    docs = Dampr.text(CORPUS)
    doc_freq = (docs.custom_mapper(DocFreq(mode="word", lower=True,
                                           pair_values=False))
                .fold_values(operator.add))
    return (doc_freq.cross_right(docs.len(), _idf, memory=True)
            .sink_tsv(out))


def lint_pipelines():
    ws = word_stats_pipelines()
    return ([("wc", wc_pipeline())]
            + [("word_stats_%d" % i, p) for i, p in enumerate(ws)]
            + [("tfidf", tfidf_pipeline(CORPUS + ".idf"))])
'''


class TestLint:
    def _write_module(self, tmp_path, body, name="lintee.py"):
        p = tmp_path / name
        p.write_text(textwrap.dedent(body))
        return str(p)

    def test_port_pipelines_lint_clean_and_schema_valid(self, tmp_path):
        corpus = tmp_path / "c.txt"
        corpus.write_text("a b\nb c\n")
        mod = self._write_module(
            tmp_path, PORT_PIPELINES.format(corpus=str(corpus)),
            "port_pipelines.py")
        report = lint.run_lint([mod])
        assert report["exit_code"] == 0, json.dumps(report["diagnostics"])
        assert report["counts"]["error"] == 0
        assert report["counts"]["warn"] == 0, report["diagnostics"]
        assert report["targets"][0]["pipelines"][0] == "wc"
        vl, schema = _validate_lint()
        assert vl.validate(report, schema) == []
        bad = lint.run_lint([os.path.join(ROOT, "does-not-exist.py")])
        assert bad["exit_code"] == 2
        assert vl.validate(bad, schema) == []

    def test_cli_exit_codes(self, tmp_path, capsys):
        bad = self._write_module(tmp_path, """
            from dampr_tpu_torch import Dampr

            def lint_pipelines():
                return [("bad", Dampr.memory(list(range(10))).fold_by(
                    lambda x: x % 2, lambda a, b: a - b))]
        """)
        assert lint.main([bad]) == 1
        out = capsys.readouterr().out
        assert "DTA101" in out and "counterexample" in out
        empty = self._write_module(tmp_path, "x = 1\n")
        assert lint.main([empty]) == 2
        clean = self._write_module(tmp_path, """
            from dampr_tpu_torch import Dampr

            def lint_pipelines():
                return [("ok", Dampr.memory(list(range(10)))
                         .map(lambda x: x + 1))]
        """)
        assert lint.main([clean]) == 0
        capsys.readouterr()

    def test_strict_turns_warnings_into_failures(self, tmp_path, capsys):
        warny = self._write_module(tmp_path, """
            import random
            from dampr_tpu_torch import Dampr

            def lint_pipelines():
                return [("nd", Dampr.memory(list(range(10))).map(
                    lambda x: x + random.random() * 0))]
        """)
        assert lint.main([warny]) == 0
        assert lint.main(["--strict", warny]) == 1
        capsys.readouterr()

    def test_json_mode_emits_schema_report(self, tmp_path, capsys):
        clean = self._write_module(tmp_path, """
            from dampr_tpu_torch import Dampr

            def lint_pipelines():
                return [("ok", Dampr.memory(list(range(10)))
                         .map(lambda x: x + 1))]
        """)
        assert lint.main(["--json", clean]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["schema"] == lint.SCHEMA == "dampr-tpu-lint/1"
        vl, schema = _validate_lint()
        assert vl.validate(report, schema) == []

    def test_resume_flag_reports_dta402_as_the_reference(self, tmp_path,
                                                         capsys):
        """``--resume`` adds DTA402 on a fingerprint-unstable capture, as
        the JAX linter's does; without it the stage is not flagged."""
        body = """
            import threading
            from dampr_tpu_torch import Dampr

            LOCK = threading.Lock()

            def lint_pipelines():
                lock = threading.Lock()
                return [("locked", Dampr.memory(list(range(10))).map(
                    lambda x: (x, lock is not None)))]
        """
        mod = self._write_module(tmp_path, body)
        ref_mod = self._write_module(
            tmp_path, textwrap.dedent(body).replace("dampr_tpu_torch",
                                                    "dampr_tpu"),
            "ref_resume.py")
        from dampr_tpu.analyze import lint as ref_lint

        _rec, plain = lint.lint_target(mod)
        assert "DTA402" not in [d["code"] for d in plain]
        _rec, diags = lint.lint_target(mod, resume=True)
        _ref_rec, ref_diags = ref_lint.lint_target(ref_mod, resume=True)
        assert "DTA402" in [d["code"] for d in diags]
        assert diags == ref_diags
        report = json.loads(_lint_json(["--json", "--resume", mod], capsys))
        assert "DTA402" in [d["code"] for d in report["diagnostics"]]
        vl, schema = _validate_lint()
        assert vl.validate(report, schema) == []

    def test_registry_discovery_without_hook(self, tmp_path, capsys):
        mod = self._write_module(tmp_path, """
            from dampr_tpu_torch import Dampr

            PIPE = (Dampr.memory(list(range(10)))
                    .map(lambda x: x * 2)
                    .filter(lambda x: x > 3))
        """)
        rec, diags = lint.lint_target(mod)
        assert rec["pipelines"] == ["pipeline0"], rec
        ref_mod = self._write_module(
            tmp_path, open(mod).read().replace("dampr_tpu_torch",
                                               "dampr_tpu"), "ref_lintee.py")
        from dampr_tpu.analyze import lint as ref_lint

        ref_rec, ref_diags = ref_lint.lint_target(ref_mod)
        assert [d["code"] for d in diags] == ["DTA501", "DTA501"]
        assert diags == ref_diags
        assert rec["pipelines"] == ref_rec["pipelines"]
        capsys.readouterr()
