"""UDF property classifier: purity and determinism verdicts from bytecode
(port of ``dampr_tpu/analyze/props.py``; the tables and the walk are
the same, so both packages give one UDF the same verdict and evidence).

The classifier is *evidence-based*: it walks a callable's compiled
bytecode (and the bytecode of every nested code object — lambdas,
comprehensions, genexps) looking for concrete hazard witnesses, and only
an actual witness downgrades the verdict.  A callable the walk cannot
see through (C builtins, callable objects without ``__code__``) gets the
benefit of the doubt — the zero-false-positive direction the validator
needs, with ``assume_pure=False``-style overrides left to the user.

Witness catalog (each carries the instruction that proved it):

- **purity**: ``STORE_GLOBAL``/``DELETE_GLOBAL``; calls to ``open``/
  ``print``/``input``; writes through OS/file handles (``os.remove``,
  ``.write`` on a closure-held handle); mutating-method calls
  (``append``/``update``/``add``/...) on closure or global receivers;
  ``STORE_ATTR``/``STORE_SUBSCR`` whose receiver was loaded from a
  closure cell or module global.
- **determinism**: any reach into ``random``/``secrets``/``uuid``/
  ``time``/``datetime``/``numpy.random`` (module attribute access or a
  direct global bound to one of their functions), plus closure cells
  holding live RNG instances (``random.Random``, numpy ``Generator`` /
  ``RandomState``) — an unseeded RNG is the canonical speculation
  hazard.

Local mutation is *not* impurity: a UDF that builds and mutates its own
locals (the dedupe filter's fresh set, an accumulator list) is pure in
every sense the engine cares about.  Instance state on ``self``
(``STORE_ATTR`` on a method's first argument) is also exempt — the
BlockMapper/BlockReducer lifecycle is deep-copied per job by contract.
"""

import dis
import types

#: Module roots whose use marks a callable nondeterministic.  Matched
#: against ``module.__name__`` prefixes so ``numpy.random.mtrand`` and
#: friends resolve too.
NONDET_MODULES = ("random", "secrets", "uuid", "time", "numpy.random")

#: ``datetime`` is deterministic except for the clock readers.
NONDET_DATETIME_ATTRS = frozenset(("now", "today", "utcnow"))

#: ``os`` members that read entropy or the clock.
NONDET_OS_ATTRS = frozenset(("urandom", "getrandbits", "times"))

#: ``os`` members that mutate the world (impurity witnesses).
IMPURE_OS_ATTRS = frozenset((
    "remove", "unlink", "rename", "replace", "rmdir", "mkdir", "makedirs",
    "system", "popen", "chmod", "chown", "truncate", "environ", "putenv",
    "kill", "removedirs", "symlink", "link", "open", "write"))

#: Bare global names whose *call* is an I/O side effect.
IMPURE_GLOBAL_CALLS = frozenset(("open", "print", "input", "exec"))

#: Mutating method names: calling one on a closure/global receiver is a
#: shared-state write.  Deliberately excludes names that are commonly
#: pure on other types (``count``, ``index``, ``get``, ``copy``...).
MUTATOR_METHODS = frozenset((
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "sort", "reverse",
    "appendleft", "extendleft", "popleft", "write", "writelines",
    "writerow", "writerows", "send", "put", "put_nowait"))

#: RNG instance types recognized in closure cells / defaults.
_RNG_TYPE_NAMES = (
    ("random", "Random"), ("random", "SystemRandom"),
    ("numpy.random", "Generator"), ("numpy.random", "RandomState"),
    ("numpy.random.mtrand", "RandomState"),
)

_GLOBAL_LOADS = ("LOAD_GLOBAL", "LOAD_NAME")
_DEREF_LOADS = ("LOAD_DEREF", "LOAD_CLASSDEREF")
_ATTR_LOADS = ("LOAD_ATTR", "LOAD_METHOD")


class Verdict(object):
    """Classification result for one callable (or one operator/stage,
    when merged).  ``pure``/``deterministic`` stay True until a witness
    lands in the matching evidence list."""

    __slots__ = ("name", "pure", "deterministic", "impure_evidence",
                 "nondet_evidence", "opaque")

    def __init__(self, name):
        self.name = name
        self.pure = True
        self.deterministic = True
        self.impure_evidence = []
        self.nondet_evidence = []
        self.opaque = False  # no bytecode to inspect (builtin / C callable)

    def impure(self, why):
        self.pure = False
        if why not in self.impure_evidence:
            self.impure_evidence.append(why)

    def nondet(self, why):
        self.deterministic = False
        if why not in self.nondet_evidence:
            self.nondet_evidence.append(why)

    def merge(self, other):
        if not other.pure:
            self.pure = False
            for e in other.impure_evidence:
                self.impure(e)
        if not other.deterministic:
            self.deterministic = False
            for e in other.nondet_evidence:
                self.nondet(e)
        return self

    def clone(self):
        v = Verdict(self.name)
        v.pure = self.pure
        v.deterministic = self.deterministic
        v.impure_evidence = list(self.impure_evidence)
        v.nondet_evidence = list(self.nondet_evidence)
        v.opaque = self.opaque
        return v

    def to_dict(self):
        return {
            "name": self.name,
            "pure": self.pure,
            "deterministic": self.deterministic,
            "impure_evidence": list(self.impure_evidence),
            "nondet_evidence": list(self.nondet_evidence),
        }

    def __repr__(self):
        return "Verdict({}, pure={}, deterministic={})".format(
            self.name, self.pure, self.deterministic)


def callable_name(f):
    return getattr(f, "__qualname__", None) or getattr(
        f, "__name__", None) or type(f).__name__


def _module_root(mod):
    name = getattr(mod, "__name__", "") or ""
    for root in NONDET_MODULES:
        if name == root or name.startswith(root + "."):
            return root
    return None


def _is_rng_instance(v):
    for mod, cls in _RNG_TYPE_NAMES:
        t = type(v)
        if t.__name__ == cls and (t.__module__ or "").startswith(mod):
            return True
    return False


def _resolved_bindings(f):
    """{name: value} for every global and closure binding the function
    can reach — what LOAD_GLOBAL / LOAD_DEREF would actually load."""
    out = {}
    code = getattr(f, "__code__", None)
    g = getattr(f, "__globals__", None) or {}
    if code is not None:
        for name in code.co_names:
            if name in g:
                out[name] = g[name]
        closure = getattr(f, "__closure__", None) or ()
        free = code.co_freevars
        for name, cell in zip(free, closure):
            try:
                out[name] = cell.cell_contents
            except ValueError:
                pass  # empty cell (still being built)
    return out


def _builtin_verdict(f, v):
    """Known C-level callables: classify by qualified name."""
    mod = getattr(f, "__module__", "") or ""
    qual = callable_name(f)
    for root in NONDET_MODULES:
        if mod == root or mod.startswith(root + "."):
            v.nondet("calls {}.{} (nondeterministic source)".format(
                mod, qual))
            return v
    # Bound methods of RNG instances (random.Random().random).
    recv = getattr(f, "__self__", None)
    if recv is not None and _is_rng_instance(recv):
        v.nondet("bound method {} of RNG instance {}".format(
            qual, type(recv).__name__))
    if qual in ("open", "print", "input"):
        v.impure("calls builtin {}() (I/O)".format(qual))
    v.opaque = True
    return v


def _scan_code(code, bindings, v, self_name=None, depth=0):
    """One code object's instruction walk.  ``bindings`` resolves names
    to live objects so module-attribute hazards classify precisely;
    ``self_name`` exempts instance-attribute writes on methods."""
    if depth > 4:
        return
    last = None  # previous meaningful instruction
    # What the receiver of an ATTR/SUBSCR write most plausibly was:
    # tracked as the source kind of the most recent non-const load.
    recent_loads = []
    # The object most plausibly on top of the stack after the previous
    # load, when statically resolvable — lets attribute CHAINS classify
    # (np.random.rand, datetime.datetime.now): each LOAD_ATTR hop over a
    # module/class receiver resolves one level deeper.  Only modules and
    # classes resolve (getattr on arbitrary objects could run property
    # code).
    tos_obj = None
    # Augmented subscript (``d[k] += v``) loads container+key BEFORE the
    # read (BINARY_SUBSCR) with no value load first — snapshot the loads
    # there so STORE_SUBSCR can find the receiver in either pattern.
    aug = None
    aug_nonconst = 0
    for ins in dis.get_instructions(code):
        op = ins.opname
        arg = ins.argval
        new_tos = None
        if op == "BINARY_SUBSCR":
            aug = list(recent_loads)
            aug_nonconst = 0
        if op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
            v.impure("{} of global '{}'".format(
                "write" if op == "STORE_GLOBAL" else "delete", arg))
        elif op in _GLOBAL_LOADS:
            if arg in IMPURE_GLOBAL_CALLS and arg not in bindings:
                v.impure("calls builtin {}() (I/O)".format(arg))
            bound = bindings.get(arg)
            if bound is not None and not isinstance(
                    bound, types.ModuleType):
                if callable(bound):
                    m = getattr(bound, "__module__", "") or ""
                    for root in NONDET_MODULES:
                        if m == root or m.startswith(root + "."):
                            v.nondet("calls {} from module '{}'".format(
                                arg, root))
                            break
                    else:
                        # C-level bound methods (random.random is a
                        # method of a hidden Random()) report no module;
                        # classify by their receiver.
                        if _is_rng_instance(getattr(bound, "__self__",
                                                    None)):
                            v.nondet("calls {} (bound method of an RNG "
                                     "instance)".format(arg))
                if _is_rng_instance(bound):
                    v.nondet("uses RNG instance '{}' ({})".format(
                        arg, type(bound).__name__))
            new_tos = bound
            recent_loads.append(("global", arg))
        elif op in _DEREF_LOADS:
            bound = bindings.get(arg)
            if bound is not None and _is_rng_instance(bound):
                v.nondet("closure variable '{}' holds an RNG instance "
                         "({})".format(arg, type(bound).__name__))
            new_tos = bound
            recent_loads.append(("closure", arg))
        elif op in _ATTR_LOADS:
            src = last
            recv = tos_obj
            if recv is not None and src is not None \
                    and src.opname in _ATTR_LOADS:
                # Chained receiver (module.module.f / module.Class.m):
                # the direct-load cases below see only one hop.
                if isinstance(recv, types.ModuleType):
                    root = _module_root(recv)
                    if root is not None and arg != "seed":
                        v.nondet("calls {}.{}".format(recv.__name__, arg))
                    if recv.__name__ == "datetime" \
                            and arg in NONDET_DATETIME_ATTRS:
                        v.nondet("calls datetime.{}".format(arg))
                elif isinstance(recv, type):
                    if getattr(recv, "__module__", "") == "datetime" \
                            and arg in NONDET_DATETIME_ATTRS:
                        v.nondet("calls datetime.{}.{}".format(
                            recv.__name__, arg))
            if isinstance(recv, (types.ModuleType, type)):
                try:
                    new_tos = getattr(recv, arg, None)
                except Exception:  # noqa: BLE001 - exotic module getattr
                    new_tos = None
            if src is not None and src.opname in (
                    _GLOBAL_LOADS + _DEREF_LOADS):
                recv_name = src.argval
                bound = bindings.get(recv_name)
                if isinstance(bound, types.ModuleType):
                    root = _module_root(bound)
                    if root is not None and arg != "seed":
                        v.nondet("calls {}.{}".format(
                            bound.__name__, arg))
                    if bound.__name__ == "datetime" \
                            and arg in NONDET_DATETIME_ATTRS:
                        v.nondet("calls datetime.{}".format(arg))
                    if bound.__name__ == "os":
                        if arg in NONDET_OS_ATTRS:
                            v.nondet("calls os.{}".format(arg))
                        if arg in IMPURE_OS_ATTRS:
                            v.impure("calls os.{} (filesystem/process "
                                     "side effect)".format(arg))
                elif bound is not None and _is_rng_instance(bound):
                    v.nondet("calls {}.{} on an RNG instance".format(
                        recv_name, arg))
                elif arg in MUTATOR_METHODS:
                    kind = ("closure" if src.opname in _DEREF_LOADS
                            else "global")
                    if not isinstance(bound, types.ModuleType) and (
                            bound is None or not callable(bound)):
                        v.impure(
                            "mutates {} variable '{}' via .{}()".format(
                                kind, recv_name, arg))
                # datetime classes: datetime.datetime.now()
                if isinstance(bound, type) and getattr(
                        bound, "__module__", "") == "datetime" \
                        and arg in NONDET_DATETIME_ATTRS:
                    v.nondet("calls datetime.{}.{}".format(
                        bound.__name__, arg))
            recent_loads.append(("attr", arg))
        elif op in ("STORE_ATTR", "DELETE_ATTR"):
            src = last
            if src is not None:
                if src.opname in _DEREF_LOADS:
                    v.impure("writes attribute '{}' of closure variable "
                             "'{}'".format(arg, src.argval))
                elif src.opname in _GLOBAL_LOADS:
                    v.impure("writes attribute '{}' of global "
                             "'{}'".format(arg, src.argval))
                elif (src.opname == "LOAD_FAST" and self_name is not None
                        and src.argval == self_name):
                    pass  # instance state on self: per-job-copied contract
        elif op in ("STORE_SUBSCR", "DELETE_SUBSCR"):
            # ``d[k] = v`` loads value, then CONTAINER, then key — the
            # receiver is the second-to-last load.  ``d[k] += v`` loads
            # container, then key, before the BINARY_SUBSCR read: the
            # snapshot taken there (still clean = only consts since)
            # holds the same [container, key] tail.  Checking exactly
            # the receiver position (not a window) keeps a nonlocal
            # VALUE assigned into a local container from flagging;
            # computed keys hide the receiver and err toward no-flag —
            # the zero-false-positive direction.
            if aug is not None and aug_nonconst == 0:
                loads = aug
            else:
                loads = recent_loads
            if len(loads) >= 2:
                kind, name = loads[-2]
                if kind in ("closure", "global"):
                    bound = bindings.get(name)
                    if not (isinstance(bound, types.ModuleType)
                            or callable(bound)):
                        v.impure("subscript write into {} variable "
                                 "'{}'".format(kind, name))
            aug = None
        elif op == "LOAD_FAST":
            recent_loads.append(("local", arg))
        elif op == "LOAD_CONST":
            if isinstance(arg, types.CodeType):
                _scan_code(arg, bindings, v, depth=depth + 1)
            recent_loads.append(("const", None))
        if aug is not None and op != "BINARY_SUBSCR" and op in (
                _GLOBAL_LOADS + _DEREF_LOADS + _ATTR_LOADS
                + ("LOAD_FAST",)):
            aug_nonconst += 1
        if op not in ("CACHE", "PRECALL", "RESUME", "PUSH_NULL", "COPY",
                      "NOP", "EXTENDED_ARG"):
            last = ins
            tos_obj = new_tos
        if len(recent_loads) > 8:
            del recent_loads[:-8]


import threading as _threading
import weakref as _weakref

_VERDICT_CACHE = _weakref.WeakKeyDictionary()  # f -> Verdict (frozen copy)
_VERDICT_LOCK = _threading.Lock()


def classify_callable(f, _depth=0):
    """Purity/determinism :class:`Verdict` for one callable.  Cached per
    function object (the plan passes, the speculation gate, and the
    report section may all classify the same UDF in one run); callers
    get a fresh clone, so renaming/merging never poisons the cache."""
    try:
        with _VERDICT_LOCK:
            hit = _VERDICT_CACHE.get(f)
    except TypeError:
        hit = None
    if hit is not None:
        return hit.clone()
    v = _classify_uncached(f, _depth)
    try:
        with _VERDICT_LOCK:
            _VERDICT_CACHE[f] = v.clone()
    except TypeError:
        pass  # unweakrefable callable: classify each time
    return v


def _classify_uncached(f, _depth=0):
    import functools

    v = Verdict(callable_name(f))
    if isinstance(f, functools.partial):
        return v.merge(classify_callable(f.func, _depth))
    if isinstance(f, types.MethodType):
        inner = classify_callable(f.__func__, _depth)
        inner.name = v.name
        recv = f.__self__
        if _is_rng_instance(recv):
            inner.nondet("bound method of RNG instance {}".format(
                type(recv).__name__))
        return inner
    code = getattr(f, "__code__", None)
    if code is None:
        if callable(f):
            call = getattr(type(f), "__call__", None)
            inner_code = getattr(call, "__code__", None)
            if inner_code is not None and _depth < 3:
                inner = classify_callable(call, _depth + 1)
                inner.name = v.name
                return inner
            return _builtin_verdict(f, v)
        return v
    # Methods' first positional arg ('self' by convention) is the
    # per-job-copied receiver; attribute writes on it are lifecycle
    # state, not shared-state impurity.
    self_name = (code.co_varnames[0]
                 if (code.co_argcount >= 1 and code.co_varnames
                     and code.co_varnames[0] == "self") else None)
    bindings = _resolved_bindings(f)
    _scan_code(code, bindings, v, self_name=self_name)
    # Closure cells holding RNGs are a hazard even when this code object
    # never touches them directly (a nested lambda might).
    for name, val in bindings.items():
        if name in code.co_freevars and _is_rng_instance(val):
            v.nondet("closure variable '{}' holds an RNG instance "
                     "({})".format(name, type(val).__name__))
    return v


#: Operator attributes that hold user callables — shared with
#: :func:`..plan.ir.part_name`'s probe list.
UDF_ATTRS = ("mapper", "f", "key_f", "value_f", "streamer_f", "reducer",
             "stream_f", "crosser", "sinker", "joiner_f", "load_f")


def iter_udfs(op, _seen=None, _depth=0):
    """Yield ``(label, callable)`` for every user callable reachable from
    an operator (composed chains flatten; wrapper attrs walk one level)."""
    if _seen is None:
        _seen = set()
    if id(op) in _seen or _depth > 6 or op is None:
        return
    _seen.add(id(op))
    from .. import base

    if type(op) in (base.ComposedMapper, base.ComposedStreamable):
        for part in (op.left, op.right):
            for item in iter_udfs(part, _seen, _depth + 1):
                yield item
        return
    label = type(op).__name__
    found = False
    for attr in UDF_ATTRS:
        f = getattr(op, attr, None)
        if f is None:
            continue
        if isinstance(f, base.Mapper) or isinstance(f, base.Reducer) \
                or isinstance(f, base.Streamable):
            for item in iter_udfs(f, _seen, _depth + 1):
                yield item
            found = True
        elif callable(f):
            yield "{}.{}[{}]".format(label, attr, callable_name(f)), f
            found = True
    if not found and callable(op) and not isinstance(op, type):
        yield label, op


def operator_verdict(op):
    """Merged verdict over every UDF an operator holds, plus op-level
    knowledge the bytecode can't see (Sample's RNG, Inspect's print)."""
    from .. import base, settings

    v = Verdict(type(op).__name__)
    if isinstance(op, base.Sample):
        if settings.seed is None:
            v.nondet("Sample draws from a time-seeded per-thread RNG "
                     "(set settings.seed for reproducible sampling)")
    if isinstance(op, base.Inspect):
        v.impure("Inspect prints every record (debug passthrough)")
    for label, f in iter_udfs(op):
        fv = classify_callable(f)
        fv.name = label
        v.merge(fv)
    return v


def stage_verdict(stage):
    """Merged purity/determinism verdict for one graph stage, honoring
    the per-stage ``assume_pure`` / ``assume_deterministic`` overrides
    (``custom_mapper(m, assume_pure=True)``-style options)."""
    from ..graph import GMap, GReduce, GSink
    from ..plan import ir

    opts = getattr(stage, "options", None) or {}
    v = Verdict(ir.describe_stage(stage) if hasattr(stage, "inputs")
                else repr(stage))
    parts = []
    if isinstance(stage, GMap):
        parts.extend(ir.flatten_mapper(stage.mapper))
        if stage.combiner is not None:
            parts.append(stage.combiner)
    elif isinstance(stage, GReduce):
        parts.append(stage.reducer)
    elif isinstance(stage, GSink):
        parts.extend(ir.flatten_mapper(stage.sinker))
    for p in parts:
        v.merge(operator_verdict(p))
    if "binop" in opts:
        from ..ops import segment

        op = segment.as_assoc_op(opts["binop"])
        if op.kind is None and op.fn is not None:
            v.merge(operator_verdict(op.fn))
    if opts.get("assume_pure"):
        v.pure = True
        v.impure_evidence = []
    if opts.get("assume_deterministic"):
        v.deterministic = True
        v.nondet_evidence = []
    return v
