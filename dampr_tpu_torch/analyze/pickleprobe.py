"""Dispatch-safety probe: will this operator's captured state survive a
process boundary?  (Port of ``dampr_tpu/analyze/pickleprobe.py``.)

This engine runs jobs on threads, so UDFs themselves never pickle — but
their *captured state* does cross serialization boundaries: checkpoint
fingerprints hash pickled opaque objects (an unpicklable capture makes
the stage fingerprint volatile, silently disabling ``resume=``), and any
process-pool / multi-rank mesh deployment ships closures to workers the
way the fork-based reference did.  Today the failure is a raw
``PicklingError`` traceback from deep inside the dispatch machinery;
the probe surfaces it pre-flight, naming the stage, the UDF, and the
exact closure variable.

The probe deliberately does NOT require the function object itself to
pickle (plain functions/lambdas ship by code under fork or re-import);
it probes what the function *carries*: closure cells, defaults, and —
for callable objects — instance attributes.
"""

import functools
import pickle
import types


class _NullSink(object):
    """Discarding pickle sink: the probe needs the serialization
    ATTEMPT, not the bytes — a multi-hundred-MB broadcast table must
    not be materialized twice just to learn it pickles."""

    __slots__ = ()

    def write(self, b):
        return len(b)


def _try_pickle(v):
    """None when ``v`` pickles; the one-line error otherwise."""
    try:
        pickle.Pickler(_NullSink(),
                       protocol=pickle.HIGHEST_PROTOCOL).dump(v)
        return None
    except Exception as e:  # noqa: BLE001 - any failure is the answer
        return "{}: {}".format(type(e).__name__, str(e)[:200])


def _is_plain_function(v):
    return isinstance(v, (types.FunctionType, types.BuiltinFunctionType,
                          types.BuiltinMethodType, types.MethodType,
                          functools.partial, type))


def probe_callable(f, label=None):
    """Probe one callable's captured state.  Returns a list of problem
    dicts ``{"where", "variable", "error"}`` (empty = dispatch-safe)."""
    problems = []
    label = label or getattr(f, "__qualname__", type(f).__name__)
    if isinstance(f, functools.partial):
        for i, a in enumerate(f.args):
            err = None if _is_plain_function(a) else _try_pickle(a)
            if err:
                problems.append({"where": label, "variable":
                                 "partial arg {}".format(i), "error": err})
        for k, a in (f.keywords or {}).items():
            err = None if _is_plain_function(a) else _try_pickle(a)
            if err:
                problems.append({"where": label, "variable":
                                 "partial kwarg '{}'".format(k),
                                 "error": err})
        return problems + probe_callable(f.func, label)
    if isinstance(f, types.MethodType):
        recv = f.__self__
        if not isinstance(recv, type):
            err = _try_pickle(recv)
            if err:
                problems.append({"where": label,
                                 "variable": "bound receiver ({})".format(
                                     type(recv).__name__),
                                 "error": err})
        return problems
    code = getattr(f, "__code__", None)
    if code is not None:
        closure = getattr(f, "__closure__", None) or ()
        for name, cell in zip(code.co_freevars, closure):
            try:
                val = cell.cell_contents
            except ValueError:
                continue
            if _is_plain_function(val):
                # Captured helper functions ship by code, and their own
                # captures get probed when the classifier reaches them.
                continue
            err = _try_pickle(val)
            if err:
                problems.append({"where": label,
                                 "variable": "closure variable "
                                 "'{}' ({})".format(name,
                                                    type(val).__name__),
                                 "error": err})
        for i, d in enumerate(f.__defaults__ or ()):
            if _is_plain_function(d):
                continue
            err = _try_pickle(d)
            if err:
                problems.append({"where": label,
                                 "variable": "default arg {}".format(i),
                                 "error": err})
        return problems
    # Callable object: its instance attributes are the captured state.
    held = getattr(f, "__dict__", None) or {}
    for name, val in held.items():
        if _is_plain_function(val) or callable(val):
            continue
        err = _try_pickle(val)
        if err:
            problems.append({"where": label,
                             "variable": "attribute '{}' ({})".format(
                                 name, type(val).__name__),
                             "error": err})
    return problems


def probe_operator(op):
    """Probe every UDF an operator holds.  Returns the merged problem
    list (empty = the whole operator is dispatch-safe)."""
    from .props import iter_udfs

    problems = []
    seen = set()
    for label, f in iter_udfs(op):
        key = id(f)
        if key in seen:
            continue
        seen.add(key)
        problems.extend(probe_callable(f, label))
    # Operator-held non-callable state (a BlockMapper's config) probes
    # through the same attribute walk.
    for name, val in (getattr(op, "__dict__", None) or {}).items():
        if callable(val) or _is_plain_function(val):
            continue
        err = _try_pickle(val)
        if err:
            problems.append({"where": type(op).__name__,
                             "variable": "attribute '{}' ({})".format(
                                 name, type(val).__name__),
                             "error": err})
    return problems
