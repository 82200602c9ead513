"""Plan wire form: how a composed pipeline travels to the daemon.

Port of ``dampr_tpu/serve/wire.py``, whole.  The engine runs UDFs on
threads, so nothing in a normal run pickles a function, and pipelines
are full of lambdas and closures, which plain pickle rejects.
:class:`_PlanPickler` therefore serializes every plain Python function
*by value*: its marshalled code, closure cells, defaults, and the module
globals its code names (recursively, so a lambda calling a module-level
helper carries the helper along); modules travel by name.  Functions of
the packages a worker imports by construction travel by reference
(:data:`_BY_REF_PACKAGES`: the standard library, this package, numpy and
torch), so a scanner such as ``ops.text.DocFreq`` is rebuilt from the
worker's own import.  Everything else must pickle normally; a capture
that cannot is the ``DTA401`` diagnostic, which the admission gate
reports instead of crashing a worker.

Limits: client and server run the same Python minor version (marshal is
version-specific; :func:`decode` refuses a mismatch); classes defined in
unimportable modules (``__main__``, a test file) cannot ship; and the
wire is pickle, so the daemon executes what clients send: a
trusted-client protocol (the daemon binds loopback by default).

The submission fingerprint is the chained stage fingerprint of the
requested output (:mod:`..resume`), so two clients composing the same
plan over the same input files coalesce onto one run.
"""

import glob
import importlib
import io
import marshal
import os
import pickle
import sys
import types

WIRE_VERSION = 1


class WireError(ValueError):
    """A submission that cannot travel: version/python mismatch, an
    unserializable capture, or a malformed envelope."""


# -- by-value function serialization -----------------------------------------

def _collect_names(code, out):
    """Every global name the code object (or a nested one) references."""
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _collect_names(const, out)


def _fn_skeleton(code_bytes, n_cells):
    """Rebuild an empty function shell first so reference cycles through
    ``__globals__`` (recursive lambdas, mutually-recursive helpers) can
    memoize it before its state pickles."""
    code = marshal.loads(code_bytes)
    cells = tuple(types.CellType() for _ in range(n_cells))
    return types.FunctionType(code, {}, code.co_name, None, cells or None)


def _fn_setstate(fn, state):
    import builtins

    fn.__globals__.update(state["globals"])
    fn.__globals__.setdefault("__builtins__", builtins)
    if state["defaults"] is not None:
        fn.__defaults__ = tuple(state["defaults"])
    if state["kwdefaults"]:
        fn.__kwdefaults__ = dict(state["kwdefaults"])
    fn.__name__ = state["name"]
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    if state["dict"]:
        fn.__dict__.update(state["dict"])
    for cell, boxed in zip(fn.__closure__ or (), state["cells"]):
        if boxed is not None:
            cell.cell_contents = boxed[0]
    return fn


#: Top-level packages whose functions travel **by reference** (normal
#: pickle): they are importable in the worker by construction — the
#: engine itself, the stdlib, and the numeric stack the engine already
#: requires (never the JAX package: a worker imports neither it nor
#: jax).  Everything else (client scripts, ``__main__``, test
#: modules, notebooks) ships by value: the daemon's worker cannot be
#: assumed to import it.  Without this split, serializing ONE lambda
#: that references an engine helper would chase the engine's entire
#: module-level function graph by value (and blow the recursion limit).
_BY_REF_PACKAGES = set(getattr(sys, "stdlib_module_names", ())) | {
    "dampr_tpu_torch", "numpy", "torch"}


def _ships_by_reference(fn):
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", None)
    if not module or not qualname or "<" in qualname:
        return False  # lambdas, <locals>, dynamically-built functions
    if module.split(".")[0] not in _BY_REF_PACKAGES:
        return False
    mod = sys.modules.get(module)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
    return obj is fn


class _PlanPickler(pickle.Pickler):
    """Pickler that ships plain functions by code and modules by name."""

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            if _ships_by_reference(obj):
                return NotImplemented
            return self._reduce_function(obj)
        if isinstance(obj, types.ModuleType):
            return (importlib.import_module, (obj.__name__,))
        return NotImplemented

    def _reduce_function(self, fn):
        code = fn.__code__
        cells = []
        for cell in fn.__closure__ or ():
            try:
                cells.append((cell.cell_contents,))
            except ValueError:  # genuinely empty cell
                cells.append(None)
        names = set()
        _collect_names(code, names)
        globs = {}
        for name in sorted(names):
            if name in fn.__globals__:
                globs[name] = fn.__globals__[name]
        state = {
            "globals": globs,
            "defaults": fn.__defaults__,
            "kwdefaults": fn.__kwdefaults__,
            "name": fn.__name__,
            "qualname": fn.__qualname__,
            "module": getattr(fn, "__module__", None)
            or "dampr_tpu_torch.wire",
            "dict": fn.__dict__ or None,
            "cells": cells,
        }
        return (_fn_skeleton,
                (marshal.dumps(code), len(cells)),
                state, None, None, _fn_setstate)


# -- envelope ----------------------------------------------------------------

def encode(graph, source):
    """Serialize ``(graph, output source)`` to wire bytes.  Raises
    :class:`WireError` naming the offending capture when something in
    the plan cannot travel."""
    buf = io.BytesIO()
    pickler = _PlanPickler(buf, protocol=pickle.HIGHEST_PROTOCOL)
    try:
        pickler.dump({
            "wire": WIRE_VERSION,
            "py": list(sys.version_info[:2]),
            "graph": graph,
            "source": source,
        })
    except WireError:
        raise
    except Exception as e:
        raise WireError(
            "plan cannot be serialized for submission: {}: {}".format(
                type(e).__name__, e))
    return buf.getvalue()


def decode(data):
    """Wire bytes -> ``(graph, source)``.  Raises :class:`WireError` on
    a malformed envelope or a client/server version mismatch."""
    try:
        env = pickle.loads(data)
    except Exception as e:
        raise WireError(
            "submission payload does not decode: {}: {}".format(
                type(e).__name__, e))
    if not isinstance(env, dict) or env.get("wire") != WIRE_VERSION:
        raise WireError("unsupported wire version: {!r}".format(
            env.get("wire") if isinstance(env, dict) else None))
    py = tuple(env.get("py") or ())
    if py != sys.version_info[:2]:
        raise WireError(
            "python version mismatch: client {} vs server {}.{} "
            "(marshalled code is version-specific)".format(
                ".".join(str(v) for v in py), *sys.version_info[:2]))
    return env["graph"], env["source"]


# -- submission fingerprint --------------------------------------------------

def plan_fingerprint(graph, source):
    """The submission fingerprint: the chained stage fingerprint of the
    requested output (``resume.stage_fingerprints``), or the salted tap
    fingerprint when the output IS an input tap.  Volatile fingerprints
    (unfingerprintable captures) never coalesce — check with
    :func:`dampr_tpu_torch.resume.is_volatile`."""
    from .. import resume
    from ..graph import GInput

    fps = resume.stage_fingerprints(graph)
    for sid, stage in enumerate(graph.stages):
        if stage.output == source:
            if sid in fps:
                return fps[sid]
            if isinstance(stage, GInput):
                return resume._h("tap-salted", "", resume._fp_tap(stage.tap))
    return resume._volatile()


def is_volatile(fp):
    from .. import resume

    return resume.is_volatile(fp)


# -- admission cost estimate -------------------------------------------------

def estimate_input_bytes(graph, default=1 << 20):
    """Rough input volume of a plan — what the scheduler reserves
    against the tenant's byte budget.  Path taps stat their files
    (mirroring ``resume._fp_tap``'s file discovery); memory taps charge
    a flat per-record figure; anything opaque charges ``default``.
    Deliberately cheap and conservative: admission control needs a
    consistent ordering of job sizes, not an exact byte count."""
    from ..graph import GInput

    total = 0
    for stage in graph.stages:
        if not isinstance(stage, GInput):
            continue
        tap = stage.tap
        path = getattr(tap, "path", None)
        if isinstance(path, str):
            files = [p for p in glob.glob(path) or [path]
                     if os.path.isfile(p)]
            if not files and os.path.isdir(path):
                files = [os.path.join(d, f)
                         for d, _dirs, fs in os.walk(path) for f in fs]
            try:
                total += sum(os.path.getsize(p) for p in files)
            except OSError:
                total += default
            continue
        items = getattr(tap, "items", None)
        if items is not None:
            try:
                total += max(1, len(items)) * 128
            except TypeError:
                total += default
            continue
        total += default
    return max(total, 1)
