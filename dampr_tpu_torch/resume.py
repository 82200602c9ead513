"""Durable checkpoint/resume for named runs (crash recovery).

Port of ``dampr_tpu/resume.py``, whole: the same chained structural
fingerprints, manifests, retention, run guard and GC, so a stage
restores after the same edits in both packages.  A device-resident
stage output (the HBM tier, the handoff's counts) persists through
``BlockRef.get()``: one counted fetch of its value lane on the calling
thread, which waits for the lanes' ready event; the device copy stays
live for the consuming fold, and the writer pool only ever sees the
fetched host block.

With ``run(name=..., resume=True)`` every completed stage persists its
output partition set (RAM-resident blocks are *also* written to a ckpt
directory — they stay hot for the next stage and become free spill
victims) plus an atomic per-stage manifest carrying a **chained structural
fingerprint**.  A rerun under the same name reloads the longest valid
manifest prefix as disk-backed partition sets and skips those stages.

Fingerprints chain through the DAG::

    fp(stage) = H(stage structure, input-tap identity, fp(inputs))

so editing an upstream stage — or touching an input file — invalidates
every downstream manifest.  Structure fingerprinting is best-effort but
sharp for the common case: Python functions hash their bytecode, constants
and closure-cell values, so editing a lambda body or a captured constant
re-executes its stage.  Captured containers hash by CONTENT (a changed
stopword list must invalidate its stage) — the corollary is that a
closure accumulating state into a captured list defeats resume for its
stage, which errs on the safe side: lost reuse, never stale reuse.
Objects that defy fingerprinting entirely mark the stage *volatile*: it
always re-executes (correctness is never traded for reuse).
"""

import functools
import glob
import hashlib
import json
import logging
import os
import pickle
import threading
import types
import uuid

import numpy as np

log = logging.getLogger("dampr_tpu_torch.resume")

_VOLATILE = "volatile"
_MAX_DEPTH = 6
_MAX_SEQ = 1000
_TUPLE_END = object()


def _h(*parts):
    """Hash ``parts`` (recursing into tuples) — but if any part is itself a
    ``volatile:`` fingerprint, the combination is volatile too.  Without
    this propagation a container holding an unfingerprintable leaf would
    hash to a random-but-unmarked value: safe (it never matches) but
    invisible to ``is_volatile`` callers that decide whether a stage's
    checkpoint files are worth persisting at all."""
    m = hashlib.sha1()
    stack = [parts]
    while stack:
        p = stack.pop()
        if p is _TUPLE_END:
            # Close marker: without it nesting is not injective —
            # _h(a, (b,), c) and _h(a, (b, c)) would emit identical
            # byte streams, and a collision here is stale checkpoint
            # reuse.
            m.update(b"\x02")
            continue
        if isinstance(p, tuple):
            m.update(b"\x01")
            stack.append(_TUPLE_END)
            stack.extend(reversed(p))
            continue
        if isinstance(p, str) and is_volatile(p):
            return _volatile()
        m.update(p if isinstance(p, (bytes, bytearray, memoryview))
                 else str(p).encode("utf-8"))
        m.update(b"\x00")
    return m.hexdigest()


def _volatile():
    return "{}:{}".format(_VOLATILE, uuid.uuid4().hex)


def is_volatile(fp):
    """Match the exact out-of-band sentinel form ``volatile:<32 hex>`` —
    a bare prefix test would misfire on user identifiers that happen to
    start with "volatile" (a function named ``volatile_mapper``, a sink
    path), silently disabling resume for their stage."""
    return (len(fp) == len(_VOLATILE) + 33
            and fp.startswith(_VOLATILE + ":")
            and all(c in "0123456789abcdef" for c in fp[len(_VOLATILE) + 1:]))


def _fp_function(f, depth):
    code = f.__code__
    cells = ()
    if f.__closure__:
        cells = tuple(
            _fp(c.cell_contents, depth + 1) for c in f.__closure__)
    consts = tuple(_fp(c, depth + 1) for c in code.co_consts)
    defaults = tuple(_fp(d, depth + 1) for d in (f.__defaults__ or ()))
    kwdefaults = _fp(f.__kwdefaults__, depth + 1)
    # Referenced globals are part of the function's behavior: hash each
    # co_names binding that resolves, so both *which* helper a lambda calls
    # (the name) and *what that helper does* (its own fp, recursively up to
    # the depth bound) invalidate the stage when edited.
    globs = []
    for name in code.co_names:
        if name in f.__globals__:
            v = f.__globals__[name]
            if isinstance(v, types.ModuleType):
                globs.append((name, _h("module", v.__name__)))
            else:
                globs.append((name, _fp(v, depth + 1)))
    return _h("fn", f.__qualname__, code.co_code, code.co_names, consts,
              cells, defaults, kwdefaults, tuple(globs))


def _is_composed(obj):
    """A fused-chain link node (base.ComposedMapper/ComposedStreamable) —
    type check by name avoids importing base at module load."""
    from . import base

    return type(obj) in (base.ComposedMapper, base.ComposedStreamable)


def _fp(obj, depth=0):
    """Best-effort structural fingerprint.  Deterministic across processes
    for code + plain data; ``volatile:`` (never matches) when it cannot be."""
    if depth > _MAX_DEPTH:
        # State buried past the depth cap is invisible to the walk; a
        # stable hash here would let deep edits reuse stale checkpoints.
        # Volatile is the documented safe direction: lost reuse, never
        # stale reuse.
        return _volatile()
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return _h("prim", repr(obj))
    if isinstance(obj, types.CodeType):
        return _h("code", obj.co_code, obj.co_names,
                  tuple(_fp(c, depth + 1) for c in obj.co_consts))
    if isinstance(obj, types.FunctionType):
        return _fp_function(obj, depth)
    if isinstance(obj, types.BuiltinFunctionType):
        return _h("builtin", getattr(obj, "__module__", ""), obj.__qualname__)
    if isinstance(obj, types.MethodType):
        return _h("method", _fp(obj.__self__, depth + 1), obj.__func__.__name__)
    if isinstance(obj, functools.partial):
        return _h("partial", _fp(obj.func, depth + 1),
                  _fp(obj.args, depth + 1), _fp(obj.keywords, depth + 1))
    if isinstance(obj, np.ma.MaskedArray):
        # The mask is semantic state the data buffer doesn't carry: two
        # arrays with equal data but different masks must not share a
        # fingerprint.  nomask stays cheap (no materialized mask array).
        base = np.asarray(obj.data)
        mask = np.ma.getmask(obj)
        mfp = ("nomask" if mask is np.ma.nomask
               else _array_digest(np.asarray(mask)))
        if base.dtype.hasobject:
            return _fp_bulk("ma-obj", (obj.shape, str(obj.dtype),
                                       base.tolist(), mfp,
                                       repr(obj.fill_value)))
        return _h("ndarray-masked", obj.shape, str(obj.dtype),
                  _array_digest(base), mfp, repr(obj.fill_value))
    if isinstance(obj, np.ndarray):
        # Content hash at every size: shape+dtype alone would let a
        # same-shaped array with different CONTENTS match its old
        # checkpoint (stale reuse).  sha1 streams at ~GB/s — negligible
        # next to running the stage.  Memoized per fingerprint pass: the
        # same weight array referenced by several mappers hashes once.
        cache = getattr(_tls, "cache", None)
        cached = None if cache is None else cache.get(id(obj))
        if cached is not None:
            return cached[1]
        if obj.dtype.hasobject:
            # Object buffers hold PyObject POINTERS — hashing them would
            # miss in-place mutation of the pointees (stale reuse) and
            # never match across processes; hash the pickled elements.
            fp = _fp_bulk("ndarray-obj",
                          (obj.shape, str(obj.dtype), obj.tolist()))
        else:
            fp = _h("ndarray", obj.shape, str(obj.dtype),
                    _array_digest(obj))
        if cache is not None:
            cache[id(obj)] = (obj, fp)  # hold obj: pins its id
        return fp
    if isinstance(obj, np.generic):
        return _h("npscalar", str(obj.dtype), obj.item())
    if isinstance(obj, (tuple, frozenset)):
        kind = type(obj).__name__
        items = sorted(obj, key=repr) if isinstance(obj, frozenset) else obj
        if len(items) > _MAX_SEQ:
            return _fp_bulk(kind, obj)
        return _h(kind, tuple(_fp(x, depth + 1) for x in items))
    if isinstance(obj, (list, set)):
        # Content identity: a changed captured parameter list must
        # invalidate its stage.  (Closures that accumulate state into a
        # captured container therefore defeat resume for their stage —
        # safe direction: recompute, never reuse stale.)
        kind = type(obj).__name__
        items = sorted(obj, key=repr) if isinstance(obj, set) else obj
        if len(items) > _MAX_SEQ:
            return _fp_bulk(kind, items)
        return _h(kind, tuple(_fp(x, depth + 1) for x in items))
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
        if len(items) > _MAX_SEQ:
            return _fp_bulk("dict", items)
        return _h("dict", tuple(
            (_fp(k, depth + 1), _fp(v, depth + 1)) for k, v in items))
    if isinstance(obj, type):
        return _h("type", obj.__module__, obj.__qualname__)
    if _is_composed(obj):
        # Fused op chains nest one Composed node per DSL op; walking them
        # recursively would charge the depth budget per chain LINK, so a
        # pipeline with >= _MAX_DEPTH chained per-record ops between
        # checkpoints silently fingerprinted volatile (resume lost).
        # Flatten iteratively: links fingerprint at THIS depth — the
        # budget charges only genuinely nested user state.
        links, stack = [], [obj]
        while stack:
            node = stack.pop()
            if _is_composed(node):
                stack.append(node.right)
                stack.append(node.left)
            else:
                links.append(node)
        return _h("opchain", tuple(_fp(x, depth) for x in links))
    # Generic object: type + attribute walk (slots and dict).  An object
    # exposing NO attributes (C-implemented callables and the like) hides
    # its state from the walk — hash its pickle if possible, else mark the
    # stage volatile rather than risk two differently-configured objects
    # fingerprinting alike (stale reuse).
    names = _attr_names(obj)
    if not names:
        try:
            return _h("opaque", type(obj).__module__, type(obj).__qualname__,
                      pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            return _volatile()
    state = []
    for name in names:
        try:
            v = getattr(obj, name)
        except AttributeError:
            continue
        state.append((name, _fp(v, depth + 1)))
    return _h("obj", type(obj).__module__, type(obj).__qualname__,
              tuple(state))


def _array_digest(a):
    """sha1 of an array's element bytes.  Non-contiguous views are copied
    in ~16MB row chunks, not whole — fingerprinting a multi-GB strided
    view must not transiently double its memory."""
    m = hashlib.sha1()
    if a.flags.c_contiguous:
        m.update(a.data)
    elif a.ndim == 0 or a.shape[0] == 0:
        m.update(np.ascontiguousarray(a).data)
    else:
        row_bytes = max(1, a.nbytes // a.shape[0])
        rows = max(1, (1 << 24) // row_bytes)
        for i in range(0, a.shape[0], rows):
            m.update(np.ascontiguousarray(a[i:i + rows]).data)
    return m.hexdigest()


_tls = threading.local()  # per-thread fingerprint-pass cache (two
# concurrent stage_fingerprints calls must not stomp each other's cache)


def _fp_bulk(kind, items):
    """Large payloads: one pickle pass instead of per-item recursion."""
    try:
        return _h("bulk-" + kind,
                  pickle.dumps(items, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:
        return _volatile()


def _attr_names(obj):
    names = []
    for klass in type(obj).__mro__:
        names.extend(getattr(klass, "__slots__", ()))
    names.extend(getattr(obj, "__dict__", ()))
    return sorted(set(n for n in names if not n.startswith("__")))


# -- taps --------------------------------------------------------------------

def _stat_fp(path):
    """Input-file identity: (path, size, mtime_ns) + a content probe over
    the first and last 64KB.  stat alone misses edits that preserve both
    size and mtime (rsync -t restores, mtime-coarse filesystems, tools
    that reset timestamps); the probe catches any such edit that touches
    either end of the file.  A same-size interior-only edit with a reset
    mtime remains undetectable without a full read — documented in
    Dampr.run(resume=...)."""
    st = os.stat(path)
    probe = b""
    try:
        with open(path, "rb") as f:
            probe = f.read(65536)
            if st.st_size > 131072:
                f.seek(-65536, os.SEEK_END)
                probe += f.read(65536)
            elif st.st_size > 65536:
                f.seek(65536)
                probe += f.read()
    except OSError:
        pass
    return (path, st.st_size, st.st_mtime_ns,
            hashlib.sha1(probe).hexdigest())


def _fp_tap(tap):
    """Input identity: the tap's chunk plan + per-file (size, mtime).  Any
    added/removed/grown/edited input file changes the fingerprint."""
    name = type(tap).__qualname__
    try:
        path = getattr(tap, "path", None)
        if isinstance(path, str):
            files = sorted(
                p for p in glob.glob(path) or [path] if os.path.isfile(p))
            if not files and os.path.isdir(path):
                files = sorted(
                    os.path.join(d, f)
                    for d, _dirs, fs in os.walk(path) for f in fs)
            return _h("tap", name, tuple(_stat_fp(p) for p in files),
                      getattr(tap, "chunk_size", 0))
        items = getattr(tap, "items", None)
        if items is not None:
            return _h("tap-mem", name, _fp(items),
                      getattr(tap, "partitions", 0))
        urls = getattr(tap, "urls", None)
        if urls is not None:
            return _h("tap-urls", name, tuple(urls))
        return _h("tap-obj", _fp(tap))
    except Exception:
        log.warning("tap %r is not fingerprintable; stage is volatile", name,
                    exc_info=True)
        return _volatile()


# -- per-stage chained fingerprints ------------------------------------------

def stage_fingerprints(graph, salt=""):
    """{sid: chained fp} for every non-input stage, in schedule order.

    ``salt`` carries engine configuration that shapes stage OUTPUT layout
    (the partition count: restored partition sets must co-partition with
    re-executed join sides), so a config change invalidates checkpoints.
    """
    from .graph import GInput, GMap, GReduce, GSink

    src_fp = {}
    out = {}
    _tls.cache = {}  # one content hash per distinct captured array
    try:
        for sid, stage in enumerate(graph.stages):
            if isinstance(stage, GInput):
                src_fp[stage.output] = _h(
                    "tap-salted", salt, _fp_tap(stage.tap))
                continue
            inputs = tuple(src_fp.get(s, "missing") for s in stage.inputs)
            if isinstance(stage, GMap):
                # the port's map stages carry no shuffler: None, as the
                # JAX package's do but where one was set
                body = ("map", _fp(stage.mapper), _fp(stage.combiner),
                        _fp(getattr(stage, "shuffler", None)))
            elif isinstance(stage, GReduce):
                body = ("reduce", _fp(stage.reducer))
            elif isinstance(stage, GSink):
                body = ("sink", _fp(stage.sinker), stage.path)
            else:
                body = ("other", _fp(stage))
            opts = _fp(getattr(stage, "options", None) or {})
            # _h propagates volatility: any volatile part (inputs, opts,
            # body fps) makes the combination volatile.
            fp = _h("stage", sid, body, opts, inputs)
            src_fp[stage.output] = fp
            out[sid] = fp
    finally:
        _tls.cache = None
    return out


# -- manifests ---------------------------------------------------------------

def _manifest_dir(root):
    return os.path.join(root, "manifest")


def _manifest_path(root, sid):
    return os.path.join(_manifest_dir(root), "stage_{}.json".format(sid))


def _ensure_on_disk(ref, directory, pool=None):
    """Return a durable file path holding this ref's block, scheduling a
    write if the block only lives in RAM.  Resident blocks KEEP their RAM
    copy (the next stage reads hot); BlockRef.spill() skips rewriting refs
    that already have a path, so persisted blocks spill for free later.

    With ``pool`` (the store's background spill writer) the write enqueues
    — checkpoint persistence of a wide stage runs its codec+disk across
    the writer threads — and the returned path is the write's target;
    the caller MUST ``drain_writes()`` before referencing it in a
    manifest (fsync + rename happen inside the pool, so a drained
    manifest never points at a half-written file)."""
    from .storage import _spill_codec, save_block

    if ref.pin:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, uuid.uuid4().hex + ".blk")
        with open(path, "wb") as f:
            f.write(ref._packed)  # gzip'd single-window stream: the spill
            # wire format readers already sniff and stream
        return path, ref.nbytes
    if ref.path is None:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, uuid.uuid4().hex + ".blk")
        # get() covers every residency: RAM blocks return as-is;
        # device-resident refs materialize via one counted value-lane
        # fetch on this thread (it waits on the lanes' ready event; the
        # device copy stays live for the consuming reduce).
        blk = ref.get()
        if pool is not None:
            pool.submit(ref, blk, path,
                        _spill_codec(ref.key_dtype, ref.value_dtype),
                        clear_block=False)
        else:
            from . import faults as _faults

            def write_once():
                _faults.check("checkpoint_persist")
                save_block(blk, path)

            # Transient-retry like every other spill write ("wb"
            # truncates: idempotent).
            _faults.retry_io(write_once, "checkpoint_persist")
            ref.path = path
        return path, blk.nbytes()
    return ref.path, ref.nbytes


def persist_stage(store, sid, fp, result, nrec):
    """Write the stage's blocks to disk + an atomic manifest.  Volatile
    stages persist nothing (they can never be resumed)."""
    from .runner import _SinkOutput
    from .storage import PartitionSet

    from .obs import trace as _trace

    if is_volatile(fp):
        _trace.instant("checkpoint", "skip-volatile", stage=sid)
        return
    _t0 = _trace.now()
    root = store.root
    if isinstance(result, _SinkOutput):
        manifest = {"fp": fp, "kind": "sink", "paths": result.paths,
                    "nrec": nrec}
    elif isinstance(result, PartitionSet):
        directory = os.path.join(root, "ckpt", "stage_{}".format(sid))
        blocks = []
        # Unwritten blocks fan out across the store's background writer
        # pool; the drain below is the durability barrier — the manifest
        # lands only after every referenced file has been fsync'd and
        # renamed into place, so a crash between the two leaves a
        # restorable previous manifest, never a dangling one.
        pool = store.writer_pool()
        for pid in sorted(result.parts):
            for ref in result.parts[pid]:
                path, nbytes = _ensure_on_disk(ref, directory, pool)
                blocks.append([pid, os.path.relpath(path, root),
                               ref.nrecords, int(nbytes),
                               str(ref.key_dtype), str(ref.value_dtype)])
        store.drain_writes()
        manifest = {"fp": fp, "kind": "pset",
                    "n_partitions": result.n_partitions,
                    "blocks": blocks, "nrec": nrec,
                    # provenance flags survive the round-trip so a resumed
                    # output keeps its fast read/alias paths
                    "flags": [bool(result.hash_routed),
                              bool(result.hash_sorted),
                              bool(result.key_sorted_runs)]}
    else:  # raw tap handles pass through _run untouched; nothing to persist
        return
    old_paths = _manifest_files(root, sid)
    os.makedirs(_manifest_dir(root), exist_ok=True)
    tmp = _manifest_path(root, sid) + ".tmp"

    def write_manifest():
        from . import faults as _faults

        _faults.check("checkpoint_persist")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, _manifest_path(root, sid))

    from . import faults as _faults

    # tmp -> atomic replace: a transient failure (or injected
    # ``checkpoint_persist`` fault) retries in place; a crash between
    # retries leaves the previous manifest restorable, never a dangler.
    _faults.retry_io(write_manifest, "checkpoint_persist")
    _prune(root, old_paths)
    _trace.complete("checkpoint", "persist", _t0, stage=sid,
                    records=nrec, kind=manifest["kind"])


def _manifest_files(root, sid):
    """Absolute block/part paths referenced by stage sid's manifest ({} if
    none)."""
    try:
        with open(_manifest_path(root, sid)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return set()
    if m.get("kind") == "sink":
        return set(m.get("paths", ()))
    return set(os.path.join(root, b[1]) for b in m.get("blocks", ()))


def _live_paths(root):
    """Absolute paths of every file referenced by any current manifest."""
    live = set()
    mdir = _manifest_dir(root)
    if os.path.isdir(mdir):
        for name in os.listdir(mdir):
            if name.startswith("stage_") and name.endswith(".json"):
                sid = name[len("stage_"):-len(".json")]
                if sid.isdigit():
                    live |= set(map(os.path.abspath,
                                    _manifest_files(root, int(sid))))
    return live


def _prune(root, candidates):
    """Delete superseded checkpoint files: ``candidates`` (the replaced
    manifest's files) minus every path still referenced by any current
    manifest.  Keeps edit-rerun cycles at one retained copy per stage
    instead of one per edit.  Only paths under ``root`` are touched
    (sink part files live in user directories and are never pruned)."""
    if not candidates:
        return
    rootp = os.path.join(os.path.abspath(root), "")
    live = _live_paths(root)
    for path in candidates:
        path = os.path.abspath(path)
        if path not in live and path.startswith(rootp):
            try:
                os.unlink(path)
            except OSError:
                pass


class RunGuard(object):
    """Advisory liveness lock for a named scratch root.  Every resumable
    run holds a SHARED flock on ``<root>/.run.lock`` for its duration; the
    start-of-run GC sweep only fires when an EXCLUSIVE probe succeeds —
    i.e. no other live process is mid-run under this name, so no in-flight
    (not-yet-manifested) spill blocks can be swept.  flock releases on
    process death, so a crashed run never wedges the GC forever."""

    def __init__(self, root):
        import errno
        import fcntl
        os.makedirs(root, exist_ok=True)
        self._fcntl = fcntl
        self._fd = os.open(os.path.join(root, ".run.lock"),
                           os.O_CREAT | os.O_RDWR, 0o644)
        self.exclusive = False
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            self.exclusive = True
        except OSError as e:
            if e.errno in (errno.EWOULDBLOCK, errno.EAGAIN):
                # Another live run holds the lock: join it shared.
                fcntl.flock(self._fd, fcntl.LOCK_SH)
            else:
                # Filesystem without flock support (NFS sans lockd,
                # some container mounts): degrade to no-GC rather than
                # fail the run — locking is an optimization guard, not
                # a correctness requirement for a single process.
                log.warning("flock unsupported on %s (%s): skipping "
                            "start-of-run GC", root, e)
                os.close(self._fd)
                self._fd = None

    def share(self):
        """Downgrade to shared so later runs can probe while we execute."""
        if self.exclusive and self._fd is not None:
            self._fcntl.flock(self._fd, self._fcntl.LOCK_SH)
            self.exclusive = False

    def close(self):
        if self._fd is not None:
            try:
                self._fcntl.flock(self._fd, self._fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None


def gc_unreferenced(root):
    """Delete ``.blk`` files under ``root`` not referenced by any current
    manifest.  Called at run START (nothing in flight): volatile stages —
    including a pipeline's FINAL output when its fingerprint is volatile —
    persist no manifest, so their spilled blocks from previous runs are
    unreachable garbage; without this sweep the named scratch root grows
    without bound across reruns.

    Contract (documented on ``run``): starting a new run under a name
    invalidates any still-unread OutputDataset from a PREVIOUS run of
    that name whose final stage was volatile — its backing blocks are
    exactly the unreachable files this sweep removes."""
    if not os.path.isdir(root):
        return
    live = _live_paths(root)
    n = 0
    swept = []
    for d, _dirs, fs in os.walk(root):
        for f in fs:
            if not f.endswith(".blk"):
                continue
            path = os.path.join(d, f)
            if os.path.abspath(path) not in live:
                try:
                    os.unlink(path)
                    n += 1
                    if len(swept) < 20:
                        swept.append(path)
                except OSError:
                    pass
    if n:
        # WARNING level with the paths: the run-then-stream-lazily pattern
        # (holding an unread OutputDataset from a previous volatile-tailed
        # run of this name) loses exactly these files — make the loss
        # visible and attributable, not silent.
        log.warning(
            "resume gc: removed %d unreferenced block file(s) under %s "
            "(previous runs' unread volatile outputs are invalidated): %s%s",
            n, root, ", ".join(swept), "…" if n > len(swept) else "")


def load_plan(root, fps):
    """{sid: manifest} for every stage whose manifest exists, fingerprint-
    matches this graph, and whose referenced files all still exist."""
    plan = {}
    for sid, fp in fps.items():
        if is_volatile(fp):
            continue
        mpath = _manifest_path(root, sid)
        if not os.path.exists(mpath):
            continue
        try:
            with open(mpath) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if m.get("fp") != fp:
            continue
        if m["kind"] == "sink":
            paths = m["paths"]
        else:
            paths = [os.path.join(root, b[1]) for b in m["blocks"]]
        if not all(os.path.exists(p) for p in paths):
            continue
        plan[sid] = m
    from .obs import trace as _trace

    _trace.instant("checkpoint", "plan", restorable=len(plan),
                   stages=len(fps))
    return plan


def restore_stage(root, manifest):
    """Rebuild the stage output (PartitionSet or _SinkOutput) from its
    manifest.  Returns (result, nrec)."""
    from .obs import trace as _trace
    from .runner import _SinkOutput
    from .storage import BlockRef, PartitionSet

    _t0 = _trace.now()
    if manifest["kind"] == "sink":
        _trace.complete("checkpoint", "restore", _t0, kind="sink",
                        records=manifest["nrec"])
        return _SinkOutput(manifest["paths"]), manifest["nrec"]
    flags = manifest.get("flags", [False, False, False])
    pset = PartitionSet(manifest["n_partitions"], hash_routed=flags[0],
                        hash_sorted=flags[1], key_sorted_runs=flags[2])
    for pid, rel, nrecords, nbytes, kdt, vdt in manifest["blocks"]:
        pset.add(pid, BlockRef.from_disk(
            os.path.join(root, rel), nrecords, nbytes, kdt, vdt))
    _trace.complete("checkpoint", "restore", _t0, kind="pset",
                    records=manifest["nrec"],
                    blocks=len(manifest["blocks"]))
    return pset, manifest["nrec"]
