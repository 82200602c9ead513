"""The cross-run materialization cache: shared-prefix reuse and
incremental recompute over appended corpora.

Port of ``dampr_tpu/plan/reuse.py``, whole.  :mod:`..resume` restores
checkpoints within one named run; this module keeps a **shared,
content-addressed cache across runs**: every non-volatile stage output
may publish into a store under the scratch root keyed by the chained
fingerprint of its whole producing prefix (stage structure chained
through the DAG as resume's fingerprints are, with the inputs' *content
signatures*, chunked sha1 over the file bytes, in place of resume's stat
identity), so the same corpus reached through another copy, run name or
process still hits.

Two reuse modes, decided per stage before the run executes:

- **full hit**: the stage's content key has a published entry; its
  partition frames are hardlinked into the run's own scratch (a
  concurrent eviction can never remove a file mid-read) and mounted in
  place of executing the stage and its whole upstream prefix.  A mounted
  output is host frames: a fold planned to take its producer's counts on
  the device (a ``handoff`` edge) reads them through its host path.
- **incremental**: no full hit, but an entry for the same *structural*
  key (same pipeline, other input content) whose input signature is an
  append-only prefix of the current one.  The stage re-runs over the new
  files alone and its fresh partials (device refs where the edge is a
  handoff) union with the cached ones (host frames), only where the merge
  is provably exact (:func:`incremental_eligible`).

Exactness: cached, incremental and cold runs give equal results;
volatile stages (DTA402) never cache; a corrupt or truncated entry (the
``cache_read`` fault site) degrades to recompute, counted in
``stats()["reuse"]["recompute_fallbacks"]``; a run under an injected
fault plan, or one that quarantined records, consumes but never
publishes.

A device-resident output publishes through ``resume._ensure_on_disk``:
one counted fetch of its value lane on the stage walk's thread into the
run's own scratch, then a hardlink into the entry, so the entry is never
charged to the run's device budget and the run's store never deletes it.

Concurrency: a publish builds under ``entries/.tmp-*`` and lands with one
atomic directory rename (of two concurrent publishers of a key one wins);
eviction runs under an exclusive flock on ``<cache>/.lock`` (lock-free on
filesystems without flock) and removes whole least recently consumed
entries until the store fits ``settings.reuse_budget_bytes``.
"""

import contextlib
import collections
import errno
import hashlib
import json
import logging
import os
import shutil
import time
import uuid

from .. import faults as _faults
from .. import inputs as _inputs
from .. import resume as _resume
from .. import settings
from ..dataset import Chunker
from ..obs import trace as _trace

log = logging.getLogger("dampr_tpu_torch.plan.reuse")

#: Manifest schema tag; bumped on any incompatible layout change so a
#: newer engine never misreads an older shared cache (unknown schemas
#: read as a miss, not an error).
SCHEMA = "dampr-tpu-reuse/1"


class CacheEntryError(Exception):
    """A cache entry that exists but cannot be trusted (corrupt
    manifest, missing/truncated block, injected ``cache_read`` fault).
    Callers degrade to recompute and count the fallback."""


# ---------------------------------------------------------------------------
# Content signatures
# ---------------------------------------------------------------------------

def _file_chunk_hashes(path, window):
    """sha1 per ``window``-byte span of the file, in order.  The chunk
    list is what makes append-only *within* the signature recognizable
    later without re-reading old bytes' context: a changed early chunk
    changes its hash in place."""
    hashes = []
    with open(path, "rb") as f:
        while True:
            buf = f.read(window)
            if not buf:
                break
            hashes.append(hashlib.sha1(buf).hexdigest())
    if not hashes:  # empty file still needs a stable identity
        hashes.append(hashlib.sha1(b"").hexdigest())
    return hashes


def content_signature(tap):
    """Content signature dict for an input tap, or None when the tap is
    not signable (downstream keys then go volatile: never cached).

    Path taps hash every file's bytes in ``settings.reuse_chunk_bytes``
    windows — unlike resume's stat identity this is stable across
    copies and mtime churn.  Memory taps reuse the structural
    fingerprint of their items (content-addressed already)."""
    path = getattr(tap, "path", None)
    if isinstance(path, str):
        window = max(1 << 16, int(settings.reuse_chunk_bytes))
        files = []
        for p, size in sorted(_inputs.iter_files(path)):
            files.append([p, int(size), _file_chunk_hashes(p, window)])
        return {"kind": "path",
                "chunk_size": int(getattr(tap, "chunk_size", 0) or 0),
                "chunk_bytes": window,
                "files": files}
    items = getattr(tap, "items", None)
    if items is not None:
        return {"kind": "mem", "fp": _resume._fp(items),
                "partitions": int(getattr(tap, "partitions", 0) or 0)}
    return None


def signature_digest(sig):
    """One chained-fingerprint part summarizing a signature.  Paths are
    deliberately EXCLUDED for path taps: file order and bytes decide
    record content (keys are file-relative offsets), so the same corpus
    under a renamed directory still hits.  ``chunk_size`` stays in —
    it shapes combiner chunking, hence partial-fold block content."""
    if sig is None:
        return _resume._volatile()
    if sig.get("kind") == "path":
        return _resume._h(
            "sig-path", sig["chunk_size"],
            tuple((int(size), tuple(hashes))
                  for _p, size, hashes in sig["files"]))
    if sig.get("kind") == "mem":
        return _resume._h("sig-mem", sig["fp"], sig["partitions"])
    return _resume._volatile()


def signature_delta(cached, current):
    """Whole-new-files delta between two path signatures.

    Returns ``[(path, size), ...]`` — the files in ``current`` with no
    byte-identical counterpart in ``cached`` — ONLY when every cached
    file survives unchanged (matched as a multiset of (size, chunk
    hashes), so renames still count as unchanged).  Returns None when
    the growth is not append-only: a cached file that grew, shrank,
    changed, or vanished forces full recompute — a grown text file is
    never safe to re-chunk incrementally, because the old final chunk's
    line-boundary contract would make it read INTO the appended bytes.
    """
    if not cached or not current:
        return None
    if cached.get("kind") != "path" or current.get("kind") != "path":
        return None
    if cached.get("chunk_size") != current.get("chunk_size"):
        return None
    if cached.get("chunk_bytes") != current.get("chunk_bytes"):
        return None
    pool = collections.Counter(
        (int(size), tuple(hashes)) for _p, size, hashes in cached["files"])
    new = []
    for p, size, hashes in current["files"]:
        ident = (int(size), tuple(hashes))
        if pool.get(ident):
            pool[ident] -= 1
        else:
            new.append((p, int(size)))
    if any(v > 0 for v in pool.values()):
        return None  # a cached file changed or vanished: not append-only
    return new


class DeltaTap(Chunker):
    """The append-only remainder of a path tap: chunk plans for just the
    new files, with the original tap's chunk size — per-file planning
    means these chunks are bit-for-bit the chunks a cold run over the
    grown corpus would plan for the same files."""

    def __init__(self, files, chunk_size):
        self.files = list(files)
        self.chunk_size = int(chunk_size) or 64 * 1024 ** 2

    def chunks(self):
        for path, size in self.files:
            for spec in _inputs.plan_file(path, size, self.chunk_size):
                yield _inputs._spec_dataset(spec)

    def __repr__(self):
        return "DeltaTap[{} file(s)]".format(len(self.files))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def reuse_keys(graph, salt=""):
    """``(keys, structs, sigs)`` for a graph.

    - ``keys[sid]`` — content-addressed chained key: stage body + options
      + input *content* keys, volatility propagating exactly like resume
      fingerprints.  Equal keys mean byte-equal computation.
    - ``structs[sid]`` — the same chain minus input content (tap type +
      chunk config only): equal structs with different keys mean "same
      pipeline, different data" — the incremental-candidate relation.
    - ``sigs[source]`` — the content signature per input tap source
      (None when unsignable), kept for delta detection and manifests.

    ``salt`` carries engine config shaping output layout (the partition
    count), like resume's — a cached partition set must co-partition
    with whatever consumes it."""
    from ..graph import GInput, GMap, GReduce, GSink

    keys, structs, sigs = {}, {}, {}
    src_key, src_struct = {}, {}
    _resume._tls.cache = {}  # one content hash per captured array per pass
    try:
        for sid, stage in enumerate(graph.stages):
            if isinstance(stage, GInput):
                sig = None
                try:
                    sig = content_signature(stage.tap)
                except Exception:
                    log.warning(
                        "reuse: tap %r not signable; downstream stages "
                        "are volatile for the cache",
                        type(stage.tap).__qualname__, exc_info=True)
                sigs[stage.output] = sig
                src_key[stage.output] = _resume._h(
                    "rtap", salt, signature_digest(sig))
                src_struct[stage.output] = (
                    _resume._volatile() if sig is None else _resume._h(
                        "rtap-struct", salt, type(stage.tap).__qualname__,
                        sig.get("chunk_size", sig.get("partitions", 0))))
                continue
            inputs_k = tuple(src_key.get(s, "missing") for s in stage.inputs)
            inputs_s = tuple(
                src_struct.get(s, "missing") for s in stage.inputs)
            if isinstance(stage, GMap):
                # the port's map stages carry no shuffler: None, as the
                # JAX package's do where none was set
                body = ("map", _resume._fp(stage.mapper),
                        _resume._fp(stage.combiner),
                        _resume._fp(getattr(stage, "shuffler", None)))
            elif isinstance(stage, GReduce):
                body = ("reduce", _resume._fp(stage.reducer))
            elif isinstance(stage, GSink):
                body = ("sink", _resume._fp(stage.sinker), stage.path)
            else:
                body = ("other", _resume._fp(stage))
            opts = _resume._fp(getattr(stage, "options", None) or {})
            # No sid in the chain (unlike resume): the chain is already
            # injective through its inputs, and position-independence is
            # what lets a shared prefix hit from a DIFFERENT pipeline.
            k = _resume._h("rstage", body, opts, inputs_k)
            s = _resume._h("rstruct", body, opts, inputs_s)
            src_key[stage.output] = k
            src_struct[stage.output] = s
            keys[sid] = k
            structs[sid] = s
    finally:
        _resume._tls.cache = None
    return keys, structs, sigs


# ---------------------------------------------------------------------------
# The shared store
# ---------------------------------------------------------------------------

def _checked_read(fn):
    """Run one cache read under the ``cache_read`` fault site.  IO
    errors and injected transient/deterministic faults surface as
    :class:`CacheEntryError` (degrade to recompute); fatal injections
    propagate — no retry layer may absorb them."""
    try:
        _faults.check("cache_read")
        return fn()
    except _faults.FatalInjectedFault:
        raise
    except (OSError, ValueError, KeyError, IndexError, TypeError,
            _faults.InjectedFault) as e:
        raise CacheEntryError("{}: {}".format(type(e).__name__, e))


def _dir_bytes(path):
    total = 0
    for d, _dirs, fs in os.walk(path):
        for f in fs:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


class CacheStore(object):
    """The on-disk shared cache: ``<root>/entries/<key>/`` holds one
    manifest.json plus that entry's block files (spill wire format —
    readers sniff, so hardlinked spill files and freshly written frames
    coexist)."""

    def __init__(self, root=None, budget=None):
        if root is None:
            root = settings.reuse_dir or os.path.join(
                settings.scratch_root, "reuse-cache")
        self.root = root
        self.budget = (settings.reuse_budget_bytes
                       if budget is None else budget)
        self.evictions = 0

    def _entries_dir(self):
        return os.path.join(self.root, "entries")

    def _entry_dir(self, key):
        return os.path.join(self._entries_dir(), key)

    def _manifest_path(self, key):
        return os.path.join(self._entry_dir(key), "manifest.json")

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive flock over the whole store (publish landing +
        eviction).  Filesystems without flock degrade to lock-free —
        same rationale as resume.RunGuard: locking guards an
        optimization (space accounting), never correctness, because
        consumers hardlink before reading."""
        import fcntl

        os.makedirs(self.root, exist_ok=True)
        fd = os.open(os.path.join(self.root, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        locked = False
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                locked = True
            except OSError:
                pass
            yield
        finally:
            try:
                if locked:
                    fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    def lookup(self, key):
        """Validated manifest for ``key``: None = clean miss;
        :class:`CacheEntryError` = entry present but untrustworthy
        (caller records a recompute fallback).  Every block must exist
        at exactly its recorded file size — the truncation check that
        turns a half-evicted or corrupted entry into a fallback instead
        of a bad read.  A successful lookup touches the manifest mtime:
        the store's LRU clock."""
        if _resume.is_volatile(key):
            return None
        mpath = self._manifest_path(key)
        if not os.path.exists(mpath):
            return None

        def read_manifest():
            with open(mpath) as f:
                return json.load(f)

        m = _checked_read(read_manifest)
        if (not isinstance(m, dict) or m.get("schema") != SCHEMA
                or m.get("kind") != "pset" or m.get("key") != key):
            raise CacheEntryError("bad manifest for {}".format(key))
        edir = self._entry_dir(key)
        for b in m.get("blocks", ()):
            bpath = os.path.join(edir, b[1])
            try:
                fsize = os.path.getsize(bpath)
            except OSError:
                raise CacheEntryError("missing block {}".format(b[1]))
            if len(b) > 6 and b[6] and fsize != int(b[6]):
                raise CacheEntryError(
                    "truncated block {} ({} != {} bytes)".format(
                        b[1], fsize, b[6]))
        try:
            os.utime(mpath)
        except OSError:
            pass
        return m

    def lookup_struct(self, struct):
        """Newest entry sharing a *structural* key (same pipeline over
        different data) with a path-kind signature — the incremental
        candidate.  Best-effort scan; unreadable entries are skipped."""
        if _resume.is_volatile(struct):
            return None
        try:
            names = os.listdir(self._entries_dir())
        except OSError:
            return None
        best = None
        for name in names:
            if name.startswith(".tmp-"):
                continue
            try:
                with open(os.path.join(
                        self._entries_dir(), name, "manifest.json")) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            if (not isinstance(m, dict) or m.get("schema") != SCHEMA
                    or m.get("struct") != struct):
                continue
            if (m.get("sig") or {}).get("kind") != "path":
                continue
            if best is None or m.get("created", 0) > best.get("created", 0):
                best = m
        return best

    def mount(self, manifest, run_store):
        """``(PartitionSet, nrec, bytes)`` backed by hardlinks into the
        RUN's scratch root — eviction (rmtree of the entry) can then
        never yank a file mid-read; the links die with the run's normal
        cleanup.  The ``.rblk`` suffix keeps resume's start-of-run
        ``gc_unreferenced`` sweep (which collects ``.blk`` orphans) off
        them."""
        from ..storage import BlockRef, PartitionSet

        edir = self._entry_dir(manifest["key"])
        mnt = os.path.join(run_store.root, "reuse", uuid.uuid4().hex)
        os.makedirs(mnt, exist_ok=True)
        flags = manifest.get("flags") or [False, False, False]
        pset = PartitionSet(manifest["n_partitions"], hash_routed=flags[0],
                            hash_sorted=flags[1], key_sorted_runs=flags[2])
        total = 0
        try:
            for i, b in enumerate(manifest["blocks"]):
                pid, fname, nrecords, nbytes, kdt, vdt = b[:6]
                src = os.path.join(edir, fname)
                dst = os.path.join(mnt, "{}.rblk".format(i))

                def link(src=src, dst=dst):
                    try:
                        os.link(src, dst)
                    except OSError as e:
                        if e.errno != errno.EXDEV:
                            raise
                        shutil.copyfile(src, dst)  # cache on another fs

                _checked_read(link)
                pset.add(pid, BlockRef.from_disk(
                    dst, nrecords, nbytes, kdt, vdt))
                total += int(b[6]) if len(b) > 6 and b[6] else int(nbytes)
        except BaseException:
            pset.delete()
            shutil.rmtree(mnt, ignore_errors=True)
            raise
        return pset, manifest["nrec"], total

    def publish(self, key, struct, result, nrec, sig, run_store):
        """Publish one stage output under ``key``; returns bytes landed
        (0 = declined, already present, or lost the race).  Blocks
        already on disk hardlink in for free; pinned refs write their
        packed stream; RAM-only blocks encode through the spill codec.
        The entry builds in a ``.tmp-`` sibling and lands with ONE
        atomic rename, so a reader can never observe a half-entry and
        concurrent publishers of the same key resolve to exactly one
        winner."""
        from ..storage import PartitionSet, save_block

        if _resume.is_volatile(key) or not isinstance(result, PartitionSet):
            return 0
        if os.path.exists(self._manifest_path(key)):
            return 0  # already published (this run or a sibling)
        tmp = os.path.join(self._entries_dir(), ".tmp-" + uuid.uuid4().hex)
        os.makedirs(tmp)
        t0 = _trace.now()
        try:
            blocks = []
            total = 0
            i = 0
            for pid in sorted(result.parts):
                for ref in result.parts[pid]:
                    fname = "b{}.frames".format(i)
                    i += 1
                    path = os.path.join(tmp, fname)
                    if ref.pin:
                        with open(path, "wb") as f:
                            f.write(ref._packed)
                    elif ref.path is not None or ref.is_device:
                        src_path = ref.path
                        if src_path is None:
                            # a device ref lands in the run's scratch
                            # through the checkpoint path (one counted
                            # value-lane fetch after its ready event);
                            # the entry takes a hardlink, so the run's
                            # store deletes its own file and never the
                            # entry's, and no device byte is charged
                            src_path, _n = _resume._ensure_on_disk(
                                ref, os.path.join(run_store.root,
                                                  "reuse-publish"))
                        try:
                            os.link(src_path, path)
                        except OSError:
                            shutil.copyfile(src_path, path)
                    else:
                        # a RAM block encodes into the entry; ref.path
                        # stays unset, so the run's store neither charges
                        # nor deletes the cache's copy
                        save_block(ref.get(), path)
                    fsize = os.path.getsize(path)
                    total += fsize
                    blocks.append([pid, fname, ref.nrecords,
                                   int(ref.nbytes), str(ref.key_dtype),
                                   str(ref.value_dtype), int(fsize)])
            if self.budget and total > self.budget:
                shutil.rmtree(tmp, ignore_errors=True)
                return 0  # one entry over the whole budget: never fits
            manifest = {"schema": SCHEMA, "key": key, "struct": struct,
                        "kind": "pset",
                        "n_partitions": result.n_partitions,
                        "blocks": blocks, "nrec": int(nrec),
                        "flags": [bool(result.hash_routed),
                                  bool(result.hash_sorted),
                                  bool(result.key_sorted_runs)],
                        "bytes": int(total), "sig": sig,
                        "created": time.time()}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with self._locked():
                try:
                    os.rename(tmp, self._entry_dir(key))
                except OSError:
                    # Concurrent publisher won the rename: their entry
                    # is byte-equivalent by construction (same key).
                    shutil.rmtree(tmp, ignore_errors=True)
                    return 0
                self.evict_to_budget(locked=True)
            _trace.complete("reuse", "publish", t0, bytes=total,
                            blocks=len(blocks))
            return total
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def evict_to_budget(self, locked=False):
        """Remove least-recently-consumed whole entries until the store
        fits the byte budget; ``(entries_evicted, bytes_freed)``.  The
        LRU clock is the manifest mtime (touched by every successful
        lookup).  Unreadable/half-built entries sort oldest — they are
        garbage either way."""
        if not locked:
            with self._locked():
                return self.evict_to_budget(locked=True)
        ed = self._entries_dir()
        try:
            names = os.listdir(ed)
        except OSError:
            return 0, 0
        entries = []
        total = 0
        for name in names:
            if name.startswith(".tmp-"):
                continue
            mpath = os.path.join(ed, name, "manifest.json")
            try:
                mtime = os.stat(mpath).st_mtime
                with open(mpath) as f:
                    nbytes = int(json.load(f).get("bytes") or 0)
            except (OSError, ValueError):
                mtime, nbytes = 0.0, _dir_bytes(os.path.join(ed, name))
            entries.append((mtime, name, nbytes))
            total += nbytes
        n = freed = 0
        if self.budget:
            entries.sort()
            for _mtime, name, nbytes in entries:
                if total - freed <= self.budget:
                    break
                shutil.rmtree(os.path.join(ed, name), ignore_errors=True)
                freed += nbytes
                n += 1
        if n:
            self.evictions += n
            _trace.instant("reuse", "evict", entries=n, bytes=freed)
            log.info("reuse cache evicted %d entr%s (%d bytes) to fit "
                     "budget %d", n, "y" if n == 1 else "ies", freed,
                     self.budget)
        return n, freed

    def total_bytes(self):
        try:
            names = os.listdir(self._entries_dir())
        except OSError:
            return 0
        total = 0
        for name in names:
            mpath = os.path.join(self._entries_dir(), name, "manifest.json")
            try:
                with open(mpath) as f:
                    total += int(json.load(f).get("bytes") or 0)
            except (OSError, ValueError):
                pass
        return total


def union_psets(a, b):
    """One PartitionSet holding both sides' refs per partition.
    Provenance flags AND together — a downstream fast path may assume
    an invariant only when BOTH sides carry it.  Partition counts must
    match (the structural key salts the partition count, so an
    incremental pair always does)."""
    from ..storage import PartitionSet

    if a.n_partitions != b.n_partitions:
        raise ValueError("partition count mismatch: {} != {}".format(
            a.n_partitions, b.n_partitions))
    out = PartitionSet(
        a.n_partitions,
        hash_routed=bool(a.hash_routed and b.hash_routed),
        hash_sorted=bool(a.hash_sorted and b.hash_sorted),
        key_sorted_runs=bool(a.key_sorted_runs and b.key_sorted_runs))
    for src in (a, b):
        for pid in src.parts:
            for ref in src.parts[pid]:
                out.add(pid, ref)
    return out


# ---------------------------------------------------------------------------
# Incremental-merge eligibility
# ---------------------------------------------------------------------------

def incremental_eligible(graph, sid, manifest, outputs):
    """``(ok, reason)`` — may stage ``sid``'s cached output union with a
    delta re-run over just the new files?

    A map with NO combiner is exact unconditionally: per-file chunk
    planning makes the delta's chunks identical to the cold run's, so
    cached + fresh is the same record multiset, block layout aside.

    A map WITH a combiner produced partition-local *partials* whose
    grouping depends on chunk-to-job assignment; cached + fresh partials
    only converge with the cold run after the downstream fold.  That is
    exact when every consumer is a fold whose binop
    :mod:`~dampr_tpu_torch.analyze.assoc` certifies associative ("yes" tier
    only — the kernel-contract kinds), excluding order-sensitive
    ``first`` and float sums/pair-sums (reordered float addition is not
    byte-identical); and the partials themselves must not be a
    requested output."""
    from ..graph import GInput, GMap, GReduce

    stage = graph.stages[sid]
    if not isinstance(stage, GMap):
        return False, "not-a-map"
    if len(stage.inputs) != 1:
        return False, "multi-input"
    producers = {s.output: s for s in graph.stages}
    if not isinstance(producers.get(stage.inputs[0]), GInput):
        return False, "input-not-a-tap"
    combined = (stage.combiner is not None
                or "binop" in (stage.options or {}))
    if not combined:
        return True, None
    if stage.output in outputs:
        return False, "partials-requested-as-output"
    binops = []
    if "binop" in (stage.options or {}):
        binops.append(stage.options["binop"])
    for consumer in graph.stages:
        if stage.output not in getattr(consumer, "inputs", ()):
            continue
        if not isinstance(consumer, GReduce):
            return False, "partials-consumed-by-non-fold"
        b = (consumer.options or {}).get("binop")
        if b is None:
            return False, "consumer-fold-unrecognized"
        binops.append(b)
    from ..analyze import assoc as _assoc

    vdts = [str(b[5]) for b in manifest.get("blocks", ())]
    for b in binops:
        try:
            v = _assoc.classify_binop(b)
        except Exception:
            return False, "fold-classification-failed"
        if v.get("assoc") != "yes":
            return False, "fold-not-certified-associative"
        if v.get("kind") == "first":
            return False, "first-fold-order-sensitive"
        if (v.get("kind") in ("sum", "pair_sum")
                and any(s.startswith("float") for s in vdts)):
            return False, "float-sum-reorder"
    return True, None


# ---------------------------------------------------------------------------
# The per-run coordinator
# ---------------------------------------------------------------------------

class RunReuse(object):
    """One run's reuse decisions, made eagerly BEFORE the stage walk.

    Mounting happens at plan time: a hit only skips its upstream prefix
    if the mount already succeeded, so a corrupted entry degrades to a
    normal recompute while every input is still scheduled — there is no
    dead-end where the prefix was skipped and the mount then fails.
    ``summary`` is the live dict the runner attaches as
    ``stats()["reuse"]``."""

    def __init__(self, runner, outputs):
        self.runner = runner
        self.cache = CacheStore()
        self.mounted = {}      # sid -> (pset, nrec, manifest)
        self.incremental = {}  # sid -> (pset, nrec, manifest, delta, sig)
        self.published = set()
        self.decisions = {}
        self.summary = {
            "enabled": True,
            "cache_dir": self.cache.root,
            "hits": 0, "misses": 0, "stages_skipped": 0,
            "bytes_mounted": 0, "bytes_published": 0,
            "incremental_merges": 0, "recompute_fallbacks": 0,
            "evictions": 0, "decisions": [],
        }
        salt = "p{}".format(runner.n_partitions)
        self.keys, self.structs, self.sigs = reuse_keys(runner.graph, salt)

    # -- planning ------------------------------------------------------------

    def plan(self, outputs, satisfied=()):
        """Decide hit / incremental / miss per needed stage, deepest
        first — a hit prices and mounts immediately; its whole prefix
        then drops out of the need-set.  ``satisfied`` carries resume's
        restorable checkpoint sids (a same-run checkpoint restore beats
        a cache mount: it is local and already validated)."""
        from ..graph import GInput, GSink

        graph = self.runner.graph
        t0 = _trace.now()
        hist = self._history_seconds()
        needed = set(outputs)
        for sid in range(len(graph.stages) - 1, -1, -1):
            stage = graph.stages[sid]
            if isinstance(stage, GInput):
                continue
            if stage.output not in needed and not isinstance(stage, GSink):
                continue
            if sid in satisfied:
                self.decisions[sid] = "resume-restored"
                continue
            if isinstance(stage, GSink):
                # Sink outputs are durable user files, not partition
                # frames: never cached, inputs always needed.
                needed.update(stage.inputs)
                continue
            key = self.keys.get(sid)
            if key is None or _resume.is_volatile(key):
                self.decisions[sid] = "volatile"
                needed.update(stage.inputs)
                continue
            if self._try_hit(sid, stage, key, hist):
                continue  # mounted: prefix not needed
            if self._try_incremental(sid, stage, outputs):
                continue  # delta re-run reads only its tap
            self.decisions.setdefault(sid, "miss")
            needed.update(stage.inputs)
        self.summary["decisions"] = self._decisions_list()
        rep = self.runner.plan_report
        if isinstance(rep, dict):
            # The plan report's reuse section: what explain() renders.
            rep["reuse"] = {"cache_dir": self.cache.root,
                            "decisions": self._decisions_list()}
        _trace.complete(
            "reuse", "plan", t0, hits=self.summary["hits"],
            incremental=len(self.incremental),
            fallbacks=self.summary["recompute_fallbacks"])

    def _try_hit(self, sid, stage, key, hist):
        try:
            m = self.cache.lookup(key)
        except CacheEntryError as e:
            self.summary["recompute_fallbacks"] += 1
            self.decisions[sid] = "fallback:" + str(e)[:120]
            return False
        if m is None:
            self.summary["misses"] += 1
            return False
        if not self._worth_mounting(sid, m, hist):
            self.decisions[sid] = "recompute-cheaper"
            return False
        try:
            pset, nrec, nbytes = self.cache.mount(m, self.runner.store)
        except CacheEntryError as e:
            self.summary["recompute_fallbacks"] += 1
            self.decisions[sid] = "fallback:" + str(e)[:120]
            return False
        self.mounted[sid] = (pset, nrec, m)
        self.summary["hits"] += 1
        self.summary["bytes_mounted"] += nbytes
        self.decisions[sid] = "hit"
        return True

    def _try_incremental(self, sid, stage, outputs):
        if len(stage.inputs) != 1:
            return False
        cur_sig = self.sigs.get(stage.inputs[0])
        if cur_sig is None or cur_sig.get("kind") != "path":
            return False
        struct = self.structs.get(sid)
        m = self.cache.lookup_struct(struct)
        if m is None or m.get("key") == self.keys.get(sid):
            return False
        delta = signature_delta(m.get("sig"), cur_sig)
        if not delta:
            self.decisions[sid] = "incremental-ineligible:not-append-only"
            return False
        ok, reason = incremental_eligible(
            self.runner.graph, sid, m, outputs)
        if not ok:
            self.decisions[sid] = "incremental-ineligible:" + reason
            return False
        try:
            valid = self.cache.lookup(m["key"])
            if valid is None:
                return False
            pset, nrec, nbytes = self.cache.mount(valid, self.runner.store)
        except CacheEntryError as e:
            self.summary["recompute_fallbacks"] += 1
            self.decisions[sid] = "fallback:" + str(e)[:120]
            return False
        self.incremental[sid] = (pset, nrec, m, delta, cur_sig)
        self.summary["bytes_mounted"] += nbytes
        self.decisions[sid] = "incremental:{}-new-file(s)".format(len(delta))
        return True

    # -- pricing -------------------------------------------------------------

    def _history_seconds(self):
        """{sid: measured seconds} from the shape-matched run-history
        corpus; empty when no usable evidence exists (mounting is then
        the default — hardlinks are near-free)."""
        try:
            from . import cost as _cost

            hist = _cost.matched_history(self.runner.name,
                                         self.runner.graph)
            if not hist:
                return {}
            return {int(st["stage"]): float(st.get("seconds") or 0.0)
                    for st in hist.get("stages") or ()
                    if st.get("stage") is not None}
        except Exception:
            return {}

    def _worth_mounting(self, sid, manifest, hist):
        """Mount unless the corpus proves recomputing the whole prefix
        is cheaper than reading the cached bytes back (tiny stages over
        fast recompute paths).  Mount cost model: per-block open/link
        overhead + bytes at disk stream rate."""
        if not hist:
            return True
        mount_cost = (0.002 * len(manifest.get("blocks") or ())
                      + (manifest.get("bytes") or 0) / 2e9)
        graph = self.runner.graph
        producers = {s.output: i for i, s in enumerate(graph.stages)}
        seen, stack, prefix_cost = set(), [sid], 0.0
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            prefix_cost += hist.get(s, 0.0)
            for inp in graph.stages[s].inputs:
                p = producers.get(inp)
                if p is not None:
                    stack.append(p)
        return mount_cost < prefix_cost + 0.05

    # -- the stage walk's hooks ----------------------------------------------

    def handles(self, sid):
        return sid in self.mounted or sid in self.incremental

    def apply(self, sid, stage, env):
        """Produce the stage result without full execution: install the
        mounted frames, or run the delta and union.  Returns ``(result,
        nrec, kind)`` with kind "reused" | "incremental"."""
        t0 = _trace.now()
        if sid in self.mounted:
            pset, nrec, m = self.mounted.pop(sid)
            self.summary["stages_skipped"] += 1
            _trace.complete("reuse", "mount:s{}".format(sid), t0,
                            blocks=len(m.get("blocks", ())), records=nrec)
            return pset, nrec, "reused"
        pset, nrec, m, delta, cur_sig = self.incremental.pop(sid)
        denv = {stage.inputs[0]: DeltaTap(
            delta, cur_sig.get("chunk_size") or 0)}
        try:
            fresh, fresh_nrec, _njobs = self.runner.run_map(
                sid, stage, denv)
        except BaseException:
            # The mounted half must not leak its scratch hardlinks when
            # the delta re-run fails and the stage recomputes in full.
            try:
                pset.delete(self.runner.store)
            except Exception:
                log.warning("reuse: mounted pset cleanup failed",
                            exc_info=True)
            raise
        merged = union_psets(pset, fresh)
        total = int(nrec) + int(fresh_nrec)
        self.summary["incremental_merges"] += 1
        _trace.complete("reuse", "incremental:s{}".format(sid), t0,
                        new_files=len(delta), cached_records=nrec,
                        fresh_records=fresh_nrec)
        # The merged output IS this run's full-key materialization:
        # publish it so the next identical run takes the full-hit path.
        self.maybe_publish(sid, stage, merged, total)
        return merged, total, "incremental"

    def note_fallback(self, sid):
        for table in (self.mounted, self.incremental):
            entry = table.pop(sid, None)
            if entry is not None:
                try:
                    entry[0].delete(self.runner.store)
                except Exception:
                    log.warning("reuse: mounted pset cleanup failed",
                                exc_info=True)
        self.summary["recompute_fallbacks"] += 1
        self.decisions[sid] = "fallback:apply-failed"
        self.summary["decisions"] = self._decisions_list()

    def maybe_publish(self, sid, stage, result, nrec):
        """Publish an executed stage's output, unless this run must not
        seed the shared cache: an active injected-fault plan (chaos
        results are for chaos runs) or quarantined records (lossy
        results) both gate publishing off — lookups stay allowed."""
        from ..graph import GSink
        from ..storage import PartitionSet

        if isinstance(stage, GSink) or not isinstance(result, PartitionSet):
            return
        key = self.keys.get(sid)
        if key is None or _resume.is_volatile(key) or key in self.published:
            return
        if _faults.active() is not None:
            return
        q = self.runner._quarantine
        if q is not None and q.count:
            return
        sig = (self.sigs.get(stage.inputs[0])
               if len(stage.inputs) == 1 else None)
        try:
            n = self.cache.publish(key, self.structs.get(sid), result,
                                   nrec, sig, self.runner.store)
        except Exception:
            log.warning("reuse: publish failed for stage %s (run "
                        "unaffected)", sid + 1, exc_info=True)
            return
        self.published.add(key)
        if n:
            self.summary["bytes_published"] += n
        self.summary["evictions"] = self.cache.evictions

    def _decisions_list(self):
        return [{"stage": sid, "decision": d}
                for sid, d in sorted(self.decisions.items())]
