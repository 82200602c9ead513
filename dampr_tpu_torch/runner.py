"""The scheduler: a sequential stage walk, parallel jobs within a stage.

Reduced port of ``dampr_tpu/runner.py``'s ``MTRunner``: ``run_map``,
``run_reduce`` and ``run_sink``, each stage's jobs on a thread pool, each
job with its own clone of the stage's operator (:func:`_clone_op`).

A map stage runs one job per chunk of its first input; its other inputs
(the broadcast side of a cross) reach every job whole, as chunk lists.  A
reduce stage runs one job per partition id, empty ones included, over one
in-memory key-sorted :class:`~.base.GroupedView` per input: folds, user
reducers and the sort-merge joins of co-partitioned inputs.

``run_map`` has the branches of the reference's map job:

- a **device-lowered** scanner stage (``exec_target == "device"``, set by
  :mod:`.plan.lower`) drives the chunk's line-aligned windows through
  :class:`.ops.lower.DeviceTokenFoldSink` — the FNV and segmented-fold
  kernels on ``settings.device``;
- everything else runs on host: ``map_blocks`` scanners, identity block
  pass-through, the **batched record path** (a chain of typed record ops,
  ``base.record_op_chain``, run a batch at a time through each op's
  ``apply_batch``), or the per-record ``mapper.map`` path into blocks.

Either way the job's blocks go through the map-side combine
(``segment.fold_block``) when the stage carries one, then hash
partitioning into the store; a ``cached()`` stage registers them pinned.
``stats()`` (the emitter's ``stats()``) reports the plan (rules fired,
stages before and after fusion, per-stage targets) and, under
``device``, ``device_stages``, ``device_fraction``, the h2d/d2h bytes,
each kernel's launches and the keyed batch ops' device calls
(``keyed``) during the run; every job charges its keyed calls to the
run's store (:mod:`.ops.devtime`), so their copies count in the h2d/d2h
bytes.

Mesh execution, mitigation, faults/resume and quarantine, reuse, the
overlap executor, the observability plane and per-operator profiler, the
certified lane programs, the tiny-input and tiny-fold fast paths, scan
sharing and the out-of-core (over-budget) reduce and join paths are
later slices.
"""

import copy
import itertools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import base, plan, settings, storage
from .blocks import Block, BlockBuilder
from .dataset import BlockDataset, CatDataset, Chunker, Dataset, SinkDataset
from .graph import GInput, GMap, GReduce, GSink
from .ops import devtime
from .ops import fnv as _fnv
from .ops import lower as ops_lower
from .ops import segfold as _segfold
from .ops import segment

log = logging.getLogger("dampr_tpu_torch.runner")

#: Map-side partial blocks merge once this many accumulate.
_PARTIAL_FANIN = 16

#: Every kernel the device path launches, by name.
KERNELS = {"fnv": _fnv.KERNEL, "segfold": _segfold.KERNEL}


def _clone_op(op):
    """The per-job operator instance.  The stateless wrappers share
    themselves (``base._shared_instance_deepcopy``), so user callables
    are not descended into; lifecycle operators (BlockMapper,
    BlockReducer) and unknown user subclasses are deep-copied, so
    concurrent jobs never share their state."""
    return copy.deepcopy(op)


class _OrderKey(object):
    """Total order over record keys: native comparison when the types
    allow it, type name otherwise (mixed-type outputs stay readable)."""

    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        try:
            return bool(self.k < other.k)
        except TypeError:
            return type(self.k).__name__ < type(other.k).__name__


def _record_batches(chunk, B):
    """The chunk's records as parallel ``(keys, values)`` lists of at most
    ``B``: ``read_lists`` where the dataset has it, else slices of
    ``read()``."""
    reader = getattr(chunk, "read_lists", None)
    if reader is not None:
        return reader(B)

    def slices(it=iter(chunk.read())):
        while True:
            ks, vs = [], []
            for k, v in itertools.islice(it, B):
                ks.append(k)
                vs.append(v)
            if not ks:
                return
            yield ks, vs

    return slices()


def _run_record_chain(chain, batches, B, push):
    """Run a record-op chain over ``batches`` through each op's
    ``apply_batch`` and push the survivors as ``B``-record blocks.

    Survivors accumulate across input batches, so a selective filter
    still emits full blocks; a ``FlatMap`` takes its input in slices sized
    to its observed fan-out, so ``B x fan-out`` records never exist at
    once.  Slices keep stream order, so results equal the streamed
    chain's."""
    pk, pv = [], []

    def emit(ks, vs):
        pk.extend(ks)
        pv.extend(vs)
        while len(pk) >= B:
            push(Block.from_lists(pk[:B], pv[:B]))
            del pk[:B]
            del pv[:B]

    def run(ks, vs, start):
        for i in range(start, len(chain)):
            op = chain[i]
            if type(op) is base.FlatMap and len(ks) > 1024:
                n, at, step = len(ks), 0, 1024
                while at < n:
                    took = min(step, n - at)
                    sks, svs = op.apply_batch(ks[at:at + took],
                                              vs[at:at + took])
                    at += took
                    if sks:
                        fan = -(-len(sks) // took)
                        step = max(64, min(B, B // fan))
                        run(sks, svs, i + 1)
                return
            ks, vs = op.apply_batch(ks, vs)
            if not ks:
                return
        emit(ks, vs)

    for ks, vs in batches:
        run(ks, vs, 0)
    if pk:
        push(Block.from_lists(pk, pv))


class OutputDataset(Dataset):
    """Final-output view over a PartitionSet: records in ascending key
    order (one stable argsort of the concatenated output)."""

    def __init__(self, pset, store=None):
        self.pset = pset
        self.store = store

    def read(self):
        blk = Block.concat([r.get() for r in self.pset.all_refs()])
        if not len(blk):
            return iter(())
        try:
            order = np.argsort(blk.keys, kind="stable")
        except TypeError:
            keys = blk.keys
            order = np.asarray(
                sorted(range(len(blk)), key=lambda i: _OrderKey(keys[i])),
                dtype=np.int64)
        return blk.take(order).iter_pairs()

    def delete(self):
        self.pset.delete(self.store)


class _SinkOutput(object):
    """A sink stage's result: its part files."""

    def __init__(self, paths):
        self.paths = paths

    def datasets(self):
        return [SinkDataset(p) for p in self.paths]


class StageStats(object):
    """Per-stage metrics."""

    __slots__ = ("stage_id", "kind", "op", "target", "n_jobs",
                 "records_out", "seconds")

    def __init__(self, stage_id, kind, op, target):
        self.stage_id = stage_id
        self.kind = kind
        self.op = op
        self.target = target
        self.n_jobs = 0
        self.records_out = 0
        self.seconds = 0.0

    def as_dict(self):
        return {"stage": self.stage_id, "kind": self.kind, "op": self.op,
                "target": self.target, "jobs": self.n_jobs,
                "records_out": self.records_out, "seconds": self.seconds}


class MTRunner(object):
    """Sequential stage walk with parallel jobs within each stage."""

    def __init__(self, name, graph, n_maps=None, n_reducers=None,
                 n_partitions=None, memory_budget=None):
        # The device is resolved up front: a run asked to use a card that
        # is absent fails here, before any stage, never on the CPU.
        self.device = settings.resolve_device()
        self.name = name
        self.graph = graph
        self.n_maps = n_maps or settings.max_processes
        self.n_reducers = n_reducers or settings.max_processes
        self.n_partitions = n_partitions or settings.partitions
        self.store = storage.RunStore(name, budget=memory_budget)
        self.stats = []
        self.plan_report = None
        self.run_summary = None
        self._lock = threading.Lock()
        self._device = {"batches": 0, "fallbacks": 0, "stream_seconds": 0.0,
                        "combine_seconds": 0.0,
                        "phases": dict.fromkeys(ops_lower.PHASES, 0.0)}

    # -- helpers -----------------------------------------------------------
    def _pool_map(self, fn, jobs, n_workers):
        """Run ``fn`` over ``jobs`` on a thread pool; every job's
        exception surfaces (results are read in order) and its keyed
        device calls are charged to this run's store."""
        def charged(j):
            with devtime.charging(self.store):
                return fn(j)

        workers = max(1, min(n_workers, len(jobs)))
        if workers == 1:
            return [charged(j) for j in jobs]
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="dampr-job") as pool:
            return list(pool.map(charged, jobs))

    def _as_chunks(self, entry):
        """Stage input -> list of job datasets."""
        if isinstance(entry, storage.PartitionSet):
            ds = [BlockDataset([ref]) for ref in entry.all_refs()]
            return ds if ds else [BlockDataset([])]
        if isinstance(entry, _SinkOutput):
            return entry.datasets()
        if not isinstance(entry, Chunker):
            raise TypeError("unknown stage input {!r}".format(entry))
        chunks = list(entry.chunks())
        return chunks if chunks else [BlockDataset([])]

    def _reduce_consumes(self, output):
        """Does a GReduce consume ``output``?  (Its input must arrive as
        hash-sorted runs.)"""
        return any(isinstance(s, GReduce) and output in s.inputs
                   for s in self.graph.stages)

    def _note_device_sink(self, sink):
        with self._lock:
            dev = self._device
            dev["batches"] += sink.batches
            dev["fallbacks"] += sink.fallbacks
            dev["stream_seconds"] += sink.stream_seconds
            for k, v in sink.seconds.items():
                dev["phases"][k] += v

    # -- map ---------------------------------------------------------------
    def run_map(self, stage_id, stage, env):
        """One job per chunk of the first input; every other input (a
        cross's broadcast side) reaches each job whole, as a chunk list:
        ``mapper.map(chunk, *supplementary)``."""
        entries = [env[s] for s in stage.inputs]
        chunks = self._as_chunks(entries[0])
        supplementary = [self._as_chunks(e) for e in entries[1:]]
        job = self._map_job(stage, supplementary)
        results = self._pool_map(job, chunks, self.n_maps)
        pset = storage.PartitionSet(self.n_partitions)
        for mapping in results:
            for pid, refs in mapping.items():
                for ref in refs:
                    pset.add(pid, ref)
        return pset, pset.total_records(), len(chunks)

    def _map_job(self, stage, supplementary):
        """The per-chunk job closure of one map stage."""
        from .ops.text import _drive_windows

        combine_op = None
        if isinstance(stage.combiner, base.PartialReduceCombiner):
            combine_op = stage.combiner.op
        elif "binop" in stage.options:
            combine_op = segment.as_assoc_op(stage.options["binop"])
        P = self.n_partitions
        B = settings.batch_size
        pin = bool(stage.options.get("memory"))
        feeds_reduce = self._reduce_consumes(stage.output)
        # claims() re-checks the mapper, so a foreign annotation can never
        # dispatch an op the program does not implement.
        dev_lowered = (stage.options.get("exec_target") == "device"
                       and ops_lower.claims(stage.mapper) is not None)
        identity = (type(stage.mapper) is base.Map
                    and stage.mapper.mapper is base._identity)

        def job(chunk):
            mapper = _clone_op(stage.mapper)
            raw, partials = [], []
            combine_s = [0.0]

            def push(blk):
                if blk is None or not len(blk):
                    return
                if combine_op is None:
                    raw.append(blk)
                    return
                t0 = time.perf_counter()
                partials.append(segment.fold_block(blk, combine_op))
                if len(partials) >= _PARTIAL_FANIN:
                    merged = segment.fold_block(Block.concat(partials),
                                                combine_op)
                    del partials[:]
                    partials.append(merged)
                combine_s[0] += time.perf_counter() - t0

            use_blocks = (not supplementary and hasattr(mapper, "map_blocks")
                          and hasattr(chunk, "read_bytes"))
            ident_blocks = (not supplementary and identity
                            and hasattr(chunk, "iter_blocks"))
            chain = (base.record_op_chain(mapper)
                     if not supplementary and not dev_lowered
                     and not use_blocks and not ident_blocks else None)
            if dev_lowered and (hasattr(chunk, "read_bytes")
                                or hasattr(chunk, "iter_byte_blocks")):
                sink = ops_lower.device_window_sink(mapper, self.store)
                try:
                    for blk in _drive_windows(mapper, chunk, sink=sink):
                        push(blk)
                finally:
                    self._note_device_sink(sink)
            elif use_blocks:
                for blk in mapper.map_blocks(chunk):
                    push(blk)
            elif ident_blocks:
                for blk in chunk.iter_blocks():
                    push(blk)
            elif chain is not None:
                _run_record_chain(chain, _record_batches(chunk, B), B, push)
            else:
                builder = BlockBuilder(B)
                for k, v in mapper.map(chunk, *supplementary):
                    push(builder.add(k, v))
                push(builder.flush())

            blocks = raw
            if combine_op is not None and partials:
                t0 = time.perf_counter()
                blocks = [segment.fold_block(Block.concat(partials),
                                             combine_op)]
                combine_s[0] += time.perf_counter() - t0
            with self._lock:
                self._device["combine_seconds"] += combine_s[0]
            out = {}
            for blk in blocks:
                if combine_op is None and feeds_reduce:
                    blk = blk.sort_by_hash()
                for pid, sub in blk.split_by_partition(P).items():
                    out.setdefault(pid, []).append(
                        self.store.register(sub, pin=pin))
            return out

        return job

    # -- reduce ------------------------------------------------------------
    def run_reduce(self, stage_id, stage, env):
        """One job per partition id, empty partitions included (a
        ``StreamReducer`` runs on every one).  Each job hands the reducer
        one in-memory :class:`GroupedView` per input over that partition;
        the inputs are co-partitioned by the same hash and ``P``.  The
        output registers under the job's pid, keyed as the reducer
        emitted."""
        entries = [env[s] for s in stage.inputs]
        for e in entries:
            if not isinstance(e, storage.PartitionSet):
                raise TypeError(
                    "reduce inputs must be materialized partitions, got "
                    "{!r}".format(e))

        def job(pid):
            views = [base.GroupedView([r.get() for r in pset.refs(pid)])
                     for pset in entries]
            reducer = _clone_op(stage.reducer)
            builder = BlockBuilder(settings.batch_size)
            refs = []
            for k, v in reducer.reduce(*views):
                blk = builder.add(k, v)
                if blk is not None:
                    refs.append(self.store.register(blk))
            blk = builder.flush()
            if blk is not None:
                refs.append(self.store.register(blk))
            return pid, refs

        P = self.n_partitions
        results = self._pool_map(job, list(range(P)), self.n_reducers)
        pset = storage.PartitionSet(P)
        for pid, refs in results:
            for ref in refs:
                pset.add(pid, ref)
        return pset, pset.total_records(), P

    # -- sink --------------------------------------------------------------
    def run_sink(self, stage_id, stage, env):
        chunks = self._as_chunks(env[stage.inputs[0]])
        os.makedirs(stage.path, exist_ok=True)

        def job(args):
            i, chunk = args
            part = os.path.join(stage.path, "part-{}".format(i))
            n = 0
            with open(part, "w", encoding="utf-8") as f:
                for _k, v in stage.sinker.map(chunk):
                    f.write("{}\n".format(v))
                    n += 1
            return part, n

        results = self._pool_map(job, list(enumerate(chunks)), self.n_maps)
        return (_SinkOutput([p for p, _ in results]),
                sum(n for _, n in results), len(chunks))

    # -- the walk ----------------------------------------------------------
    def run(self, outputs):
        """Execute the graph; returns one dataset per requested output.
        Intermediate stage outputs are deleted once the walk ends."""
        t_start = time.perf_counter()
        launches0 = {k: kern.launches for k, kern in KERNELS.items()}
        self.graph, self.plan_report = plan.prepare(self.graph, outputs)
        env = {}
        to_delete = []
        for sid, stage in enumerate(self.graph.stages):
            if isinstance(stage, GInput):
                env[stage.output] = stage.tap
                continue
            t0 = time.perf_counter()
            if isinstance(stage, GMap):
                result, nrec, njobs = self.run_map(sid, stage, env)
                kind, op = "map", stage.mapper
                to_delete.append(stage.output)
            elif isinstance(stage, GReduce):
                result, nrec, njobs = self.run_reduce(sid, stage, env)
                kind, op = "reduce", stage.reducer
                to_delete.append(stage.output)
            elif isinstance(stage, GSink):
                result, nrec, njobs = self.run_sink(sid, stage, env)
                kind, op = "sink", stage.sinker
            else:
                raise TypeError("unknown stage type {!r}".format(stage))
            env[stage.output] = result
            st = StageStats(sid, kind, plan.ir.chain_name(op),
                            stage.options.get("exec_target", "host"))
            st.n_jobs = njobs
            st.records_out = nrec
            st.seconds = time.perf_counter() - t0
            self.stats.append(st)
            log.info("stage %d done: %s", sid, st.as_dict())

        ret = []
        for source in outputs:
            entry = env[source]
            if isinstance(entry, storage.PartitionSet):
                ret.append(OutputDataset(entry, self.store))
            elif isinstance(entry, _SinkOutput):
                ret.append(CatDataset(entry.datasets()))
            else:
                ret.append(CatDataset(list(entry.chunks())))
        keep = set(outputs)
        for source in to_delete:
            if source not in keep:
                env[source].delete(self.store)
        wall = time.perf_counter() - t_start
        self.run_summary = self._summary(wall, launches0)
        return ret

    def _summary(self, wall, launches0):
        dev = self._device
        phases = dict(dev["phases"])
        driving = phases["enqueue"] + phases["wait"]
        device = {
            "device": str(self.device),
            "device_stages": self.plan_report["device_stages"],
            # host seconds spent driving the device (enqueue + waiting on
            # results) over the run's wall time; jobs overlap, so it can
            # exceed 1
            "device_fraction": driving / wall if wall > 0 else 0.0,
            # summed per-batch stream spans on the card over wall time
            "stream_fraction": (dev["stream_seconds"] / wall if wall > 0
                                else 0.0),
            "stream_seconds": dev["stream_seconds"],
            "host_phase_seconds": phases,
            "batches": dev["batches"],
            "fallbacks": dev["fallbacks"],
            "h2d_bytes": self.store.h2d_bytes,
            "d2h_bytes": self.store.d2h_bytes,
            "kernels": {k: kern.launches - launches0[k]
                        for k, kern in KERNELS.items()},
            # the keyed batch ops' device calls (hash lanes, sort, segment
            # fold): calls and host seconds summed over jobs; their bytes
            # are in h2d_bytes/d2h_bytes
            "keyed": {k: dict(v) for k, v in self.store.keyed.items()},
        }
        return {"name": self.name, "wall_seconds": wall,
                "stages": [s.as_dict() for s in self.stats],
                "plan": self.plan_report, "device": device,
                # host seconds in map-side combine folds, summed over jobs
                "combine_seconds": dev["combine_seconds"],
                "spill": {"count": self.store.spill_count,
                          "bytes": self.store.spill_bytes}}
