"""The general mesh exchange: byte blobs over an all_to_all (B8).

Port of ``dampr_tpu/parallel/exchange.py``.  :mod:`.shuffle` covers the
associative numeric fold; this module carries every other keyed
exchange (non-associative group_by, joins, sort_by's range read):
records whose values are any Python objects cross the mesh as byte
payloads.

- **Routing** is by partition id: partition ``pid`` lands on shard
  ``pid % D``, so both sides of a join meet on one shard; a straggler
  mitigation's sticky down-weight re-weights it
  (:meth:`.mitigate.MitigationController.route_table`).
- **Payload**: each (source shard, destination) pair's blocks pickle
  once per window, columnar (:func:`_pack_group`).
- **Steps**: a window runs as a :mod:`.replan` schedule.  Each step is a
  ``[D*D, C]`` uint8 buffer (row ``s*D + d``: source s's bytes for
  destination d) and an int32 length row, shard s holding its D rows;
  :func:`.mesh.all_to_all` moves them, and the pieces reassemble in order
  on the receiving side, byte for byte.  Across processes every rank
  packs the same buffer, sends its local shards' rows, and an all_gather
  of what the shards received (the ``gather`` variant) gives every rank
  the whole delivery.
- **Deadline**: under ``settings.exchange_timeout_ms`` a watchdog guards
  each step; a step past it records an ``exchange_timeout`` fault event
  (the next run under the name keeps the stage on the host shuffle) and
  exits the process with 70.  The ``rank_kill`` fault site sits at each
  step's entry.
- **Mitigation** (:mod:`.mitigate`): an engaged controller skips a
  window (its blobs are delivered as they are: every rank holds them
  all), and after each window that ran, the ranks share their first
  step's entry time over an all_gather (:func:`_share_skew`), the live
  form of :func:`..obs.fleet.step_skew`.
"""

import logging
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import faults as _faults
from .. import settings
from ..io import codecs as _codecs
from . import mesh as _mesh
from . import mitigate as _mitigate
from . import replan

log = logging.getLogger("dampr_tpu_torch.parallel.exchange")


def wire_codec():
    """The per-route payload codec (``settings.exchange_codec``), or None
    for raw wire bytes.  ``auto`` takes zstd, then lz4, else raw (never
    zlib: on an in-memory path a slow DEFLATE costs more than the bytes
    it saves).  Every blob carries a one-byte codec id, so a blob whose
    compressed form is not smaller ships raw under the same framing."""
    name = str(settings.exchange_codec).lower()
    if name in ("off", "0", "false", "no", "none", "raw"):
        return None
    if name == "auto":
        for cand in ("zstd", "lz4"):
            if _codecs.available(cand):
                return _codecs.resolve(cand)
        return None
    try:
        codec = _codecs.resolve(name)
    except ValueError:
        log.warning("unknown exchange_codec %r; sending raw", name)
        return None
    return None if codec.cid == _codecs.RAW else codec


def _exchange_step(mesh, buf, lens):
    """One collective step: the ``[D*D, C]`` buffer and its lengths,
    shard s holding rows ``s*D .. s*D + D - 1``, through the all_to_all.
    Returns what each shard received (``[D, C]`` and ``[D]``: row s from
    shard s), on its device: in one process its shards', across
    processes every shard's, through an all_gather (the ``gather``
    variant)."""
    import torch

    D = _mesh.mesh_size(mesh)
    C = buf.shape[1]
    bb = [t.reshape(D, C) for t in _mesh.shard(
        mesh, torch.from_numpy(buf.reshape(-1)))]
    ll = _mesh.shard(mesh, torch.from_numpy(lens))
    rb, rl = _mesh.all_to_all(mesh, bb), _mesh.all_to_all(mesh, ll)
    if mesh.nproc > 1:
        rb = _mesh.all_gather(mesh, [t.unsqueeze(0) for t in rb])[0]
        rl = _mesh.all_gather(mesh, [t.unsqueeze(0) for t in rl])[0]
        return list(rb), list(rl)
    return rb, rl


#: The shape of the last exchange this process ran: steps, payload bytes,
#: peak in-flight bytes (the replan model), whether the budget clamped at
#: the capacity floor, per-shard bytes sent and received and the route
#: matrix.  The runner folds them into ``stats()["mesh"]["exchange"]``.
last_info = None

#: Steps that ran with the watchdog armed, since import.
watchdogs_armed = 0


def _step_watchdog(step_i, timeout_ms):
    """The deadline of one step: past it, flush the flight recorder,
    record the ``exchange_timeout`` fault event (the next run's shuffle
    routing keeps the stage on the host) and exit the process with 70,
    never a hang.  Returns the event the step sets when it finishes; its
    ``abort(exc)`` runs the same exit at once (a collective across ranks
    that raised because a peer died can never complete)."""
    done = threading.Event()
    ctx = dict(_faults.run_context)

    def abort(exc):
        from ..obs import flightrec as _flightrec

        log.error("%s (run=%r stage=%r)", exc, ctx.get("run"),
                  ctx.get("stage"))
        _flightrec.flush_active("exchange-timeout", exc)
        _faults.record_event(
            ctx.get("run"), "exchange_timeout", stage=ctx.get("stage"),
            step=step_i, timeout_ms=timeout_ms)
        os._exit(70)  # EX_SOFTWARE: a bounded abort

    def expire():
        if done.wait(timeout_ms / 1000.0):
            return
        abort(TimeoutError(
            "collective exchange step {} exceeded exchange_timeout_ms={}; "
            "aborting rather than hanging the collective".format(
                step_i, timeout_ms)))

    threading.Thread(target=expire, daemon=True,
                     name="dampr-exchange-watchdog").start()
    done.abort = abort
    return done


def mesh_blob_exchange(mesh, blobs, budget=None, coding=None):
    """Move byte blobs across the mesh under a device budget.

    ``blobs``: {(src_shard, dst_shard): bytes}.  Returns the delivered
    {(src_shard, dst_shard): bytes} (empty blobs deliver nothing): every
    byte crossed :func:`.mesh.all_to_all`.  The transfer walks a
    :mod:`.replan` schedule whose modeled in-flight bytes respect
    ``budget`` (default ``settings.exchange_hbm_budget``); pieces
    reassemble in order, byte for byte.  Each step emits ``exchange``
    spans for its pack (``h2d``), collective (``step``) and unpack
    (``d2h``).

    An engaged mitigation controller that says skip returns the blobs as
    they are (``last_info["skipped"]``): every rank holds every blob, so
    the delivery equals its input.  Across processes a window that ran
    ends with the skew share (:func:`_share_skew`)."""
    from ..obs import trace as _trace

    global last_info, codec_raw_bytes, codec_wire_bytes, watchdogs_armed
    global pack_seconds_total, pack_hidden_seconds_total, share_failures
    D = _mesh.mesh_size(mesh)
    ctl = _mitigate.active()
    if ctl is not None and not ctl.use_collective():
        # degrade in place: the fleet stops waiting on the straggler at
        # every step; the content is the same by construction
        _trace.instant("mitigation", "window-skipped",
                       bytes=sum(len(b) for b in blobs.values()))
        last_info = {
            "steps": 0, "bytes": 0, "peak_inflight_bytes": 0,
            "budget": (budget if budget is not None
                       else settings.exchange_hbm_budget),
            "clamped": False, "skipped": True, "capacity": 0,
            "sent_per_device": [0] * D, "received_per_device": [0] * D,
            "pair_bytes": {},
        }
        return dict(blobs)
    gather = mesh.nproc > 1
    codec = wire_codec()
    codec_info = None
    if codec is not None and blobs:
        # blobs compress before planning, so the schedule and every byte
        # count see wire bytes
        raw_total = wire_total = 0
        wire = {}
        for sd, b in blobs.items():
            if not b:
                wire[sd] = b
                continue
            cb = codec.compress(b)
            if len(cb) + 1 < len(b):
                wire[sd] = bytes((codec.cid,)) + cb
            else:
                wire[sd] = bytes((_codecs.RAW,)) + b
            raw_total += len(b)
            wire_total += len(wire[sd])
        blobs = wire
        codec_info = {"name": codec.name, "raw_bytes": raw_total,
                      "wire_bytes": wire_total}
        codec_raw_bytes += raw_total
        codec_wire_bytes += wire_total
    sched = replan.plan_exchange(
        D, {sd: len(b) for sd, b in blobs.items()}, budget=budget,
        gather=gather, coding=coding)
    sent = [0] * D
    received = [0] * D
    pair = {}
    for (s, d), b in blobs.items():
        if b:
            pair[(s, d)] = pair.get((s, d), 0) + len(b)
    parts = {}
    pack_acct = {"seconds": 0.0, "exposed": 0.0}
    entry_perf = None

    def pack_step(step):
        """The host staging of one step's send buffer: pure over
        (blobs, step), so it may run a step ahead on the packer thread."""
        t0 = time.perf_counter()
        buf = np.zeros((D * D, step.capacity), dtype=np.uint8)
        lens = np.zeros(D * D, dtype=np.int32)
        sent_inc = [0] * D
        for s, d, start, stop in step.cells:
            row = s * D + d
            n = stop - start
            lens[row] = n
            if n:
                buf[row, :n] = np.frombuffer(blobs[(s, d)], dtype=np.uint8,
                                             count=n, offset=start)
                sent_inc[s] += n
        pack_acct["seconds"] += time.perf_counter() - t0
        return buf, lens, sent_inc

    # step k + 1 packs on a thread while step k moves (settings.pipeline);
    # the fault site and the watchdog stay on this thread, per step
    packer = None
    if settings.pipeline_enabled() and len(sched.steps) > 1:
        packer = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="dampr-xpack")
    try:
        nxt = (packer.submit(pack_step, sched.steps[0])
               if packer is not None else None)
        for i, step in enumerate(sched.steps):
            with _trace.span("exchange", "h2d:{}".format(i), step=i,
                             capacity=int(step.capacity)):
                if packer is not None:
                    wait0 = time.perf_counter()
                    buf, lens, sent_inc = nxt.result()
                    pack_acct["exposed"] += time.perf_counter() - wait0
                    if i + 1 < len(sched.steps):
                        nxt = packer.submit(pack_step, sched.steps[i + 1])
                else:
                    s0 = pack_acct["seconds"]
                    buf, lens, sent_inc = pack_step(step)
                    pack_acct["exposed"] += pack_acct["seconds"] - s0
            for s in range(D):
                sent[s] += sent_inc[s]
            # rank_kill (exit action: a rank dead mid-exchange, where its
            # peers would hang) and exchange_step (a failed step)
            _faults.check("rank_kill")
            _faults.check("exchange_step")
            if i == 0:
                # the first step's entry, after the fault sites, so an
                # injected stall shows as lateness like a real one
                entry_perf = time.perf_counter()
            timeout_ms = settings.exchange_timeout_ms
            guard = None
            if timeout_ms > 0:
                watchdogs_armed += 1
                guard = _step_watchdog(i, timeout_ms)
            try:
                with _trace.span("exchange", "step:{}".format(i), step=i,
                                 bytes=int(step.payload_bytes()),
                                 capacity=int(step.capacity),
                                 inflight_bytes=int(step.inflight_bytes)):
                    try:
                        rb, rl = _exchange_step(mesh, buf, lens)
                    except RuntimeError as e:
                        if guard is not None and mesh.nproc > 1:
                            # gloo raised: a peer rank is gone, and the
                            # step can never complete
                            guard.abort(RuntimeError(
                                "collective exchange step {} failed across "
                                "ranks: {}".format(i, e)))
                        raise
                    _synchronize(mesh)
            finally:
                if guard is not None:
                    guard.set()
            with _trace.span("exchange", "d2h:{}".format(i), step=i):
                rb = [t.cpu().numpy() for t in rb]
                rl = [t.cpu().numpy() for t in rl]
                for s, d, _start, _stop in step.cells:
                    n = int(rl[d][s])  # shard d's row s: sent by s
                    if n:
                        parts.setdefault((s, d), []).append(
                            rb[d][s, :n].tobytes())
                        received[d] += n
    finally:
        if packer is not None:
            packer.shutdown(wait=True)
    hidden = max(0.0, pack_acct["seconds"] - pack_acct["exposed"])
    pack_seconds_total += pack_acct["seconds"]
    pack_hidden_seconds_total += hidden
    out = {sd: b"".join(ps) for sd, ps in parts.items()}
    if codec is not None:
        out = {sd: _codecs.decompress(b[0], b[1:]) for sd, b in out.items()}
    if ctl is not None and gather and entry_perf is not None:
        # the live skew observation: every rank gets the same vector, so
        # the controllers' states stay equal fleet-wide.  The share is a
        # collective like a step and has the same watchdog; what can fail
        # inside the try is the collective (the watchdog's) or nothing
        timeout_ms = settings.exchange_timeout_ms
        guard = None
        if timeout_ms > 0:
            watchdogs_armed += 1
            guard = _step_watchdog("skew-share", timeout_ms)
        try:
            _share_skew(mesh, D, ctl, entry_perf)
        except Exception as e:
            if guard is not None and isinstance(e, RuntimeError):
                # gloo raised: a peer rank is gone
                guard.abort(RuntimeError(
                    "mitigation skew share failed across ranks: "
                    "{}".format(e)))
            share_failures += 1
            log.warning("mitigation skew share failed", exc_info=True)
        finally:
            if guard is not None:
                guard.set()
    for d in range(D):
        if sent[d]:
            sent_bytes_per_device[d] = (
                sent_bytes_per_device.get(d, 0) + sent[d])
        if received[d]:
            received_bytes_per_device[d] = (
                received_bytes_per_device.get(d, 0) + received[d])
    for sd, n in pair.items():
        pair_bytes_per_route[sd] = pair_bytes_per_route.get(sd, 0) + n
    last_info = {
        "steps": sched.n_steps,
        "bytes": sched.total_bytes,
        "peak_inflight_bytes": sched.peak_inflight_bytes,
        "budget": sched.budget,
        "clamped": sched.clamped,
        "capacity": max((st.capacity for st in sched.steps), default=0),
        "sent_per_device": sent,
        "received_per_device": received,
        "pair_bytes": pair,
        "overlap": {
            "pack_seconds": round(pack_acct["seconds"], 6),
            "hidden_seconds": round(hidden, 6),
            "hidden_fraction": (round(hidden / pack_acct["seconds"], 4)
                                if pack_acct["seconds"] > 1e-9 else 0.0),
            "pipelined": packer is not None,
        },
    }
    if codec_info is not None:
        last_info["codec"] = codec_info
    if sched.coding:
        last_info["coding"] = dict(sched.coding)
    return out


#: Skew shares that raised (logged, and the window's observation lost:
#: the JAX package's one fallback), since import.
share_failures = 0

_warned_no_clock = False


def _share_skew(mesh, D, ctl, entry_perf):
    """Share this rank's first-step entry time (on the handshake's clock)
    and its count of transient retries over an all_gather, and feed the
    controller the window's lateness by rank (it differences the
    counts).  ``D * 16`` bytes a window."""
    import torch

    from ..obs.fleet import _rank_of_device

    global _warned_no_clock
    if _mesh.clock_sync is None:
        # no common clock anchor: raw monotonic clocks differ by each
        # host's uptime, so no observation beats a wrong one
        if not _warned_no_clock:
            _warned_no_clock = True
            log.warning(
                "mitigation: no clock handshake (mesh.clock_sync is "
                "None); live skew observation is off in this process")
        return
    t = entry_perf - _mesh.clock_sync["barrier_perf"]
    row = torch.tensor([[t, float(ctl.local_fault_count())]],
                       dtype=torch.float64)
    out = _mesh.all_gather(mesh, [row.to(dev) for dev in mesh.devices])[0]
    out = out.cpu().numpy()
    entries, fault_counts = {}, {}
    for d in range(D):
        r = _rank_of_device(d, mesh.nproc, D)
        if r not in entries:
            entries[r] = float(out[d, 0])
            fault_counts[r] = int(out[d, 1])
    first = min(entries.values())
    ctl.observe_window({r: e - first for r, e in entries.items()},
                       fault_counts=fault_counts)


def _synchronize(mesh):
    """Wait for the step's copies on every card of the mesh (the step's
    span and its watchdog cover the collective, not its enqueue)."""
    import torch

    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _pack_group(items):
    """[(seq, pid, Block)] -> blob.  Columnar: numpy lanes pickle as raw
    buffers, one serialization per group, never per record."""
    payload = [(seq, pid, (b.keys, b.values, b.h1, b.h2))
               for seq, pid, b in items]
    return pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def _unpack_group(blob):
    from ..blocks import Block

    return [(seq, pid, Block(k, v, h1, h2))
            for seq, pid, (k, v, h1, h2) in pickle.loads(blob)]


#: Cumulative counters since import (tests assert engagement).
total_exchanges = 0
total_bytes = 0
total_steps = 0
peak_inflight_bytes = 0  # high-water mark across every schedule
peak_capacity = 0  # the largest step capacity run
#: Payload bytes by shard: what each source put on the wire and each
#: destination drained.
sent_bytes_per_device = {}
received_bytes_per_device = {}
#: (src_shard, dst_shard) -> payload bytes across every exchange.
pair_bytes_per_route = {}
#: Per-route codec bytes: before compression against on the wire.
codec_raw_bytes = 0
codec_wire_bytes = 0
#: Host pack seconds of every schedule, and the share hidden behind a
#: step in flight.
pack_seconds_total = 0.0
pack_hidden_seconds_total = 0.0


def mesh_shuffle_blocks(mesh, routed, coding=None):
    """Exchange one window of routed blocks across the mesh.

    ``routed``: iterable of (seq, src_shard, pid, Block); ``seq`` restores
    each partition's block order on the receiving side (a group's values
    come in arrival order).  Partition ``pid`` lands on shard ``pid % D``,
    or where an engaged mitigation's weighted route table sends it (a
    placement only: every rank reads the whole delivery).  Returns
    ``(received, bytes_moved)``: (pid, Block) sorted by seq, and the
    payload bytes that crossed the collective (0 for a skipped window)."""
    from ..obs import trace as _trace

    global total_exchanges, total_bytes, total_steps, peak_inflight_bytes
    global peak_capacity
    D = _mesh.mesh_size(mesh)
    ctl = _mitigate.active()
    route = ctl.route_table(D, mesh.nproc) if ctl is not None else None

    def dst(pid):
        return route[pid % len(route)] if route else pid % D

    groups = {}
    for seq, src, pid, blk in routed:
        groups.setdefault((src % D, dst(pid)), []).append((seq, pid, blk))
    blobs = {sd: _pack_group(items) for sd, items in groups.items()}
    moved = sum(len(b) for b in blobs.values())
    with _trace.span("collective", "exchange", bytes=moved,
                     blobs=len(blobs)):
        recv = mesh_blob_exchange(mesh, blobs, coding=coding)
    if last_info.get("skipped"):
        moved = 0  # degraded in place: nothing crossed the mesh
    total_exchanges += 1
    total_bytes += moved
    total_steps += last_info["steps"]
    peak_inflight_bytes = max(peak_inflight_bytes,
                              last_info["peak_inflight_bytes"])
    peak_capacity = max(peak_capacity, last_info["capacity"])
    out = []
    for (_s, d), blob in recv.items():
        for seq, pid, blk in _unpack_group(blob):
            assert dst(pid) == d, (pid, d)
            out.append((seq, pid, blk))
    out.sort(key=lambda t: t[0])
    return [(pid, blk) for _seq, pid, blk in out], moved
