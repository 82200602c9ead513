"""The mesh, its process group, and the four collectives.

Port of ``dampr_tpu/parallel/mesh.py``.  A mesh is an ordered tuple of
``torch.device`` shards plus the axis name ``settings.mesh_axis``; the
shards come from ``settings.mesh_devices``, where one device may be named
more than once (the rig that gives the CPU tests 8 shards and one card
4).

The JAX package runs each mesh program as one ``shard_map`` over the
axis.  Here a program is a loop over the shards, each shard's lanes a
tensor on that shard's device, and the four collectives below move
tensors between the shards' devices: a copy to the same device is a
no-op view, one to another card a peer copy.  They are the one seam for
a collective.

Across processes (:func:`init_distributed`) every rank names its own
**local** shards in ``settings.mesh_devices``; the global mesh is every
rank's local shards in rank order (global shard = rank offset + local
index), and a :class:`Mesh` holds the local ones with the global size
and offset.  Every rank drives the same program on the same inputs, as
the JAX package's ranks do: each computes its local shards, and the
collectives cross the ranks through a ``gloo`` process group, staged in
host memory (``.cpu()`` before the call, a copy to the shard's device
after).  gloo, because NCCL refuses two ranks on one card; the staging's
seconds are :data:`staging_seconds`, its gloo calls' :data:`wire_seconds`.
"""

import os
import time

from .. import settings


class Mesh(object):
    """An ordered tuple of this process's shard devices and one axis
    name.  ``size`` is the global shard count and ``offset`` the global
    index of ``devices[0]``; in one process they are ``len(devices)`` and
    0."""

    __slots__ = ("devices", "axis", "size", "offset", "rank", "nproc")

    def __init__(self, devices, axis, size=None, offset=0, rank=0,
                 nproc=1):
        self.devices = tuple(devices)
        self.axis = axis
        self.size = len(self.devices) if size is None else int(size)
        self.offset = int(offset)
        self.rank = int(rank)
        self.nproc = int(nproc)

    @property
    def shape(self):
        return {self.axis: self.size}

    def __repr__(self):
        if self.nproc > 1:
            return "Mesh({}, {!r}, rank {} of {}, shards {}-{} of {})".format(
                [str(d) for d in self.devices], self.axis, self.rank,
                self.nproc, self.offset,
                self.offset + len(self.devices) - 1, self.size)
        return "Mesh({}, {!r})".format(
            [str(d) for d in self.devices], self.axis)


def data_mesh(devices=None, n=None):
    """A 1-D mesh over ``devices`` (default: ``settings.mesh_devices``,
    resolved) named by ``settings.mesh_axis``.  Inside a process group
    the devices are this rank's local shards and the mesh spans every
    rank's (``n``, if given, must then be the global count)."""
    import torch

    if devices is None:
        devices = settings.mesh_device_list()
    devices = [torch.device(d) for d in devices]
    rank, nproc = rank_info() if _initialized else (0, 1)
    if nproc > 1:
        size = len(devices) * nproc
        if n is not None and n != size:
            raise ValueError("requested {} devices; the mesh across {} "
                             "processes has {}".format(n, nproc, size))
        return Mesh(devices, settings.mesh_axis, size=size,
                    offset=rank * len(devices), rank=rank, nproc=nproc)
    if n is not None:
        assert n <= len(devices), (
            "requested {} devices, have {}".format(n, len(devices)))
        devices = devices[:n]
    return Mesh(devices, settings.mesh_axis)


def default_mesh():
    return data_mesh()


def mesh_size(mesh):
    """The global shard count."""
    return mesh.size


def local_index(mesh):
    """The global shard index of each of this process's shards."""
    return range(mesh.offset, mesh.offset + len(mesh.devices))


# -- host staging across ranks ----------------------------------------------

#: Seconds the collectives across ranks spent copying tensors to and from
#: host memory, seconds inside the gloo calls, the calls and the bytes
#: this rank put on the wire, since import.  Zero in one process.
staging_seconds = 0.0
wire_seconds = 0.0
cross_rank_calls = 0
cross_rank_bytes = 0


def _dist():
    import torch.distributed as dist

    return dist


def _host(t):
    """A contiguous host copy of ``t`` a collective may write into (a
    bool tensor as uint8: gloo has no bool)."""
    import torch

    h = t.detach().to("cpu", copy=True).contiguous()
    return h.view(torch.uint8) if h.dtype == torch.bool else h


def _device(h, dtype, dev):
    import torch

    if dtype == torch.bool:
        h = h.view(torch.bool)
    return h.to(dev)


def _stage(fn, *args):
    """``fn(*args)``, its seconds counted as host staging."""
    global staging_seconds
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        staging_seconds += time.perf_counter() - t0


def _wire(fn, *args):
    """``fn(*args)``, its seconds counted as the gloo calls'."""
    global wire_seconds
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        wire_seconds += time.perf_counter() - t0


def _count(nbytes):
    global cross_rank_calls, cross_rank_bytes
    cross_rank_calls += 1
    cross_rank_bytes += int(nbytes)


# -- the collectives --------------------------------------------------------


def all_to_all(mesh, bufs):
    """``bufs[l]`` is local shard l's ``[D, ...]`` send buffer (row d for
    global destination d); returns each local shard's receive buffer, on
    its device, whose row s is what global shard s sent it."""
    import torch

    if mesh.nproc > 1:
        return _all_to_all_ranks(mesh, bufs)
    return [torch.stack([bufs[s][d].to(dev) for s in range(len(bufs))])
            for d, dev in enumerate(mesh.devices)]


def _all_to_all_ranks(mesh, bufs):
    import torch

    L, P = len(mesh.devices), mesh.nproc
    dtype = bufs[0].dtype
    send = _stage(lambda: torch.stack([_host(b) for b in bufs]))
    rest = tuple(send.shape[2:])
    # [L_src, P, L_dst, ...] -> [P, L_src, L_dst, ...]: chunk p goes to
    # rank p, every chunk the same size (capacity buffers)
    send = send.reshape((L, P, L) + rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    _count(send.numel() * send.element_size())
    _wire(_dist().all_to_all_single, recv, send)
    # recv[p, ls, ld]: rank p's local shard ls to my local shard ld
    return _stage(lambda: [
        _device(recv[:, :, j].reshape((P * L,) + rest), dtype, dev)
        for j, dev in enumerate(mesh.devices)])


def psum(mesh, xs):
    """The sum of every shard's tensor, on each local shard's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    if mesh.nproc > 1:
        dtype, shape = total.dtype, total.shape
        h = _stage(_host, total).reshape(-1)
        _count(h.numel() * h.element_size())
        _wire(_dist().all_reduce, h)
        return _stage(lambda: [_device(h.reshape(shape), dtype, dev)
                               for dev in mesh.devices])
    return [total.to(dev) for dev in mesh.devices]


def all_gather(mesh, xs):
    """Every shard's tensor concatenated in global shard order, on each
    local shard's device.  Across ranks the pieces may differ in length
    (each rank's are padded to the longest for the gather)."""
    import torch

    first = mesh.devices[0]
    local = torch.cat([x.to(first) for x in xs])
    if mesh.nproc > 1:
        local = _all_gather_ranks(mesh, local)
    return [local.to(dev) for dev in mesh.devices]


def _all_gather_ranks(mesh, local):
    import torch

    dist = _dist()
    P = mesh.nproc
    dtype, first = local.dtype, local.device
    h = _stage(_host, local)
    n = torch.tensor([h.shape[0]], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    _wire(dist.all_gather, sizes, n)
    sizes = [int(t[0]) for t in sizes]
    top = max(sizes)
    if h.shape[0] < top:
        pad = torch.zeros((top - h.shape[0],) + tuple(h.shape[1:]),
                          dtype=h.dtype)
        h = torch.cat([h, pad])
    parts = [torch.empty_like(h) for _ in range(P)]
    _count(h.numel() * h.element_size())
    _wire(dist.all_gather, parts, h)
    return _stage(lambda: _device(
        torch.cat([p[:k] for p, k in zip(parts, sizes)]), dtype, first))


def ppermute(mesh, xs):
    """Each shard's tensor sent to its ring neighbour: global shard
    ``(i + 1) % D`` receives shard i's.  Across ranks every shard's
    tensor has one shape and dtype."""
    if mesh.nproc > 1:
        return _ppermute_ranks(mesh, xs)
    D = len(xs)
    return [xs[(d - 1) % D].to(dev) for d, dev in enumerate(mesh.devices)]


def _ppermute_ranks(mesh, xs):
    import torch

    dist = _dist()
    L, P, rank = len(mesh.devices), mesh.nproc, mesh.rank
    dtype = xs[-1].dtype
    send = _stage(_host, xs[-1])
    recv = torch.empty_like(send)
    _count(send.numel() * send.element_size())

    def exchange():
        # my last shard feeds the next rank's first; my first is fed by
        # the previous rank's last
        out = dist.isend(send, (rank + 1) % P)
        inc = dist.irecv(recv, (rank - 1) % P)
        out.wait()
        inc.wait()

    _wire(exchange)
    head = _stage(_device, recv, dtype, mesh.devices[0])
    return [head] + [xs[l - 1].to(mesh.devices[l]) for l in range(1, L)]


def shard(mesh, t):
    """A 1-D tensor of ``D * n`` rows as D contiguous pieces; returns this
    process's pieces, each moved to its shard's device."""
    n = t.shape[0] // mesh.size
    return [t[g * n:(g + 1) * n].to(dev)
            for g, dev in zip(local_index(mesh), mesh.devices)]


def unshard(mesh, parts):
    """The local shard pieces of a sharded result concatenated in global
    shard order on the first local shard's device (the JAX package's
    ``P(axis)`` output; across ranks, the all_gather of its ``gather``
    variant)."""
    import torch

    first = mesh.devices[0]
    if mesh.nproc > 1:
        return all_gather(mesh, parts)[0]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(first) for p in parts])


# -- the process group ------------------------------------------------------

_initialized = False

#: The clock anchor of the handshake at :func:`init_distributed`, or None
#: (one process).  ``barrier_perf``: this rank's ``time.perf_counter()``
#: the moment the barrier returned (every rank leaves a barrier within
#: network latency of one instant, so :mod:`..obs.fleet` aligns the ranks'
#: timelines on it, trusting no wall clock); ``barrier_wall``:
#: ``time.time()`` then (display only); ``method``: the collective.
clock_sync = None

#: The least timeout (s) of the process group.  The group's timeout is
#: always longer than ``settings.exchange_timeout_ms``, so the exchange's
#: step watchdog, not gloo, ends a step a dead rank hung.
GROUP_TIMEOUT_FLOOR_S = 300

COORDINATOR_ENV = "DAMPR_TPU_TORCH_COORDINATOR"
NUM_PROCESSES_ENV = "DAMPR_TPU_TORCH_NUM_PROCESSES"
PROCESS_ID_ENV = "DAMPR_TPU_TORCH_PROCESS_ID"


def is_initialized():
    return _initialized


def group_timeout_seconds():
    return max(GROUP_TIMEOUT_FLOOR_S,
               4 * settings.exchange_timeout_ms / 1000.0)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join a multi-process deployment: a ``gloo`` process group over
    ``tcp://<coordinator_address>``.  The arguments default to
    ``DAMPR_TPU_TORCH_COORDINATOR``, ``DAMPR_TPU_TORCH_NUM_PROCESSES``
    and ``DAMPR_TPU_TORCH_PROCESS_ID``.  Ranks whose
    ``settings.mesh_devices`` name unequal shard counts raise, and so
    does a failed join: nothing falls back to one process."""
    import datetime

    global _initialized
    if coordinator_address is None:
        coordinator_address = os.environ.get(COORDINATOR_ENV) or None
    if num_processes is None and os.environ.get(NUM_PROCESSES_ENV):
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None and os.environ.get(PROCESS_ID_ENV, "") != "":
        process_id = int(os.environ[PROCESS_ID_ENV])
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs the coordinator, the number of "
            "processes and this process's id ({}, {}, {})".format(
                COORDINATOR_ENV, NUM_PROCESSES_ENV, PROCESS_ID_ENV))
    if _initialized:
        return
    dist = _dist()
    init = (coordinator_address if "://" in coordinator_address
            else "tcp://" + coordinator_address)
    dist.init_process_group(
        "gloo", init_method=init, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=group_timeout_seconds()))
    _initialized = True
    try:
        _check_local_shards()
    except BaseException:
        dist.destroy_process_group()
        _initialized = False
        raise
    _clock_handshake()


def _check_local_shards():
    """Every rank names as many local shards (the global mesh's rank
    offsets assume it)."""
    import torch

    dist = _dist()
    mine = torch.tensor([len(settings._mesh_entries())], dtype=torch.int64)
    every = [torch.zeros(1, dtype=torch.int64)
             for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    counts = [int(t[0]) for t in every]
    if len(set(counts)) != 1:
        raise RuntimeError(
            "ranks name unequal local shard counts {} (settings."
            "mesh_devices per rank); the global mesh needs them "
            "equal".format(counts))


def _clock_handshake():
    """A barrier every rank enters, and this rank's clocks at its exit:
    :data:`clock_sync`."""
    import time

    global clock_sync
    _dist().barrier()
    clock_sync = {
        "barrier_perf": time.perf_counter(),
        "barrier_wall": time.time(),
        "method": "gloo_barrier",
    }


def rank_info():
    """``(process_id, num_processes)``: the process group's once it is up,
    before that the launcher environment (``DAMPR_TPU_TORCH_PROCESS_ID``/
    ``DAMPR_TPU_TORCH_NUM_PROCESSES``), ``(0, 1)`` by default.  Safe from
    finalizers and tools: touches no device."""
    if _initialized:
        dist = _dist()
        return dist.get_rank(), dist.get_world_size()
    raw_n = os.environ.get(NUM_PROCESSES_ENV)
    raw_id = os.environ.get(PROCESS_ID_ENV)
    try:
        n = int(raw_n) if raw_n else 1
        pid = int(raw_id) if raw_id not in (None, "") else 0
    except ValueError:
        return 0, 1
    if n <= 1:
        return 0, 1
    return pid, n


def maybe_init_distributed():
    """Join the deployment the environment names
    (``DAMPR_TPU_TORCH_COORDINATOR`` set), else nothing.  Idempotent, so
    every entry point may call it.  True when this call joined."""
    if _initialized or not os.environ.get(COORDINATOR_ENV):
        return False
    init_distributed()
    return True


def process_info():
    """This process's view of the deployment: its rank, the ranks, and
    the local and global shard counts."""
    pid, n = rank_info()
    try:
        local = len(settings.mesh_device_list())
    except RuntimeError:
        local = 0
    up = _initialized and n > 1
    return {
        "process_id": pid,
        "process_count": n,
        "local_devices": local,
        "global_devices": local * n if up else local,
        "multiprocess": up,
    }
