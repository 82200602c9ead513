"""The mesh, its process view, and the collectives inside one process.

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
a collective: a mesh across processes replaces them with
``torch.distributed`` calls.

Across processes (``init_distributed`` and its clock handshake) the
port has only the one-process forms: :func:`maybe_init_distributed`
refuses a coordinator in the environment.
"""

import os

from .. import settings


class Mesh(object):
    """An ordered tuple of shard devices and one axis name."""

    __slots__ = ("devices", "axis")

    def __init__(self, devices, axis):
        self.devices = tuple(devices)
        self.axis = axis

    @property
    def shape(self):
        return {self.axis: len(self.devices)}

    def __repr__(self):
        return "Mesh({}, {!r})".format(
            [str(d) for d in self.devices], self.axis)


def data_mesh(devices=None, n=None):
    """A 1-D mesh over ``devices`` (default: ``settings.mesh_devices``,
    resolved) named by ``settings.mesh_axis``."""
    import torch

    if devices is None:
        devices = settings.mesh_device_list()
    devices = [torch.device(d) for d in devices]
    if n is not None:
        assert n <= len(devices), (
            "requested {} devices, have {}".format(n, len(devices)))
        devices = devices[:n]
    return Mesh(devices, settings.mesh_axis)


def default_mesh():
    return data_mesh()


def mesh_size(mesh):
    return len(mesh.devices)


# -- collectives inside one process -----------------------------------------


def all_to_all(mesh, bufs):
    """``bufs[s]`` is shard s's ``[D, ...]`` send buffer (row d for
    destination d); returns each shard's receive buffer, on its device,
    whose row s is what shard s sent it."""
    import torch

    return [torch.stack([bufs[s][d].to(dev) for s in range(len(bufs))])
            for d, dev in enumerate(mesh.devices)]


def psum(mesh, xs):
    """The sum of the shards' tensors, on every shard's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(dev) for dev in mesh.devices]


def all_gather(mesh, xs):
    """The shards' tensors concatenated in shard order, on every shard's
    device."""
    import torch

    first = mesh.devices[0]
    whole = torch.cat([x.to(first) for x in xs])
    return [whole.to(dev) for dev in mesh.devices]


def ppermute(mesh, xs):
    """Each shard's tensor sent to its ring neighbour: shard
    ``(i + 1) % D`` receives shard i's."""
    D = len(xs)
    return [xs[(d - 1) % D].to(dev) for d, dev in enumerate(mesh.devices)]


def shard(mesh, t):
    """A 1-D tensor of ``D * n`` rows as D contiguous pieces, each moved
    to its shard's device."""
    n = t.shape[0] // len(mesh.devices)
    return [t[d * n:(d + 1) * n].to(dev)
            for d, dev in enumerate(mesh.devices)]


def unshard(mesh, parts):
    """Shard pieces concatenated in shard order on the first shard's
    device (the JAX package's ``P(axis)`` output)."""
    import torch

    first = mesh.devices[0]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(first) for p in parts])


# -- the process group ------------------------------------------------------


def rank_info():
    """``(process_id, num_processes)`` from the launcher environment
    (``DAMPR_TPU_TORCH_PROCESS_ID``/``DAMPR_TPU_TORCH_NUM_PROCESSES``),
    ``(0, 1)`` by default.  Safe from finalizers and tools: touches no
    device."""
    raw_n = os.environ.get("DAMPR_TPU_TORCH_NUM_PROCESSES")
    raw_id = os.environ.get("DAMPR_TPU_TORCH_PROCESS_ID")
    try:
        n = int(raw_n) if raw_n else 1
        pid = int(raw_id) if raw_id not in (None, "") else 0
    except ValueError:
        return 0, 1
    if n <= 1:
        return 0, 1
    return pid, n


def maybe_init_distributed():
    """False when the environment names no coordinator
    (``DAMPR_TPU_TORCH_COORDINATOR``; one process, the only deployment
    the port runs).  A coordinator raises: the mesh across processes is
    ROADMAP item A5b."""
    coord = os.environ.get("DAMPR_TPU_TORCH_COORDINATOR")
    if not coord:
        return False
    raise RuntimeError(
        "a coordinator is set ({!r}) but the port's mesh runs in one "
        "process; a mesh across processes is ROADMAP item A5b".format(coord))


def process_info():
    """This process's view of the deployment: one process, its mesh's
    shards and the distinct devices under them."""
    try:
        devices = settings.mesh_device_list()
    except RuntimeError:
        devices = []
    return {
        "process_id": 0,
        "process_count": 1,
        "local_devices": len(set(str(d) for d in devices)),
        "global_devices": len(devices),
        "multiprocess": False,
    }
