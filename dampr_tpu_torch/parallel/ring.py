"""Ring collectives over the mesh: D - 1 neighbour hops (B9).

Port of ``dampr_tpu/parallel/ring.py``.  Each hop moves every shard's
current piece to its ring neighbour (:func:`.mesh.ppermute`), so every
link carries ``(D - 1) / D`` of the payload whatever D is: the pattern
behind ring all-reduce and ring attention, checked against a plain sum
and concatenation.

Both functions take a numpy array or a torch tensor whose leading
dimension divides into D shards, and return the same kind: numpy on the
host, a tensor on the first shard's device.
"""

import numpy as np

from . import mesh as _mesh

#: Ring calls since import.
calls = 0

_COMBINE = {"sum": lambda a, b: a + b,
            "max": lambda a, b: a.maximum(b),
            "min": lambda a, b: a.minimum(b)}


def _split(mesh, x):
    import torch

    as_numpy = isinstance(x, np.ndarray) or not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)) if as_numpy else x
    D = _mesh.mesh_size(mesh)
    assert t.shape[0] % D == 0, (
        "leading dim {} must divide across {} devices".format(t.shape[0], D))
    return _mesh.shard(mesh, t), as_numpy


def _join(mesh, shards, as_numpy):
    out = _mesh.unshard(mesh, shards)
    return out.cpu().numpy() if as_numpy else out


def ring_allreduce(mesh, x, op="sum"):
    """All-reduce a ``[D * n, ...]`` array around the ring: every shard's
    output holds the elementwise ``op`` (``sum``, ``max``, ``min``) of all
    shards; the result is the shards' outputs concatenated."""
    global calls
    if op not in _COMBINE:
        raise ValueError(op)
    calls += 1
    combine = _COMBINE[op]
    shards, as_numpy = _split(mesh, x)
    acc = list(shards)
    rot = list(shards)
    for _ in range(_mesh.mesh_size(mesh) - 1):
        rot = _mesh.ppermute(mesh, rot)
        acc = [combine(a, r) for a, r in zip(acc, rot)]
    return _join(mesh, acc, as_numpy)


def ring_allgather(mesh, x):
    """All-gather shards around the ring: every shard ends holding all
    shards in shard order; the result is those copies concatenated
    (``[D * D * n, ...]``)."""
    import torch

    global calls
    calls += 1
    shards, as_numpy = _split(mesh, x)
    D = _mesh.mesh_size(mesh)
    glob = list(_mesh.local_index(mesh))
    held = [{d: s} for d, s in zip(glob, shards)]  # owner -> piece
    rot = list(shards)
    for hop in range(1, D):
        rot = _mesh.ppermute(mesh, rot)
        for l, d in enumerate(glob):
            # ppermute sends i -> i + 1: after ``hop`` hops shard d holds
            # the piece of shard d - hop
            held[l][(d - hop) % D] = rot[l]
    gathered = [torch.cat([h[j] for j in range(D)]) for h in held]
    return _join(mesh, gathered, as_numpy)
