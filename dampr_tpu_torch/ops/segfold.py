"""Segmented fold over hash-sorted records: the K2 kernel.

Port of the TPU kernel ``dampr_tpu/ops/pallas_segfold.py::segfold_sorted``.
For records sorted by ``(inv, h1, h2)``, ``tot[j]`` is the sum of ``v``
over the segment ending at ``j`` and ``live[j] = end(j) & inv[j] == 0``;
both are 0 where ``j`` is not a segment end.

On CUDA tensors :func:`segfold` launches ``csrc/segfold.cu`` (a three-phase
reduce-then-scan; its header gives the design and the bound); on CPU
tensors it runs :func:`segfold_reference_torch`, the cumsum/cummax chain of
``dampr_tpu/ops/lower.py:161-169``.  Any N works; no tile padding.

Exactness (both versions): the nonneg contract — every ``v >= 0`` and the
global sum fits int32 — keeps the int32 prefix arithmetic exact.
"""

import ctypes

import torch

from ..csrc import build

#: Records per block in ``csrc/segfold.cu`` (THREADS * ITEMS there).
_TILE = 2048

KERNEL = build.Kernel(
    "segfold.cu", "dampr_segfold",
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p])


def adj_new(*lanes):
    """True where any lane differs from its predecessor (position 0
    inclusive): the segment starts of sorted lanes."""
    n = lanes[0].shape[0]
    out = torch.ones(n, dtype=torch.bool, device=lanes[0].device)
    if n > 1:
        neq = torch.zeros(n - 1, dtype=torch.bool, device=lanes[0].device)
        for lane in lanes:
            neq |= lane[1:] != lane[:-1]
        out[1:] = neq
    return out


def segfold_reference_torch(h1, h2, v, inv):
    """Plain torch version: ``(tot int32, live bool)``."""
    n = h1.shape[0]
    starts = adj_new(inv, h1, h2)
    csum = torch.cumsum(v, 0, dtype=torch.int32)
    ex = csum - v
    # ex is nondecreasing (v >= 0), so a running max over start-marked
    # values carries each segment's exclusive prefix to its records
    start_ex = torch.cummax(torch.where(starts, ex, -1), 0).values
    ends = torch.ones(n, dtype=torch.bool, device=h1.device)
    if n > 1:
        ends[:-1] = starts[1:]
    tot = torch.where(ends, csum - start_ex, 0).to(torch.int32)
    live = ends & (inv == 0)
    return tot, live


def segfold(h1, h2, v, inv):
    """Segment totals at segment ends of int32 lanes sorted by
    ``(inv, h1, h2)`` (hash lanes as int32 bit patterns, ``v >= 0``,
    ``inv`` 0 for valid records).  Returns ``(tot int32, live bool)``."""
    if h1.device.type == "cpu":
        return segfold_reference_torch(h1, h2, v, inv)
    if h1.device.type != "cuda":
        raise ValueError("segfold: unsupported device {}".format(h1.device))
    n = h1.shape[0]
    for name, t in (("h1", h1), ("h2", h2), ("v", v), ("inv", inv)):
        if (t.dtype != torch.int32 or t.shape != (n,)
                or not t.is_contiguous() or t.device != h1.device):
            raise ValueError("segfold: {} must be a contiguous int32 [N] "
                             "tensor on h1's device".format(name))
    tot = torch.empty(n, dtype=torch.int32, device=h1.device)
    live = torch.empty(n, dtype=torch.bool, device=h1.device)
    if n == 0:
        return tot, live
    nblocks = -(-n // _TILE)
    scratch = torch.empty(4 * nblocks, dtype=torch.int32, device=h1.device)
    with torch.cuda.device(h1.device):
        KERNEL.launch(h1.data_ptr(), h2.data_ptr(), v.data_ptr(),
                      inv.data_ptr(), tot.data_ptr(), live.data_ptr(),
                      scratch.data_ptr(), n,
                      torch.cuda.current_stream().cuda_stream)
    return tot, live
