"""Dual-lane FNV-1a over a padded uint8 token matrix: the K1 kernel.

Port of the TPU kernel ``dampr_tpu/ops/pallas_fnv.py::fnv_pallas``.  One
CUDA source, ``csrc/fnv.cu`` (see its header for the design and its bound
on the card), serves two entries:

- :func:`fnv` — the hash lanes ``(h1, h2)`` as **int32 bit patterns**
  (``h.numpy().view(np.uint32)`` gives the reference's uint32 lanes), for
  the string-key hash path (:mod:`.hashing`);
- :func:`fnv_sort_keys` — the two int64 sort keys of the lowered token
  fold (:func:`.lower.token_fold`), computed in the same launch as the
  lanes they hold, in the packing of :func:`pack_sort_keys` (its CUDA twin
  is ``csrc/sort_keys.cuh``), with ``inv = lens <= 0``.

On a CUDA tensor each launches the kernel; on a CPU tensor it runs its
plain torch version (:func:`fnv_reference`, :func:`fnv_sort_keys_reference`).
Any other device raises: there is no fallback from the card to the plain
version.
"""

import ctypes

import torch

from ..csrc import build
from .hashing import (_FNV_OFFSET1, _FNV_OFFSET2, _FNV_PRIME1, _FNV_PRIME2,
                      M32, lanes_to_int32, mul32)

KERNEL = build.Kernel(
    "fnv.cu", "dampr_fnv",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])

# the kernel's output modes (csrc/fnv.cu)
_LANES, _KEYS, _KEYS_DEDUP = 0, 1, 2


def _unsigned_lanes(mat, lens):
    """The FNV lanes as int64 tensors holding the uint32 values (the
    column loop of ``hashing._fnv_numpy`` on tensors)."""
    n, L = mat.shape
    h1 = torch.full((n,), int(_FNV_OFFSET1), dtype=torch.int64,
                    device=mat.device)
    h2 = torch.full((n,), int(_FNV_OFFSET2), dtype=torch.int64,
                    device=mat.device)
    lens = lens.to(torch.int64)
    for c in range(L):
        active = c < lens
        b = mat[:, c].to(torch.int64)
        h1 = torch.where(active, mul32(h1 ^ b, int(_FNV_PRIME1)), h1)
        h2 = torch.where(active, mul32(h2 ^ b, int(_FNV_PRIME2)), h2)
    return h1, h2


def fnv_reference(mat, lens):
    """Plain torch version of :func:`fnv`: the CPU path and the card's
    yardstick."""
    h1, h2 = _unsigned_lanes(mat, lens)
    return lanes_to_int32(h1), lanes_to_int32(h2)


#: Bits of the line in the low sort key under per-line dedup.
LINE_BITS = 31


def pack_sort_keys(u1, u2, inv, lines=None):
    """The token fold's int64 sort keys ``(low, high)`` from the unsigned
    lanes (int64 tensors), the invalid mask and, under dedup, the lines:
    ``high = inv << 32 | u1``, ``low = u2`` or ``u2 << LINE_BITS | line``.
    The plain torch twin of ``csrc/sort_keys.cuh``; a change here is made
    there too."""
    high = (inv.to(torch.int64) << 32) | u1
    if lines is None:
        return u2, high
    return (u2 << LINE_BITS) | lines.to(torch.int64), high


def unpack_sort_keys(low, high, dedup):
    """``(u1, u2, inv)`` int64 tensors from sort keys made by
    :func:`pack_sort_keys` (with lines when ``dedup``)."""
    return high & M32, (low >> LINE_BITS if dedup else low), high >> 32


def fnv_sort_keys_reference(mat, lens, lines=None):
    """Plain torch version of :func:`fnv_sort_keys`."""
    u1, u2 = _unsigned_lanes(mat, lens)
    return pack_sort_keys(u1, u2, lens <= 0, lines)


def _check(name, mat, lens, lines):
    if mat.dtype != torch.uint8 or mat.dim() != 2 or not mat.is_contiguous():
        raise ValueError(name + ": mat must be a contiguous uint8 [N, L] "
                                "tensor")
    n = mat.shape[0]
    for what, t in (("lens", lens), ("lines", lines)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (n,)
                              or not t.is_contiguous()
                              or t.device != mat.device):
            raise ValueError("{}: {} must be a contiguous int32 [N] tensor "
                             "on the matrix's device".format(name, what))


def _launch(name, mat, lens, lines, dtype, mode):
    if mat.device.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(name, mat.device))
    _check(name, mat, lens, lines)
    n, L = mat.shape
    out = torch.empty((2, n), dtype=dtype, device=mat.device)
    if n:
        base = out.data_ptr()
        KERNEL.launch(mat.device, mat.data_ptr(), lens.data_ptr(),
                      lines.data_ptr() if lines is not None else None,
                      base, base + n * out.element_size(), n, L, mode)
    return out.unbind(0)


def fnv(mat, lens):
    """(h1, h2) int32 bit-pattern lanes of each row's first ``lens[i]``
    bytes (clamped to [0, L]).  ``mat`` uint8 [N, L], ``lens`` int32 [N]."""
    if mat.device.type == "cpu":
        return fnv_reference(mat, lens)
    return _launch("fnv", mat, lens, None, torch.int32, _LANES)


def fnv_sort_keys(mat, lens, lines=None):
    """(low, high) int64 sort keys of each row, from one launch: the
    unsigned FNV lanes of :func:`fnv`, ``inv = lens <= 0`` and, when
    given, ``lines`` (int32 [N], each in [0, 2^31)), packed by
    :func:`pack_sort_keys`.  A
    stable sort by ``low`` then by ``high`` orders the rows by
    ``(inv, h1, h2[, line])``, ties by row."""
    if mat.device.type == "cpu":
        return fnv_sort_keys_reference(mat, lens, lines)
    return _launch("fnv_sort_keys", mat, lens, lines, torch.int64,
                   _KEYS if lines is None else _KEYS_DEDUP)
