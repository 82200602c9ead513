"""Dual-lane FNV-1a over a padded uint8 token matrix: the K1 kernel.

Port of the TPU kernel ``dampr_tpu/ops/pallas_fnv.py::fnv_pallas``.  On a
CUDA tensor :func:`fnv` launches the hand-written Hopper kernel
``csrc/fnv.cu`` (see its header for the design and its bound on the card);
on a CPU tensor it runs :func:`fnv_reference`, the plain torch version.
Any other device raises: there is no fallback from the card to the plain
version.

Output lanes are **int32 bit patterns**: ``h.numpy().view(np.uint32)``
gives the reference's uint32 lanes.  int32 keeps the write at 8 bytes a
row; equality tests and gathers on the bit patterns are exact, and
anything order-sensitive widens them with ``h.long() & 0xFFFFFFFF``.
"""

import ctypes

import torch

from ..csrc import build
from .hashing import (_FNV_OFFSET1, _FNV_OFFSET2, _FNV_PRIME1, _FNV_PRIME2,
                      lanes_to_int32, mul32)

KERNEL = build.Kernel(
    "fnv.cu", "dampr_fnv",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def fnv_reference(mat, lens):
    """Plain torch FNV (the column loop of ``hashing._fnv_numpy`` on
    tensors): the CPU path and the card's yardstick."""
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
    return lanes_to_int32(h1), lanes_to_int32(h2)


def _vec_width(mat):
    L = mat.shape[1]
    ptr = mat.data_ptr()
    for w in (16, 8):
        if L % w == 0 and ptr % w == 0:
            return w
    return 1


def fnv(mat, lens):
    """(h1, h2) int32 bit-pattern lanes of each row's first ``lens[i]``
    bytes (clamped to [0, L]).  ``mat`` uint8 [N, L], ``lens`` int32 [N]."""
    if mat.device.type == "cpu":
        return fnv_reference(mat, lens)
    if mat.device.type != "cuda":
        raise ValueError("fnv: unsupported device {}".format(mat.device))
    if mat.dtype != torch.uint8 or mat.dim() != 2 or not mat.is_contiguous():
        raise ValueError("fnv: mat must be a contiguous uint8 [N, L] tensor")
    n, L = mat.shape
    if (lens.dtype != torch.int32 or lens.shape != (n,)
            or not lens.is_contiguous() or lens.device != mat.device):
        raise ValueError("fnv: lens must be a contiguous int32 [N] tensor "
                         "on the matrix's device")
    h1 = torch.empty(n, dtype=torch.int32, device=mat.device)
    h2 = torch.empty(n, dtype=torch.int32, device=mat.device)
    if n == 0:
        return h1, h2
    with torch.cuda.device(mat.device):
        KERNEL.launch(mat.data_ptr(), lens.data_ptr(), h1.data_ptr(),
                      h2.data_ptr(), n, L, _vec_width(mat),
                      torch.cuda.current_stream().cuda_stream)
    return h1, h2
