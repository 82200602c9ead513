"""Vectorized 64-bit record hashing (dual uint32 lanes).

Port of ``dampr_tpu/ops/hashing.py``.  String keys become a padded uint8
matrix hashed by dual-lane FNV-1a; integer keys go through a murmur-style
finalizer.  The two 32-bit lanes (h1, h2) stand in for one 64-bit hash:
partitions route by ``h1 % P``, grouping sorts by ``(h1, h2)``.  Lanes
are bit-identical to the reference's for every key (the tests pin it).

Device paths: a string batch of at least ``settings.use_device_for`` rows
hashes through the hand-written FNV kernel (:mod:`.fnv`); integer batches
mix with plain torch ops on the configured device.  torch has no logical
shift or unsigned compare for uint32, so the torch side carries each lane
as int64 holding the unsigned value and multiplies modulo 2^32 with
:func:`mul32`.

``1 == 1.0 == True`` group together, so integral floats and bools hash as
int64, exactly as in the reference.
"""

import time

import numpy as np

from .. import settings
from . import devtime

_FNV_OFFSET1 = np.uint32(2166136261)
_FNV_OFFSET2 = np.uint32(0x9747B28C)
_FNV_PRIME1 = np.uint32(16777619)
_FNV_PRIME2 = np.uint32(0x85EBCA6B)

M32 = 0xFFFFFFFF

# Length padding buckets for variable-width string blocks.
_LEN_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def _len_bucket(max_len):
    for b in _LEN_BUCKETS:
        if max_len <= b:
            return b
    # Very long keys: round up to a multiple of 1024.
    return ((max_len + 1023) // 1024) * 1024


def encode_str_keys(keys):
    """Encode str/bytes keys as (padded uint8 [N, L], lengths int32 [N]):
    the keys' bytes joined once and scattered into their rows by one
    vectorized store."""
    bs = [k.encode("utf-8") if isinstance(k, str) else bytes(k) for k in keys]
    n = len(bs)
    lens = np.fromiter(map(len, bs), dtype=np.int64, count=n)
    L = _len_bucket(max(int(lens.max()) if n else 1, 1))
    mat = np.zeros((n, L), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        # byte j of key i goes to flat position i * L + j
        shift = np.arange(n, dtype=np.int64) * L - (np.cumsum(lens) - lens)
        dest = np.arange(total, dtype=np.int64) + np.repeat(shift, lens)
        mat.reshape(-1)[dest] = np.frombuffer(b"".join(bs), dtype=np.uint8)
    return mat, lens.astype(np.int32)


# ---------------------------------------------------------------------------
# numpy host path
# ---------------------------------------------------------------------------

def _fnv_numpy(mat, lens):
    n, L = mat.shape
    h1 = np.full(n, _FNV_OFFSET1, dtype=np.uint32)
    h2 = np.full(n, _FNV_OFFSET2, dtype=np.uint32)
    cols = np.arange(L, dtype=np.int32)
    with np.errstate(over="ignore"):
        for c in range(L):
            active = cols[c] < lens
            b = mat[:, c].astype(np.uint32)
            nh1 = (h1 ^ b) * _FNV_PRIME1
            nh2 = (h2 ^ b) * _FNV_PRIME2
            h1 = np.where(active, nh1, h1)
            h2 = np.where(active, nh2, h2)
    return h1, h2


def _mix_int_numpy(vals_i64):
    v = vals_i64.astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h1 = _murmur_fmix_np(lo ^ np.uint32(0x9E3779B9), hi)
        h2 = _murmur_fmix_np(lo ^ np.uint32(0x85EBCA6B), hi ^ np.uint32(0xC2B2AE35))
    return h1, h2


def _murmur_fmix_np(x, y):
    h = x
    h ^= y
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


# ---------------------------------------------------------------------------
# torch lanes (int64 holding uint32 values)
# ---------------------------------------------------------------------------

def mul32(h, c):
    """``h * c mod 2^32`` for int64 tensors holding uint32 values and a
    Python int constant ``c < 2^32``, without int64 overflow: the constant
    splits into 16-bit halves, so each partial product stays below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def lanes_to_int32(h):
    """int64 lanes holding uint32 values -> the same bits as int32."""
    import torch

    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _fmix_torch(x, y):
    h = x ^ y
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _mix_int_torch(v):
    """Murmur lanes of an int64 tensor (plain torch on any device)."""
    lo = v & M32
    hi = (v >> 32) & M32  # arithmetic shift, then mask: the two's-complement hi word
    h1 = _fmix_torch(lo ^ 0x9E3779B9, hi)
    h2 = _fmix_torch(lo ^ 0x85EBCA6B, hi ^ 0xC2B2AE35)
    return h1, h2


def _fnv(mat, lens):
    n = mat.shape[0]
    if not settings.use_device_for(n):
        return _fnv_numpy(mat, lens)
    import torch

    from . import fnv

    dev = settings.resolve_device()
    t0 = time.perf_counter()
    mat = np.ascontiguousarray(mat)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    h1, h2 = fnv.fnv(torch.from_numpy(mat).to(dev),
                     torch.from_numpy(lens).to(dev))
    out = (h1.cpu().numpy().view(np.uint32).copy(),
           h2.cpu().numpy().view(np.uint32).copy())
    devtime.keyed("fnv_lanes", time.perf_counter() - t0,
                mat.nbytes + lens.nbytes, 8 * n)
    return out


def _mix_int(vals_i64):
    n = vals_i64.shape[0]
    if not settings.use_device_for(n):
        return _mix_int_numpy(vals_i64)
    import torch

    dev = settings.resolve_device()
    t0 = time.perf_counter()
    h1, h2 = _mix_int_torch(torch.from_numpy(
        np.ascontiguousarray(vals_i64, dtype=np.int64)).to(dev))
    out = (h1.cpu().numpy().astype(np.uint32),
           h2.cpu().numpy().astype(np.uint32))
    devtime.keyed("mix_int", time.perf_counter() - t0, 8 * n, 16 * n)
    return out


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def _canonical_int(k):
    """Map bools / integral floats to int to mirror Python equality grouping."""
    if isinstance(k, bool):
        return int(k)
    if isinstance(k, float) and k.is_integer():
        return int(k)
    return k


# Per-item key kinds: each maps to exactly one typed hash kernel, so a key
# hashes identically in a homogeneous block and in a mixed one.
_K_INT = 0     # bool / int in int64 range / integral float in range -> _mix_int
_K_STR = 1     # str / bytes -> dual-lane FNV over utf-8 bytes
_K_FBITS = 2   # non-integral or huge float -> _mix_int over float64 bit pattern
_K_OBJ = 3     # everything else -> deterministic canonical-bytes FNV

_I64_LO = -(2 ** 63)
_I64_HI = 2 ** 63 - 1


def _kind_of(k):
    if isinstance(k, np.generic):
        k = k.item()
    if isinstance(k, bool):
        return _K_INT
    if isinstance(k, int):
        if _I64_LO <= k <= _I64_HI:
            return _K_INT
        # Out-of-range int: float bits when exactly representable
        # (10**300 == 1e300), else the canonical-bytes lane.
        try:
            f = float(k)
        except OverflowError:
            return _K_OBJ
        return _K_FBITS if int(f) == k else _K_OBJ
    if isinstance(k, float):
        if k.is_integer() and -(2.0 ** 63) <= k < 2.0 ** 63:
            return _K_INT
        return _K_FBITS
    if isinstance(k, (str, bytes)):
        return _K_STR
    return _K_OBJ


def encode_canonical(k):
    """Deterministic, type-tagged byte encoding of an arbitrary key (the
    object-lane hash input; equal keys encode equally across processes)."""
    if isinstance(k, np.generic):
        k = k.item()
    kind = _kind_of(k)
    if kind == _K_INT:
        return b"i" + str(int(_canonical_int(k))).encode("ascii")
    if kind == _K_FBITS:
        return b"f" + np.float64(k).tobytes()
    if kind == _K_STR:
        return (b"s" + k.encode("utf-8")) if isinstance(k, str) else (b"s" + bytes(k))
    if isinstance(k, int):
        return b"I" + str(k).encode("ascii")
    if k is None:
        return b"N"
    if isinstance(k, tuple):
        return b"(" + _join_lenprefixed(encode_canonical(x) for x in k)
    if isinstance(k, frozenset):
        return b"{" + _join_lenprefixed(sorted(encode_canonical(x) for x in k))
    return b"r" + repr(k).encode("utf-8", "backslashreplace")


def _join_lenprefixed(encs):
    """Length-prefix each element so composite encodings are injective."""
    out = bytearray()
    for e in encs:
        out += len(e).to_bytes(4, "little")
        out += e
    return bytes(out)


def _hash_bytes_list(bs):
    """(h1, h2) for a list of bytes keys: one native C pass below the
    device threshold, else the padded matrix through :func:`_fnv`."""
    if not settings.use_device_for(len(bs)):
        from .. import native

        with devtime.track("codec"):
            res = native.hash_bytes_batch(bs)
        if res is not None:
            return res
    mat, lens = encode_str_keys(bs)
    return _fnv(mat, lens)


def _hash_object_items(items):
    """Canonical-bytes FNV for a list of arbitrary keys -> (h1, h2)."""
    encs = [encode_canonical(_freeze(k)) for k in items]
    h1, h2 = _hash_bytes_list(encs)
    return h1 ^ np.uint32(0xA5A5A5A5), h2 ^ np.uint32(0x3C3C3C3C)


def _hash_kind(kind, items):
    """The single typed kernel for one homogeneous kind of keys."""
    n = len(items)
    if kind == _K_INT:
        return _mix_int(np.fromiter(
            (int(_canonical_int(k)) for k in items), dtype=np.int64, count=n))
    if kind == _K_STR:
        return _hash_bytes_list(
            [k.encode("utf-8") if isinstance(k, str) else bytes(k)
             for k in items])
    if kind == _K_FBITS:
        return _mix_int(np.fromiter(
            (float(k) for k in items), dtype=np.float64, count=n).view(np.int64))
    return _hash_object_items(items)


def hash_keys(keys):
    """Hash a batch of keys -> (h1, h2) uint32 arrays (per-item-kind
    dispatch, so a key hashes the same in any batch)."""
    if isinstance(keys, np.ndarray) and keys.dtype != object:
        if np.issubdtype(keys.dtype, np.integer) or keys.dtype == np.bool_:
            if keys.dtype == np.uint64 and len(keys) and keys.max() > np.uint64(_I64_HI):
                keys = keys.astype(object)
            else:
                return _mix_int(keys.astype(np.int64))
        elif np.issubdtype(keys.dtype, np.floating):
            return _hash_float_array(keys)
        else:
            keys = keys.astype(object)

    keys = list(keys) if not isinstance(keys, np.ndarray) else keys
    n = len(keys)
    if n == 0:
        return (np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.uint32))

    ts = set(map(type, keys))
    if ts == {str} or ts == {bytes}:
        return _hash_kind(_K_STR, keys)
    if ts == {bool}:
        return _mix_int(np.fromiter(keys, dtype=np.int64, count=n))
    if ts == {int}:
        try:
            return _mix_int(np.fromiter(keys, dtype=np.int64, count=n))
        except OverflowError:
            pass  # out-of-int64 ints present: per-item classification
    elif ts == {float}:
        return _hash_float_array(np.fromiter(keys, dtype=np.float64, count=n))

    kinds = np.empty(n, dtype=np.int8)
    for i, k in enumerate(keys):
        kinds[i] = _kind_of(k)

    uniq = set(kinds.tolist())
    if len(uniq) == 1:
        return _hash_kind(uniq.pop(), keys)

    h1 = np.empty(n, dtype=np.uint32)
    h2 = np.empty(n, dtype=np.uint32)
    for kind in uniq:
        idx = np.flatnonzero(kinds == kind)
        a, b = _hash_kind(kind, [keys[i] for i in idx])
        h1[idx] = a
        h2[idx] = b
    return h1, h2


def _hash_float_array(arr):
    """Integral in-range floats hash as ints; the rest on float64 bits."""
    arr64 = arr.astype(np.float64)
    integral = ((arr64 == np.floor(arr64)) & np.isfinite(arr64)
                & (arr64 >= -(2.0 ** 63)) & (arr64 < 2.0 ** 63))
    as_int = np.where(integral, arr64, 0).astype(np.int64)
    bits = arr64.view(np.int64)
    mixed_src = np.where(integral, as_int, bits)
    return _mix_int(mixed_src)


def _freeze(k):
    if isinstance(k, list):
        return tuple(_freeze(x) for x in k)
    if isinstance(k, dict):
        return tuple(sorted((kk, _freeze(vv)) for kk, vv in k.items()))
    if isinstance(k, set):
        return frozenset(k)
    return k


def combine64(h1, h2):
    """Combine the two uint32 lanes into one uint64 per record (host only)."""
    return (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
