"""Native host codec: builds and binds the C++ tokenizer via ctypes.

Port of ``dampr_tpu/native`` (the same ``tokenizer.cpp``, copied).  The
shared object compiles with g++ on first use into ``native/_build/``
(gitignored, and outside the importable module path), once across
processes (a lock file beside it); set ``DAMPR_TPU_NATIVE=0`` to force
the pure-numpy paths.
"""

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("dampr_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tokenizer.cpp")
_SO = os.path.join(_HERE, "_build", "libtokenizer.so")

_lock = threading.Lock()
_lib = None
_disabled = False
#: mtime of the shared object that last failed to load (None: no failure);
#: a later call retries only once the file has changed
_failed_mtime = None


def _so_mtime():
    try:
        return os.path.getmtime(_SO)
    except OSError:
        return None


def _build():
    """Compile into a per-process temp file, then rename it over the
    shared object: a reader never maps a half-written library."""
    tmp = "{}.{}.tmp".format(_SO, os.getpid())
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd + ["-march=native"], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, OSError):
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def _build_if_stale():
    """Build the shared object unless an up-to-date one exists, under an
    exclusive lock file beside it, so concurrent processes (test workers)
    compile it once and the others wait for that build."""
    import fcntl

    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            mtime = _so_mtime()
            if mtime is None or mtime < os.path.getmtime(_SRC):
                _build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib):
    fc = lib.dampr_token_counts
    fc.restype = ctypes.c_long
    fc.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fb = lib.dampr_hash_bytes_batch
    fb.restype = None
    fb.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fp = lib.dampr_parse_i64
    fp.restype = ctypes.c_long
    fp.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return lib


def get_lib():
    """The loaded native library, or None when unavailable/disabled.  A
    failed build or load is retried once the shared object has changed
    (another process finished building it), never left failed for the
    process."""
    global _lib, _disabled, _failed_mtime
    if _lib is not None or _disabled:
        return _lib
    if _failed_mtime is not None and _so_mtime() in (None, _failed_mtime):
        return None
    with _lock:
        if _lib is not None or _disabled:
            return _lib
        if os.environ.get("DAMPR_TPU_NATIVE", "1") in ("0", "false"):
            _disabled = True
            return None
        try:
            _build_if_stale()
            _lib = _bind(ctypes.CDLL(_SO))
            _failed_mtime = None
        except (OSError, AttributeError,
                subprocess.CalledProcessError) as exc:
            log.warning("native tokenizer unavailable (%s); using numpy", exc)
            _failed_mtime = _so_mtime() or 0.0
    return _lib


def hash_bytes_batch(bs):
    """Dual-lane FNV over a list of bytes keys in one C pass: (h1, h2)
    uint32 arrays, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(bs)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(b) for b in bs), dtype=np.int64, count=n),
              out=offs[1:])
    buf = np.frombuffer(b"".join(bs), dtype=np.uint8)
    h1 = np.empty(n, dtype=np.uint32)
    h2 = np.empty(n, dtype=np.uint32)
    lib.dampr_hash_bytes_batch(
        np.ascontiguousarray(buf).ctypes.data, offs.ctypes.data, n,
        h1.ctypes.data, h2.ctypes.data)
    return h1, h2


def parse_i64(buf):
    """Whitespace-separated int64 parse of a uint8 buffer in one C pass:
    an int64 array, or None when the native library is unavailable.
    Raises ValueError on the first unparsable or out-of-range token (the
    numpy parse's error)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf)
    n = len(buf)
    out = np.empty(n // 2 + 1, dtype=np.int64)
    bad = ctypes.c_long(-1)
    count = lib.dampr_parse_i64(buf.ctypes.data, n, out.ctypes.data,
                                ctypes.byref(bad))
    if bad.value >= 0:
        raise ValueError(
            "unparsable numeric token at index {}".format(bad.value))
    return out[:count].copy()


def token_counts(buf, mode, lower, dedup_per_line):
    """Fused native tokenize+hash+count: (h1, h2, counts, rep_starts,
    rep_lens) over distinct tokens, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buf)
    cap = n // 2 + 1
    h1 = np.empty(cap, dtype=np.uint32)
    h2 = np.empty(cap, dtype=np.uint32)
    counts = np.empty(cap, dtype=np.int64)
    starts = np.empty(cap, dtype=np.int64)
    lens = np.empty(cap, dtype=np.int32)
    buf = np.ascontiguousarray(buf)
    k = lib.dampr_token_counts(
        buf.ctypes.data, n, int(mode), int(lower), int(dedup_per_line),
        h1.ctypes.data, h2.ctypes.data, counts.ctypes.data,
        starts.ctypes.data, lens.ctypes.data)
    if k < 0:
        return None
    return h1[:k], h2[:k], counts[:k], starts[:k], lens[:k]
