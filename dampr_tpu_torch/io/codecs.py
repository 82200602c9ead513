"""Frame codecs of the chunked spill format.

Port of ``dampr_tpu/io/codecs.py``.  Every spill frame records the codec
that compressed it as a one-byte id, so files written under different
settings (or by the JAX package) coexist in one directory and decode:

======  ====  ==========================================================
name    id    notes
======  ====  ==========================================================
raw     0     no compression (numeric lanes are mostly high-entropy)
zlib    1     raw DEFLATE stream, level from the caller (or ``"zlib:N"``)
gzip    2     gzip member bytes
lz4     3     ``lz4.frame``, when the module is installed
zstd    4     ``zstandard``, when the module is installed
======  ====  ==========================================================

Encoding with a codec whose module is missing falls down the
``zstd -> lz4 -> zlib`` ladder and logs the choice once; decoding a frame
whose codec module is missing raises :class:`MissingCodecError`.
"""

import gzip
import logging
import zlib

from ..obs import log as _obslog

log = logging.getLogger("dampr_tpu_torch.io.codecs")

RAW, ZLIB, GZIP, LZ4, ZSTD = 0, 1, 2, 3, 4

_NAMES = {RAW: "raw", ZLIB: "zlib", GZIP: "gzip", LZ4: "lz4", ZSTD: "zstd"}
_IDS = {v: k for k, v in _NAMES.items()}
_IDS["none"] = RAW

_logged = set()


def _log_once(key, level, msg, *args):
    if key not in _logged:
        _logged.add(key)
        log.log(level, msg, *args)


class Codec(object):
    """One (id, name, level) encoder/decoder over whole frame payloads
    (bounded by the spill window, so a few MB at most)."""

    __slots__ = ("cid", "name", "level")

    def __init__(self, cid, level=None):
        self.cid = cid
        self.name = _NAMES[cid]
        self.level = level

    def __repr__(self):
        if self.level is None:
            return "Codec[{}]".format(self.name)
        return "Codec[{}:{}]".format(self.name, self.level)

    def compress(self, data):
        if self.cid == RAW:
            return data
        if self.cid == ZLIB:
            return zlib.compress(data, self.level)
        if self.cid == GZIP:
            return gzip.compress(data, compresslevel=self.level)
        if self.cid == LZ4:
            import lz4.frame

            return lz4.frame.compress(data, compression_level=self.level)
        if self.cid == ZSTD:
            import zstandard

            return zstandard.ZstdCompressor(level=self.level).compress(data)
        raise ValueError("unknown codec id {}".format(self.cid))

    def decompress(self, data):
        return decompress(self.cid, data)


class MissingCodecError(RuntimeError):
    """A frame's codec module is not installed here."""


def decompress(cid, data):
    """Decode one frame payload by its recorded codec id."""
    if cid == RAW:
        return data
    if cid == ZLIB:
        return zlib.decompress(data)
    if cid == GZIP:
        return gzip.decompress(data)
    if cid == LZ4:
        try:
            import lz4.frame
        except ImportError:
            raise MissingCodecError(
                "spill frame compressed with lz4 but the 'lz4' module is "
                "not installed")
        return lz4.frame.decompress(data)
    if cid == ZSTD:
        try:
            import zstandard
        except ImportError:
            raise MissingCodecError(
                "spill frame compressed with zstd but the 'zstandard' "
                "module is not installed")
        return zstandard.ZstdDecompressor().decompress(data)
    raise MissingCodecError("unknown spill frame codec id {}".format(cid))


def available(name):
    """Can ``name`` encode here?"""
    if name in ("raw", "none", "zlib", "gzip"):
        return True
    try:
        if name == "lz4":
            import lz4.frame  # noqa: F401
            return True
        if name == "zstd":
            import zstandard  # noqa: F401
            return True
    except ImportError:
        return False
    return False


#: Preference ladder for "auto" and for an unavailable explicit choice.
_LADDER = ("zstd", "lz4", "zlib")

#: lz4/zstd levels live on their own scales; zlib/gzip take the caller's.
_DEFAULT_LEVELS = {"lz4": 0, "zstd": 3}


def resolve(name, default_level=1):
    """``"zlib"``, ``"zlib:6"``, ``"auto"``, ... -> :class:`Codec`, falling
    down the ladder when an optional codec is missing."""
    spec = str(name).lower()
    name = spec
    level = None
    if ":" in name:
        name, _, lev = name.partition(":")
        try:
            level = int(lev)
        except ValueError:
            raise ValueError("bad codec level in {!r}".format(spec))
    if name != "auto" and name not in _IDS:
        raise ValueError("unknown spill codec {!r}".format(name))
    if name == "auto":
        for cand in _LADDER:
            if available(cand):
                name = cand
                break
        _log_once(("auto", name), logging.INFO,
                  "spill codec 'auto' resolved to %r", name)
    elif name not in ("raw", "none") and not available(name):
        for cand in _LADDER:
            if available(cand):
                if ("fallback", name) not in _logged:
                    _logged.add(("fallback", name))
                    _obslog.warn("codec-fallback",
                                 "spill codec %r unavailable; falling back "
                                 "to %r", name, cand, logger=log, codec=name)
                name = cand
                # the requested level was on the requested codec's scale
                level = None
                break
    cid = _IDS[name]
    if level is None:
        level = _DEFAULT_LEVELS.get(name, default_level)
    return Codec(cid, level)
