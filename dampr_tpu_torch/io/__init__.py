"""Spill I/O: chunked-frame spill files, per-frame codecs, a budget-charged
background writer pool, and prefetching frame readers.

Port of ``dampr_tpu/io``: :mod:`.frames` is the on-disk format (shared
byte for byte with the JAX package), :mod:`.codecs` the per-frame
compression registry, and :mod:`.writer` the bounded writer pool whose
bytes in flight count against the stage's memory budget.
"""

from .codecs import Codec, MissingCodecError, available, resolve  # noqa: F401
from .frames import (FrameFormatError, FrameReader, FrameWriter,  # noqa: F401
                     is_frame_file)
from .writer import SpillWriterPool  # noqa: F401
