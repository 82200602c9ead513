"""dampr_tpu_torch — the PyTorch/CUDA port of dampr_tpu.

A second package beside the JAX one, with the same fluent API.  Its device
layer is PyTorch on an explicit ``settings.device`` ("cuda" by default);
the JAX package's two Pallas kernels are hand-written CUDA C++ for Hopper
(``csrc/fnv.cu``, ``csrc/segfold.cu``), built with ``nvcc`` on first use.
It imports neither ``jax`` nor ``dampr_tpu``.

The port runs ``examples/wc.py``'s word count (a ``flat_map`` of
lambdas, fused with its re-key into one batched map stage, whose
map-side combine hashes on the card)::

    >>> from dampr_tpu_torch import Dampr
    >>> wc = (Dampr.text("corpus.txt")
    ...       .flat_map(lambda line: line.split())
    ...       .fold_by(lambda w: w, binop=lambda x, y: x + y,
    ...                value=lambda w: 1))
    >>> wc.read()                                       # doctest: +SKIP

and the TF-IDF benchmark's pipeline, with the scanner -> sum fold edge
lowered onto the card::

    >>> import math, operator
    >>> from dampr_tpu_torch import Dampr
    >>> from dampr_tpu_torch.ops.text import DocFreq
    >>> docs = Dampr.text("corpus.txt")
    >>> df = (docs.custom_mapper(DocFreq(mode="word", lower=True,
    ...                                  pair_values=False))
    ...       .fold_values(operator.add))
    >>> idf = df.cross_right(docs.len(), lambda d, total: (
    ...     d[0], d[1], math.log(1 + float(total) / d[1])), memory=True)
    >>> idf.sink_tsv("idf").run()                       # doctest: +SKIP
"""

import logging

from .base import (BlockMapper, BlockReducer, Map, Mapper, Reduce, Reducer,
                   StreamMapper, StreamReducer, Streamable)
from .blocks import Block, BlockBuilder
from .dampr import (ARReduce, Dampr, PBase, PJoin, PMap, PReduce, RunStats,
                    ValueEmitter, setup_logging)
from .dataset import (BlockDataset, CatDataset, Chunker, Dataset,
                      EmptyDataset, GzipLineDataset, MemoryDataset,
                      TextLineDataset)
from .graph import Graph, Source
from .inputs import MemoryInput, PathInput, TextInput, UrlsInput
from .runner import MTRunner

__all__ = [
    "Dampr", "PBase", "PMap", "PReduce", "PJoin", "ARReduce", "ValueEmitter",
    "RunStats",
    "Mapper", "Streamable", "Map", "BlockMapper", "StreamMapper",
    "Reducer", "Reduce", "BlockReducer", "StreamReducer",
    "Graph", "Source", "MTRunner",
    "Dataset", "Chunker", "EmptyDataset", "MemoryDataset", "TextLineDataset",
    "CatDataset", "BlockDataset", "GzipLineDataset",
    "MemoryInput", "PathInput", "TextInput", "UrlsInput",
    "Block", "BlockBuilder",
    "setup_logging",
]

logging.getLogger("dampr_tpu_torch").addHandler(logging.NullHandler())
