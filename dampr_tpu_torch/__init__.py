"""dampr_tpu_torch — the PyTorch/CUDA port of dampr_tpu.

A second package beside the JAX one, with the same fluent API.  Its device
layer is PyTorch on an explicit ``settings.device`` ("cuda" by default);
the JAX package's two Pallas kernels are hand-written CUDA C++ for Hopper
(``csrc/fnv.cu``, ``csrc/segfold.cu``), built with ``nvcc`` on first use.
It imports neither ``jax`` nor ``dampr_tpu``.

This slice runs the main path — text -> token-count / doc-freq scanner ->
sum fold -> read / sink_tsv — lowered onto the card::

    >>> import operator
    >>> from dampr_tpu_torch import Dampr
    >>> from dampr_tpu_torch.ops.text import DocFreq
    >>> (Dampr.text("corpus.txt")
    ...  .custom_mapper(DocFreq(mode="word", lower=True, pair_values=False))
    ...  .fold_values(operator.add).read())            # doctest: +SKIP
"""

import logging

from .blocks import Block, BlockBuilder
from .dampr import ARReduce, Dampr, PBase, PMap, RunStats, ValueEmitter
from .runner import MTRunner

__all__ = ["Dampr", "PBase", "PMap", "ARReduce", "ValueEmitter", "RunStats",
           "MTRunner", "Block", "BlockBuilder"]

logging.getLogger("dampr_tpu_torch").addHandler(logging.NullHandler())
