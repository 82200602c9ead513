"""State carried across from the JAX package, as plain numpy.

This system has no weights: its state between layers is Blocks (key and
value columns plus cached hash lanes) and device program inputs.  These
helpers build the port's objects from numpy arrays taken out of the JAX
package (``blk.keys, blk.values, blk.h1, blk.h2``; a program's padded
``mat, lens, lines``), so both packages can be fed the same partials and
matrices.  Nothing of ``dampr_tpu`` is imported here.
"""

import numpy as np
import torch

from .blocks import Block


def block_from_arrays(keys, values, h1=None, h2=None):
    """The port's Block over copies of a Block's numpy lanes (hash lanes
    as uint32, or None to hash lazily)."""
    lane = (lambda h: None if h is None
            else np.array(h, dtype=np.uint32, copy=True))
    return Block(np.array(keys, copy=True), np.array(values, copy=True),
                 lane(h1), lane(h2))


def program_inputs(mat, lens, lines, device):
    """numpy program inputs -> the tensors :func:`.ops.lower.token_fold`
    takes: ``mat`` uint8 [n, L], ``lens`` and ``lines`` int32 [n]."""
    device = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(lines, dtype=np.int32))
            .to(device))
