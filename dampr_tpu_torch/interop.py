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


def handoff_vocab_from_arrays(state, dedup, store=None, device="cpu",
                              budget=1 << 40):
    """The port's :class:`~.ops.handoff.HandoffVocab` holding a reference
    ``HandoffVocab``'s state, taken out as numpy and Python lists:
    ``tab_h1`` (uint32 [cap], sorted), ``tab_slot``/``tab_lens`` (int32
    [cap]), ``tab_mat`` (uint8 [cap, Lcap]), ``acc`` ([cap + 1], any integer
    dtype), ``cap``, ``Lcap``, and the host lists ``keys``, ``slot_bytes``,
    ``h1``, ``h2``; optionally ``total_added``, ``table_mode``,
    ``tab_dirty`` and ``lanes_deferred``.  Both packages can then probe the
    same table."""
    from .ops.handoff import HandoffVocab

    dev = torch.device(device)
    hv = HandoffVocab(store, dedup, budget=budget, device=dev)

    def lane(name, dtype):
        return torch.from_numpy(np.array(state[name], dtype=dtype,
                                         copy=True)).to(dev)

    hv.cap = int(state["cap"])
    hv.Lcap = int(state["Lcap"])
    hv.tab_h1 = torch.from_numpy(np.array(state["tab_h1"], dtype=np.uint32)
                                 .view(np.int32)).to(dev)
    hv.tab_slot = lane("tab_slot", np.int32)
    hv.tab_lens = lane("tab_lens", np.int32)
    hv.tab_mat = lane("tab_mat", np.uint8)
    hv.acc = lane("acc", np.int64)
    hv.keys = list(state["keys"])
    hv.slot_bytes = [bytes(b) for b in state["slot_bytes"]]
    hv.h1 = [int(h) for h in state["h1"]]
    hv.h2 = [int(h) for h in state["h2"]]
    hv.nslots = len(hv.keys)
    hv.bytes2slot = {b: i for i, b in enumerate(hv.slot_bytes)}
    hv.total_added = int(state.get("total_added",
                                   np.asarray(state["acc"]).sum()))
    hv.table_mode = bool(state.get("table_mode", False))
    hv._tab_dirty = bool(state.get("tab_dirty", False))
    hv._lanes_deferred = int(state.get("lanes_deferred", 0))
    return hv
