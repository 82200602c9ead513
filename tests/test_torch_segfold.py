"""dampr_tpu_torch segmented fold against the JAX package.

The port's ``ops.segfold.segfold`` (on CPU tensors: its plain torch version,
the cumsum/cummax chain) must equal, position by position,
``dampr_tpu.ops.pallas_segfold.segfold_sorted`` in interpret mode (one or
two 8192-record tiles, as interpret mode is slow) and the host oracle
``segfold_reference`` — on the cases of tests/test_pallas_segfold.py plus
ragged sizes the port's kernel takes without padding.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from dampr_tpu.ops import pallas_segfold as SF
from dampr_tpu_torch.ops import segfold as port_segfold

TILE = SF._tile_elems()


def _sorted_case(rng, n_keys, n, max_v=9, n_invalid=0):
    """Random lanes sorted by (inv, h1, h2) like the engine sorts them."""
    kh1 = rng.randint(0, 1 << 32, size=n_keys, dtype=np.uint64).astype(
        np.uint32)
    kh2 = rng.randint(0, 1 << 32, size=n_keys, dtype=np.uint64).astype(
        np.uint32)
    ids = np.sort(rng.randint(0, n_keys, size=n - n_invalid))
    h1 = np.concatenate([kh1[ids], np.zeros(n_invalid, np.uint32)])
    h2 = np.concatenate([kh2[ids], np.zeros(n_invalid, np.uint32)])
    inv = np.zeros(n, dtype=np.uint32)
    inv[n - n_invalid:] = 1
    v = rng.randint(0, max_v + 1, size=n).astype(np.int32)
    order = np.lexsort((h2, h1, inv))
    return h1[order], h2[order], v[order], inv[order]


def _pad(h1, h2, v, inv):
    npad = -(-len(h1) // TILE) * TILE
    pad = npad - len(h1)
    if pad:
        h1 = np.concatenate([h1, np.zeros(pad, h1.dtype)])
        h2 = np.concatenate([h2, np.zeros(pad, h2.dtype)])
        v = np.concatenate([v, np.zeros(pad, v.dtype)])
        inv = np.concatenate([inv, np.ones(pad, inv.dtype)])
    return h1, h2, v, inv


def _port(h1, h2, v, inv):
    t = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
         for x in (h1, h2, v, inv)]
    tot, live = port_segfold.segfold(*t)
    return tot.numpy(), live.numpy()


def _case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "single_tile":
        return _pad(*_sorted_case(rng, 50, TILE))
    if name == "two_tiles_with_carry":
        return _pad(*_sorted_case(rng, 300, 2 * TILE))
    if name == "segment_spanning_tiles":
        n = 2 * TILE
        return (np.zeros(n, np.uint32), np.zeros(n, np.uint32),
                np.ones(n, np.int32), np.zeros(n, np.uint32))
    if name == "invalid_tail":
        return _pad(*_sorted_case(rng, 40, TILE, n_invalid=500))
    if name == "every_element_distinct":
        h = np.arange(TILE, dtype=np.uint32) * np.uint32(2654435761)
        h = np.sort(h)
        return h, h.copy(), np.full(TILE, 3, np.int32), \
            np.zeros(TILE, np.uint32)
    if name == "high_lanes":
        h1, h2, v, inv = _sorted_case(rng, 64, TILE)
        return h1 | np.uint32(1 << 31), h2, v, inv
    raise ValueError(name)


TILE_CASES = ["single_tile", "two_tiles_with_carry", "segment_spanning_tiles",
              "invalid_tail", "every_element_distinct", "high_lanes"]


class TestSegfoldParity:
    @pytest.mark.parametrize("case", TILE_CASES)
    def test_matches_pallas_interpret_and_oracle(self, case):
        h1, h2, v, inv = _case(case)
        tot, live = _port(h1, h2, v, inv)
        ptot, plive = SF.segfold_sorted(h1, h2, v, inv, interpret=True)
        np.testing.assert_array_equal(tot, np.asarray(ptot))
        np.testing.assert_array_equal(live.astype(np.uint32),
                                      np.asarray(plive))
        rtot, rlive = SF.segfold_reference(h1, h2, v, inv)
        np.testing.assert_array_equal(tot.astype(np.int64), rtot)
        np.testing.assert_array_equal(live.astype(np.uint32), rlive)

    @pytest.mark.parametrize("n", [1, 2, 7, 1000, 2049, 12289])
    def test_ragged_sizes_match_oracle(self, n):
        """No tile padding: any N, with and without an invalid tail."""
        rng = np.random.RandomState(n)
        for n_invalid in (0, n // 3):
            case = _sorted_case(rng, max(1, n // 4), n, n_invalid=n_invalid)
            tot, live = _port(*case)
            rtot, rlive = SF.segfold_reference(*case)
            np.testing.assert_array_equal(tot.astype(np.int64), rtot)
            np.testing.assert_array_equal(live.astype(np.uint32), rlive)

    def test_empty_input(self):
        e = torch.empty(0, dtype=torch.int32)
        tot, live = port_segfold.segfold(e, e, e, e)
        assert tot.shape == (0,) and live.shape == (0,)

    def test_adj_new_marks_any_lane_change(self):
        a = torch.tensor([1, 1, 2, 2, 2], dtype=torch.int32)
        b = torch.tensor([0, 1, 1, 1, 0], dtype=torch.int32)
        got = port_segfold.adj_new(a, b).tolist()
        assert got == [True, True, True, False, True]
