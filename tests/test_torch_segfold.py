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

    @pytest.mark.parametrize("k", [1, 3, 8])
    @pytest.mark.parametrize("delta", [-1, 0, 1])
    def test_kernel_tile_edges_match_oracle(self, k, delta):
        """N = 512k - 1, 512k, 512k + 1 records (the CUDA kernel's tile is
        512), with and without an all-invalid tail."""
        n = port_segfold._TILE * k + delta
        rng = np.random.RandomState(n)
        for n_invalid in (0, n // 5):
            case = _sorted_case(rng, max(1, n // 40), n, n_invalid=n_invalid)
            tot, live = _port(*case)
            rtot, rlive = SF.segfold_reference(*case)
            np.testing.assert_array_equal(tot.astype(np.int64), rtot)
            np.testing.assert_array_equal(live.astype(np.uint32), rlive)

    @pytest.mark.parametrize("n", [port_segfold._TILE * 9 + 5,
                                   port_segfold._TILE * 64])
    def test_one_segment_over_every_tile(self, n):
        z = np.zeros(n, np.uint32)
        tot, live = _port(z, z, np.ones(n, np.int32), z)
        assert live.sum() == 1 and live[-1] and tot[-1] == n
        assert not tot[:-1].any()

    def test_all_invalid_tail_of_whole_tiles(self):
        n = port_segfold._TILE * 6
        rng = np.random.RandomState(6)
        case = _sorted_case(rng, 30, n, n_invalid=port_segfold._TILE * 4)
        tot, live = _port(*case)
        rtot, rlive = SF.segfold_reference(*case)
        np.testing.assert_array_equal(tot.astype(np.int64), rtot)
        np.testing.assert_array_equal(live.astype(np.uint32), rlive)
        assert not live[-port_segfold._TILE * 4:].any()

    def test_adj_new_marks_any_lane_change(self):
        a = torch.tensor([1, 1, 2, 2, 2], dtype=torch.int32)
        b = torch.tensor([0, 1, 1, 1, 0], dtype=torch.int32)
        got = port_segfold.adj_new(a, b).tolist()
        assert got == [True, True, True, False, True]


def _gather_inputs(rng, n, n_keys, dedup, zero_frac=0.1, L=8, collide=0.0):
    """The fused entry's inputs as the token fold makes them: keys of
    random (h1, h2) lanes, ``perm`` from a numpy lexsort, the sorted high
    keys, and token rows (one random row per key; a ``collide`` share of
    the rows then gets one byte changed, as a hash collision would)."""
    kh1 = rng.randint(0, 1 << 32, size=n_keys, dtype=np.uint64)
    kh2 = rng.randint(0, 1 << 32, size=n_keys, dtype=np.uint64)
    vocab = rng.randint(0, 256, size=(n_keys, L)).astype(np.uint8)
    ids = rng.randint(0, n_keys, size=n)
    u1, u2 = kh1[ids].astype(np.int64), kh2[ids].astype(np.int64)
    inv = (rng.rand(n) < zero_frac).astype(np.int64)
    lens = np.where(inv == 1, 0, 1 + ids % L).astype(np.int32)
    rows = vocab[ids]
    hit = np.flatnonzero(rng.rand(n) < collide)
    rows[hit, rng.randint(0, L, size=len(hit))] ^= 1
    lines = np.sort(rng.randint(0, max(1, n // 8), size=n)).astype(np.int64)
    high = (inv << 32) | u1
    low = (u2 << 31) | lines if dedup else u2
    perm = np.lexsort((np.arange(n), low, high)) if n else \
        np.zeros(0, np.int64)
    return (perm.astype(np.int64), high[perm], low, rows, lens,
            (inv, u1, u2, lines))


def _gather_oracle(perm, rows, lens, raw, dedup):
    """The six outputs by the reference's numpy oracle
    ``segfold_reference`` and plain loops for the representatives and the
    collision count."""
    inv, u1, u2, lines = (x[perm] for x in raw)
    n = len(perm)
    starts = np.ones(n, bool)
    firsts = np.ones(n, bool)
    if n > 1:
        starts[1:] = ((inv[1:] != inv[:-1]) | (u1[1:] != u1[:-1])
                      | (u2[1:] != u2[:-1]))
        firsts[1:] = starts[1:] | (lines[1:] != lines[:-1])
    v = ((firsts if dedup else np.ones(n, bool)) & (inv == 0)).astype(
        np.int32)
    tot, live = SF.segfold_reference(u1.astype(np.uint32),
                                     u2.astype(np.uint32), v,
                                     inv.astype(np.uint32))
    rep = np.zeros(n, np.int64)
    collisions = 0
    for j in range(n):
        rep[j] = perm[j] if starts[j] else rep[j - 1]
        r, q = rep[j], perm[j]
        if inv[j] == 0 and (lens[q] != lens[r] or (rows[q] != rows[r]).any()):
            collisions += 1
    return (u1.astype(np.uint32), u2.astype(np.uint32), tot, live, rep,
            collisions)


def _gather(perm, shigh, low, rows, lens, dedup):
    got = port_segfold.segfold_gather(
        *(torch.from_numpy(x) for x in (perm, shigh, low, rows, lens)),
        dedup)
    return [t.numpy() for t in got]


class TestSegfoldGather:
    @pytest.mark.parametrize("dedup", [False, True])
    @pytest.mark.parametrize("n,n_keys,zero_frac", [
        (0, 1, 0.0), (1, 1, 0.0), (511, 40, 0.2), (512, 40, 0.2),
        (513, 40, 0.2), (3000, 1, 0.0), (4099, 600, 0.5), (2048, 5, 1.0)])
    def test_matches_oracle(self, n, n_keys, zero_frac, dedup):
        rng = np.random.RandomState(n + n_keys)
        *args, raw = _gather_inputs(rng, n, n_keys, dedup, zero_frac)
        sh1, sh2, tot, live, rep, collisions = _gather(*args, dedup)
        w1, w2, wtot, wlive, wrep, wcoll = _gather_oracle(
            args[0], args[3], args[4], raw, dedup)
        np.testing.assert_array_equal(sh1.view(np.uint32), w1)
        np.testing.assert_array_equal(sh2.view(np.uint32), w2)
        np.testing.assert_array_equal(tot.astype(np.int64), wtot)
        np.testing.assert_array_equal(live.astype(np.uint32), wlive)
        np.testing.assert_array_equal(rep, wrep)
        assert collisions.shape == () and int(collisions) == wcoll == 0

    @pytest.mark.parametrize("dedup", [False, True])
    @pytest.mark.parametrize("n,n_keys,L,collide", [
        (1537, 30, 8, 0.05), (2000, 1, 16, 0.01), (999, 80, 13, 0.1)])
    def test_collisions_match_oracle(self, n, n_keys, L, collide, dedup):
        """Rows that differ from their segment's representative count,
        valid ones only, whatever the row width."""
        rng = np.random.RandomState(n + L)
        *args, raw = _gather_inputs(rng, n, n_keys, dedup, 0.2, L=L,
                                    collide=collide)
        got = _gather(*args, dedup)
        want = _gather_oracle(args[0], args[3], args[4], raw, dedup)
        assert want[5] > 0
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w)

    def test_gather_agrees_with_the_contract_entry(self):
        """The fused entry's tot/live equal the contract entry's on the
        same sorted lanes and contributions."""
        rng = np.random.RandomState(9)
        *args, _raw = _gather_inputs(rng, 5000, 300, True)
        t = [torch.from_numpy(x) for x in args]
        sh1, sh2, tot, live, _, _ = port_segfold.segfold_gather(*t, True)
        _starts, v = port_segfold.segment_marks(t[1], t[2][t[0]], True)
        sinv = (t[1] >> 32).to(torch.int32)
        ctot, clive = port_segfold.segfold(sh1, sh2, v, sinv)
        assert torch.equal(tot, ctot) and torch.equal(live, clive)
