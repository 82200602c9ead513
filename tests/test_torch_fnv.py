"""dampr_tpu_torch FNV and key hashing against the JAX package.

The port's ``ops.fnv.fnv`` (on CPU tensors: its plain torch version) and
``ops.hashing`` must give lanes bit-identical to ``dampr_tpu.ops.hashing``'s
numpy path, its jitted ``_fnv_jit`` and the Pallas ``fnv_pallas`` (interpret
mode).  Tolerance: exact — the lanes are integers.
"""

import numpy as np
import pytest
import torch

from dampr_tpu.ops import hashing as ref_hashing
from dampr_tpu.ops.pallas_fnv import fnv_pallas
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import fnv as port_fnv
from dampr_tpu_torch.ops import hashing as port_hashing

from conftest import reference_text


@pytest.fixture(autouse=True)
def cpu_device():
    old = port_settings.device
    port_settings.device = "cpu"
    yield
    port_settings.device = old


def _port_lanes(mat, lens):
    h1, h2 = port_fnv.fnv(torch.from_numpy(mat),
                          torch.from_numpy(lens.astype(np.int32)))
    return h1.numpy().view(np.uint32), h2.numpy().view(np.uint32)


def _case(name):
    rng = np.random.RandomState(7)
    if name == "words":
        return ref_hashing.encode_str_keys((reference_text() * 3).split())
    if name == "high_bytes_and_empty":
        return ref_hashing.encode_str_keys(
            ["", "é" * 20, "\xff\x80 mixed", "plain"])
    if name.startswith("rows_"):
        n = int(name[5:])
        return ref_hashing.encode_str_keys(["k%d" % i for i in range(n)])
    if name == "random_bytes_ragged":
        mat = rng.randint(0, 256, size=(700, 32)).astype(np.uint8)
        return mat, rng.randint(0, 33, size=700).astype(np.int32)
    raise ValueError(name)


CASES = ["words", "high_bytes_and_empty", "rows_1", "rows_511", "rows_512",
         "rows_513", "random_bytes_ragged"]


class TestFnvParity:
    @pytest.mark.parametrize("case", CASES)
    def test_matches_numpy_jit_and_pallas(self, case):
        mat, lens = _case(case)
        p1, p2 = _port_lanes(mat, lens)
        w1, w2 = ref_hashing._fnv_numpy(mat, lens)
        np.testing.assert_array_equal(p1, w1)
        np.testing.assert_array_equal(p2, w2)
        j1, j2 = ref_hashing._fnv_jit()(mat, lens)
        np.testing.assert_array_equal(p1, np.asarray(j1))
        np.testing.assert_array_equal(p2, np.asarray(j2))
        k1, k2 = fnv_pallas(mat, lens, interpret=True)
        np.testing.assert_array_equal(p1, k1)
        np.testing.assert_array_equal(p2, k2)

    def test_lanes_at_and_above_2_31(self):
        """Both halves of the unsigned range occur, and the upper half
        survives the int32 bit-pattern round trip exactly."""
        mat, lens = _case("words")
        p1, p2 = _port_lanes(mat, lens)
        w1, w2 = ref_hashing._fnv_numpy(mat, lens)
        for p, w in ((p1, w1), (p2, w2)):
            assert (w >= 2 ** 31).any() and (w < 2 ** 31).any()
            np.testing.assert_array_equal(p, w)

    def test_lengths_past_width_and_negative_clamp(self):
        rng = np.random.RandomState(3)
        mat = rng.randint(0, 256, size=(300, 16)).astype(np.uint8)
        lens = rng.randint(-4, 40, size=300).astype(np.int32)
        p1, p2 = _port_lanes(mat, lens)
        w1, w2 = ref_hashing._fnv_numpy(mat, lens)
        np.testing.assert_array_equal(p1, w1)
        np.testing.assert_array_equal(p2, w2)

    def test_encode_and_len_bucket_match(self):
        keys = ["", "a", "x" * 9, "y" * 1000, "z" * 1500, b"raw\x00bytes"]
        pm, pl = port_hashing.encode_str_keys(keys)
        rm, rl = ref_hashing.encode_str_keys(keys)
        np.testing.assert_array_equal(pm, rm)
        np.testing.assert_array_equal(pl, rl)
        for n in (1, 8, 9, 1024, 1025, 5000):
            assert port_hashing._len_bucket(n) == ref_hashing._len_bucket(n)


def _pr1_sort_keys(mat, lens, lines):
    """The two int64 sort keys as the token fold built them in torch
    before the FNV kernel wrote them (from the reference's numpy lanes)."""
    h1, h2 = ref_hashing._fnv_numpy(mat, lens)
    inv = (lens <= 0).astype(np.int64)
    u1, u2 = h1.astype(np.int64), h2.astype(np.int64)
    low = u2 if lines is None else (u2 << 31) | lines.astype(np.int64)
    return low, (inv << 32) | u1


class TestFnvSortKeys:
    @pytest.mark.parametrize("dedup", [False, True])
    @pytest.mark.parametrize("case", CASES + ["lens_past_width"])
    def test_keys_match_pr1_keys_and_reference_lanes(self, case, dedup):
        if case == "lens_past_width":
            rng = np.random.RandomState(3)
            mat = rng.randint(0, 256, size=(300, 16)).astype(np.uint8)
            lens = rng.randint(-4, 40, size=300).astype(np.int32)
        else:
            mat, lens = _case(case)
        rng = np.random.RandomState(len(lens))
        lines = (np.sort(rng.randint(0, 2 ** 31, size=len(lens)))
                 .astype(np.int32) if dedup else None)
        low, high = port_fnv.fnv_sort_keys(
            torch.from_numpy(mat), torch.from_numpy(lens.astype(np.int32)),
            torch.from_numpy(lines) if dedup else None)
        low, high = low.numpy(), high.numpy()
        want_low, want_high = _pr1_sort_keys(mat, lens, lines)
        np.testing.assert_array_equal(low, want_low)
        np.testing.assert_array_equal(high, want_high)
        # the lanes inside the keys are the JAX package's lanes
        u1 = (high & 0xFFFFFFFF).astype(np.uint32)
        u2 = ((low >> 31) if dedup else low).astype(np.uint32)
        j1, j2 = ref_hashing._fnv_jit()(mat, lens)
        np.testing.assert_array_equal(u1, np.asarray(j1))
        np.testing.assert_array_equal(u2, np.asarray(j2))
        k1, k2 = fnv_pallas(mat, lens, interpret=True)
        np.testing.assert_array_equal(u1, k1)
        np.testing.assert_array_equal(u2, k2)
        np.testing.assert_array_equal(high >> 32, (lens <= 0))
        if dedup:
            np.testing.assert_array_equal(low & 0x7FFFFFFF, lines)

    @pytest.mark.parametrize("dedup", [False, True])
    def test_pack_and_unpack_sort_keys_round_trip(self, dedup):
        """The packing helpers invert each other over the whole range of
        each field: lanes of 0 and 2^32 - 1, lines of 0 and 2^31 - 1."""
        rng = np.random.RandomState(11)
        n = 1000
        u1 = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
        u2 = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
        u1[:2], u2[:2] = (0, 2 ** 32 - 1), (2 ** 32 - 1, 0)
        inv = rng.rand(n) < 0.3
        lines = rng.randint(0, 2 ** 31, size=n).astype(np.int32)
        lines[:2] = (0, 2 ** 31 - 1)
        t = {k: torch.from_numpy(x.astype(np.int64)) for k, x in
             (("u1", u1), ("u2", u2), ("inv", inv))}
        low, high = port_fnv.pack_sort_keys(
            t["u1"], t["u2"], t["inv"],
            torch.from_numpy(lines) if dedup else None)
        want_low, want_high = (
            (u2.astype(np.int64) << 31) | lines if dedup
            else u2.astype(np.int64)), ((inv.astype(np.int64) << 32)
                                        | u1.astype(np.int64))
        np.testing.assert_array_equal(low.numpy(), want_low)
        np.testing.assert_array_equal(high.numpy(), want_high)
        g1, g2, ginv = port_fnv.unpack_sort_keys(low, high, dedup)
        np.testing.assert_array_equal(g1.numpy(), u1.astype(np.int64))
        np.testing.assert_array_equal(g2.numpy(), u2.astype(np.int64))
        np.testing.assert_array_equal(ginv.numpy(), inv.astype(np.int64))

    def test_empty_matrix(self):
        low, high = port_fnv.fnv_sort_keys(
            torch.zeros((0, 8), dtype=torch.uint8),
            torch.zeros(0, dtype=torch.int32))
        assert low.shape == (0,) and high.shape == (0,)
        assert low.dtype == torch.int64 and high.dtype == torch.int64


def _mixed_keys(kind, n, seed):
    rng = np.random.RandomState(seed)
    ints = rng.randint(-2 ** 62, 2 ** 62, size=n, dtype=np.int64)
    if kind == "str":
        return ["tok%d_%s" % (i, "é" * (i % 3)) for i in ints.tolist()]
    if kind == "bytes":
        return [("b%d" % i).encode() for i in ints.tolist()]
    if kind == "int":
        return ints.tolist()
    if kind == "int_array":
        return ints
    if kind == "float":
        return (rng.rand(n) * 1e6 - 5e5).tolist() + [1.0, 2.0 ** 70, -0.0]
    if kind == "mixed":
        base = [1, 1.0, True, "1", b"1", (1, "a"), None, 2 ** 70, 10 ** 300,
                frozenset([1, 2]), 3.5, -7]
        return (base * (n // len(base) + 1))[:n]
    raise ValueError(kind)


class TestHashKeysParity:
    @pytest.mark.parametrize("kind", ["str", "bytes", "int", "int_array",
                                      "float", "mixed"])
    @pytest.mark.parametrize("n", [100, 5000])
    def test_hash_keys_matches_reference(self, kind, n):
        """Below and above the device-dispatch threshold (4096 on the CPU
        device): the port's torch lanes equal the reference's."""
        keys = _mixed_keys(kind, n, seed=n)
        p1, p2 = port_hashing.hash_keys(keys)
        r1, r2 = ref_hashing.hash_keys(keys)
        np.testing.assert_array_equal(p1, r1)
        np.testing.assert_array_equal(p2, r2)

    def test_device_string_path_uses_the_fnv_wrapper(self):
        """A string batch over the threshold goes through ops.fnv (its plain
        version on the CPU) and matches the native host lanes."""
        keys = ["w%05d" % i for i in range(6000)]
        assert port_settings.use_device_for(len(keys))
        p1, p2 = port_hashing.hash_keys(keys)
        port_settings.use_device = False
        try:
            h1, h2 = port_hashing.hash_keys(keys)
        finally:
            port_settings.use_device = True
        np.testing.assert_array_equal(p1, h1)
        np.testing.assert_array_equal(p2, h2)

    def test_combine64_matches(self):
        keys = _mixed_keys("str", 50, 1)
        p = port_hashing.combine64(*port_hashing.hash_keys(keys))
        r = ref_hashing.combine64(*ref_hashing.hash_keys(keys))
        np.testing.assert_array_equal(p, r)
