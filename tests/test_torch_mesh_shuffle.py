"""The mesh keyed fold (B7) of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_mesh_shuffle.py``'s 11 cases: the JAX
package's ``mesh_keyed_fold``/``mesh_global_sum`` on its 8-device CPU rig
(``mesh8``) and the port's on a mesh of 8 CPU shards
(``settings.mesh_devices``), on the same seeded inputs.  Integer folds
must give the same (key, value) records exactly; float32 folds agree
within 1e-4 (the JAX test's bound against the host sum), global sums
exactly for integers and within 1e-3 for float32.  Added: the overflow
retry must run, both lowerings and min/max at D = 8 against the host,
``mesh_keyed_refold``/``compact_partial`` over the mesh, and the program
on a mesh of one shard (the local fold alone) against the D = 8 one.
"""

import collections

import numpy as np
import pytest

from dampr_tpu.ops import hashing as ref_hashing
from dampr_tpu.parallel import mesh_global_sum as ref_global_sum
from dampr_tpu.parallel import mesh_keyed_fold as ref_fold
from dampr_tpu.parallel.mesh import mesh_size as ref_mesh_size
from dampr_tpu_torch import settings
from dampr_tpu_torch.ops import hashing
from dampr_tpu_torch.parallel import mesh as port_mesh
from dampr_tpu_torch.parallel import shuffle

from conftest import reference_text


@pytest.fixture
def pmesh8():
    """A mesh of 8 CPU shards, the rig restored afterwards."""
    old = (settings.device, settings.mesh_devices)
    settings.device = "cpu"
    settings.mesh_devices = ["cpu"] * 8
    try:
        yield port_mesh.data_mesh()
    finally:
        settings.device, settings.mesh_devices = old


def _fold_to_dict(keyspace, fh1, fh2, fv):
    kh1, kh2 = ref_hashing.hash_keys(np.asarray(keyspace))
    lookup = {(int(a), int(b)): k
              for k, (a, b) in zip(keyspace, zip(kh1, kh2))}
    return {lookup[(int(a), int(b))]: v
            for a, b, v in zip(fh1, fh2, np.asarray(fv).tolist())}


def _both(mesh8, pmesh8, keyspace, h1, h2, vals, kind, **kw):
    ref = _fold_to_dict(keyspace, *ref_fold(mesh8, h1, h2, vals, kind, **kw))
    port = _fold_to_dict(keyspace, *shuffle.mesh_keyed_fold(
        pmesh8, h1, h2, vals, kind, **kw))
    return ref, port


def _host_sum(keys, vals):
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0) + v
    return want


class TestMeshKeyedFold:
    def test_eight_devices(self, mesh8, pmesh8):
        assert port_mesh.mesh_size(pmesh8) == ref_mesh_size(mesh8) == 8
        assert [str(d) for d in pmesh8.devices] == ["cpu"] * 8
        assert pmesh8.shape == {"shards": 8}

    def test_sum_matches_host(self, mesh8, pmesh8):
        rng = np.random.RandomState(7)
        keys = rng.randint(0, 1000, size=50000)
        vals = rng.randint(0, 50, size=50000).astype(np.int64)
        # the port hashes keys as the JAX package does
        h1, h2 = hashing.hash_keys(keys)
        r1, r2 = ref_hashing.hash_keys(keys)
        assert (h1 == r1).all() and (h2 == r2).all()
        ref, port = _both(mesh8, pmesh8, list(range(1000)), h1, h2, vals,
                          "sum")
        assert port == ref == _host_sum(keys, vals)

    def test_sum_negative_values_scatter_path(self, mesh8, pmesh8):
        rng = np.random.RandomState(11)
        keys = rng.randint(0, 500, size=30000)
        vals = rng.randint(-50, 50, size=30000).astype(np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        ref, port = _both(mesh8, pmesh8, list(range(500)), h1, h2, vals,
                          "sum")
        assert port == ref == _host_sum(keys, vals)

    def test_scan_and_scatter_lowerings_agree(self, mesh8, pmesh8):
        rng = np.random.RandomState(13)
        keys = rng.randint(0, 777, size=20000)
        vals = rng.randint(0, 9, size=20000).astype(np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        a_ref, a = _both(mesh8, pmesh8, list(range(777)), h1, h2, vals,
                         "sum")
        vals2 = np.concatenate([vals, np.array([-1, 1], dtype=np.int64)])
        extra = ref_hashing.hash_keys(np.array([999888, 999888]))
        h1b = np.concatenate([h1, extra[0]])
        h2b = np.concatenate([h2, extra[1]])
        b_ref, b = _both(mesh8, pmesh8, list(range(777)) + [999888], h1b,
                         h2b, vals2, "sum")
        assert b.pop(999888) == 0 and b_ref.pop(999888) == 0
        assert a == b == a_ref == b_ref

    def test_min_max(self, mesh8, pmesh8):
        rng = np.random.RandomState(3)
        keys = rng.randint(0, 64, size=4096)
        vals = rng.randint(-1000, 1000, size=4096).astype(np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        for kind, fn in (("min", np.min), ("max", np.max)):
            ref, port = _both(mesh8, pmesh8, list(range(64)), h1, h2, vals,
                              kind)
            assert port == ref
            for k in set(keys.tolist()):
                assert port[k] == fn(vals[keys == k])

    def test_overflow_retry_is_exact(self, mesh8, pmesh8):
        # 4000 distinct keys and a capacity of 8 rows per destination:
        # every shard overflows until the capacity has doubled enough
        keys = np.arange(40000) % 4000
        vals = np.ones(40000, dtype=np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        before = shuffle.retries
        ref, port = _both(mesh8, pmesh8, list(range(4000)), h1, h2, vals,
                          "sum", capacity_factor=0.001)
        assert shuffle.retries - before >= 3
        assert port == ref == {k: 10 for k in range(4000)}

    def test_overflow_retry_skewed_pairs(self, mesh8, pmesh8):
        # the JAX test's case: two keys, a tiny factor
        keys = np.array([1, 2] * 5000)
        vals = np.ones(10000, dtype=np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        ref, port = _both(mesh8, pmesh8, [1, 2], h1, h2, vals, "sum",
                          capacity_factor=0.02)
        assert port == ref == {1: 5000, 2: 5000}

    def test_string_keys_wordcount(self, mesh8, pmesh8):
        words = (reference_text() * 5).split()
        h1, h2 = ref_hashing.hash_keys(words)
        want = collections.Counter(words)
        ones = np.ones(len(words), dtype=np.int64)
        ref, port = _both(mesh8, pmesh8, list(want), h1, h2, ones, "sum")
        assert port == ref == dict(want)

    def test_empty(self, mesh8, pmesh8):
        e = (np.empty(0, np.uint32), np.empty(0, np.uint32),
             np.empty(0, np.int64))
        assert len(ref_fold(mesh8, *e, "sum")[0]) == 0
        fh1, fh2, fv = shuffle.mesh_keyed_fold(pmesh8, *e, "sum")
        assert len(fh1) == len(fh2) == len(fv) == 0
        raw = shuffle.mesh_keyed_fold(pmesh8, *e, "sum", raw=True)
        assert all(t.shape[0] == 0 for t in raw)

    def test_float_values(self, mesh8, pmesh8):
        keys = np.arange(100) % 10
        vals = np.linspace(0, 1, 100).astype(np.float32)
        h1, h2 = ref_hashing.hash_keys(keys)
        ref, port = _both(mesh8, pmesh8, list(range(10)), h1, h2, vals,
                          "sum")
        for k in range(10):
            host = vals[keys == k].sum()
            assert abs(port[k] - host) < 1e-4
            assert abs(port[k] - ref[k]) < 1e-4

    def test_float64_refused(self, pmesh8):
        h1, h2 = ref_hashing.hash_keys(np.arange(10))
        with pytest.raises(ValueError):
            shuffle.mesh_keyed_fold(pmesh8, h1, h2,
                                    np.ones(10, dtype=np.float64), "sum")


class TestGlobalSum:
    def test_int(self, mesh8, pmesh8):
        vals = np.arange(10001, dtype=np.int64)
        got = shuffle.mesh_global_sum(pmesh8, vals)
        assert got == ref_global_sum(mesh8, vals) == int(vals.sum())

    def test_float(self, mesh8, pmesh8):
        vals = np.ones(1000, dtype=np.float32) * 0.5
        got = shuffle.mesh_global_sum(pmesh8, vals)
        assert abs(got - 500.0) < 1e-3
        assert abs(got - ref_global_sum(mesh8, vals)) < 1e-3


class TestRefold:
    @pytest.mark.parametrize("kind", ["sum", "min", "max"])
    def test_refold_of_windows_matches_jax(self, mesh8, pmesh8, kind):
        """Three windows folded raw, then refolded and compacted over the
        mesh, against the JAX package's same chain."""
        from dampr_tpu.parallel import shuffle as ref_shuffle

        rng = np.random.RandomState(23)
        ref_parts, port_parts = [], []
        keys_all, vals_all = [], []
        for n in (3000, 1, 777):
            keys = rng.randint(0, 300, size=n)
            vals = rng.randint(0, 100, size=n).astype(np.int64)
            keys_all.append(keys)
            vals_all.append(vals)
            h1, h2 = ref_hashing.hash_keys(keys)
            ref_parts.append(ref_shuffle.mesh_keyed_fold(
                mesh8, h1, h2, vals, kind, raw=True))
            port_parts.append(shuffle.mesh_keyed_fold(
                pmesh8, h1, h2, vals, kind, raw=True))
        nonneg = kind == "sum"
        ref = ref_shuffle.compact_partial(ref_shuffle.mesh_keyed_refold(
            mesh8, ref_parts, kind, nonneg=nonneg))
        port = shuffle.compact_partial(shuffle.mesh_keyed_refold(
            pmesh8, port_parts, kind, nonneg=nonneg))

        def rows(h1, h2, v, ok, view):
            m = view(ok) == 1
            return sorted(zip(view(h1)[m].view(np.uint32).tolist(),
                              view(h2)[m].view(np.uint32).tolist(),
                              view(v)[m].tolist()))

        want = rows(*ref, view=np.asarray)
        assert len(want) == len(set(np.concatenate(keys_all).tolist()))
        assert rows(*port, view=lambda t: t.numpy()) == want

    def test_one_shard_program_equals_eight(self, pmesh8):
        """D = 1 runs the local fold alone (no pack, no copy): its live
        rows equal the 8-shard program's."""
        rng = np.random.RandomState(29)
        keys = rng.randint(0, 2000, size=20000)
        vals = rng.randint(0, 7, size=20000).astype(np.int64)
        h1, h2 = ref_hashing.hash_keys(keys)
        one = port_mesh.data_mesh(["cpu"])
        got1 = shuffle.mesh_keyed_fold(one, h1, h2, vals, "sum", raw=True)
        assert got1[0].shape[0] == 32768  # the pow2 pad of the input
        a = _fold_to_dict(list(range(2000)), *shuffle.mesh_keyed_fold(
            one, h1, h2, vals, "sum"))
        b = _fold_to_dict(list(range(2000)), *shuffle.mesh_keyed_fold(
            pmesh8, h1, h2, vals, "sum"))
        assert a == b == _host_sum(keys, vals)
