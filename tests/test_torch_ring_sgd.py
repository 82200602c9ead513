"""Rings (B9), the data-parallel SGD step (B10) and the mesh fold's
collective spans of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_capabilities.py::TestRingCollectives``
(3 cases), ``tests/test_sgd_and_entry.py::TestSGD`` (3 cases) and
``tests/test_observability.py::test_mesh_fold_emits_collective_spans``,
with the four one-process collectives the programs share.
The JAX package runs on its 8-device CPU rig, the port on a mesh of 8
CPU shards, on the same seeded numpy inputs; the JAX package's
``init_params`` is the port's input.  Tolerances: rings exact for
integers, rtol 1e-6 for the float32 sum (as the JAX test), exact for
max/min and gathers; SGD as ``tests/test_sgd_and_entry.py`` states them
(one step: rtol 1e-4, atol 1e-6 on ``w``, 1e-5 on the loss; trajectories:
rtol 1e-3, atol 1e-5 on ``w``, 1e-4 on the loss).
"""

import json
import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.parallel import ring as ref_ring
from dampr_tpu.parallel import sgd as ref_sgd
from dampr_tpu_torch import settings
from dampr_tpu_torch.parallel import mesh as port_mesh
from dampr_tpu_torch.parallel import ring, sgd


@pytest.fixture
def pmesh8():
    old = (settings.device, settings.mesh_devices)
    settings.device = "cpu"
    settings.mesh_devices = ["cpu"] * 8
    try:
        yield port_mesh.data_mesh()
    finally:
        settings.device, settings.mesh_devices = old


class TestRingCollectives:
    def test_ring_allreduce_matches_sum(self, mesh8, pmesh8):
        x = np.arange(8 * 16, dtype=np.float32)
        out = ring.ring_allreduce(pmesh8, x)
        total = x.reshape(8, 16).sum(axis=0)
        for d in range(8):
            np.testing.assert_allclose(out.reshape(8, 16)[d], total,
                                       rtol=1e-6)
        np.testing.assert_allclose(out, ref_ring.ring_allreduce(mesh8, x),
                                   rtol=1e-6)
        xi = np.arange(8 * 16, dtype=np.int64) * 977
        got = ring.ring_allreduce(pmesh8, xi)
        assert (got.reshape(8, 16) == xi.reshape(8, 16).sum(0)).all()

    @pytest.mark.parametrize("op", ["max", "min"])
    def test_ring_allreduce_max(self, mesh8, pmesh8, op):
        rng = np.random.RandomState(1)
        x = rng.randn(8 * 32).astype(np.float32)
        out = ring.ring_allreduce(pmesh8, x, op=op)
        want = getattr(x.reshape(8, 32), op)(axis=0)
        for d in range(8):
            assert (out.reshape(8, 32)[d] == want).all()
        assert (out == ref_ring.ring_allreduce(mesh8, x, op=op)).all()

    def test_ring_allgather(self, mesh8, pmesh8):
        x = np.arange(8 * 4, dtype=np.float32)
        out = ring.ring_allgather(pmesh8, x)
        assert (out == ref_ring.ring_allgather(mesh8, x)).all()
        out = out.reshape(8, 32)
        for d in range(8):
            assert (out[d] == x).all()


def test_collectives_move_in_shard_order(pmesh8):
    """The four collectives of a mesh in one process: all_to_all
    transposes the shards' rows, psum sums, all_gather concatenates in
    shard order and ppermute sends each shard to its ring neighbour;
    every result lies on its shard's device, exactly."""
    import torch

    D = 8
    bufs = [torch.arange(D * 3, dtype=torch.int64).reshape(D, 3) + 100 * s
            for s in range(D)]
    recv = port_mesh.all_to_all(pmesh8, bufs)
    for d in range(D):
        assert torch.equal(recv[d], torch.stack([bufs[s][d]
                                                 for s in range(D)]))
    xs = [torch.tensor([s, -s]) for s in range(D)]
    assert all(torch.equal(t, torch.tensor([28, -28]))
               for t in port_mesh.psum(pmesh8, xs))
    assert all(torch.equal(t, torch.cat(xs))
               for t in port_mesh.all_gather(pmesh8, xs))
    assert [int(t[0]) for t in port_mesh.ppermute(pmesh8, xs)] == \
        [7, 0, 1, 2, 3, 4, 5, 6]
    assert all(t.device == dev for t, dev in zip(recv, pmesh8.devices))


def _problem(seed, n, f):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32)
    return X, (X @ w > 0).astype(np.float32)


class TestSGD:
    def test_single_step_gradient_matches_host(self, mesh8, pmesh8):
        X, y = _problem(1, 128, 16)
        p0 = ref_sgd.init_params(16)
        assert (sgd.init_params(16)["w"] == p0["w"]).all()
        p1, loss = sgd.train_step(pmesh8, p0, X, y, lr=0.5)
        logits = X @ p0["w"] + p0["b"]
        s = 1.0 / (1.0 + np.exp(-logits))
        gl = (s - y) / len(y)
        np.testing.assert_allclose(p1["w"], p0["w"] - 0.5 * (X.T @ gl),
                                   rtol=1e-4, atol=1e-6)
        want_loss = np.mean(np.maximum(logits, 0) - logits * y
                            + np.log1p(np.exp(-np.abs(logits))))
        assert abs(loss - want_loss) < 1e-5
        r1, rloss = ref_sgd.train_step(mesh8, p0, X, y, lr=0.5)
        np.testing.assert_allclose(p1["w"], np.asarray(r1["w"]),
                                   rtol=1e-4, atol=1e-6)
        assert abs(loss - float(rloss)) < 1e-5

    def test_eight_device_trajectory_matches_one_device(self, mesh8,
                                                        pmesh8):
        X, y = _problem(5, 64, 8)
        one = port_mesh.data_mesh(["cpu"])
        p8, l8 = sgd.train(pmesh8, X, y, n_steps=10, lr=0.5)
        p1, l1 = sgd.train(one, X, y, n_steps=10, lr=0.5)
        np.testing.assert_allclose(p8["w"], p1["w"], rtol=1e-3, atol=1e-5)
        assert abs(l8 - l1) < 1e-4
        r8, rl8 = ref_sgd.train(mesh8, X, y, n_steps=10, lr=0.5)
        np.testing.assert_allclose(p8["w"], np.asarray(r8["w"]), rtol=1e-3,
                                   atol=1e-5)
        assert abs(l8 - rl8) < 1e-4

    def test_accuracy_improves(self, mesh8, pmesh8):
        X, y = _problem(2, 256, 8)
        params, _ = sgd.train(pmesh8, X, y, n_steps=40, lr=1.0)
        pred = (X @ params["w"] + params["b"]) > 0
        assert (pred == (y > 0.5)).mean() > 0.9
        ref, _ = ref_sgd.train(mesh8, X, y, n_steps=40, lr=1.0)
        np.testing.assert_allclose(params["w"], np.asarray(ref["w"]),
                                   rtol=1e-3, atol=1e-5)


def test_mesh_fold_emits_collective_spans(pmesh8, tmp_path):
    """On the 8-shard mesh the associative fold rides the keyed fold
    program and records ``collective`` spans, as on the JAX package's
    8-device rig; the records equal the JAX package's."""
    old = (settings.trace, settings.trace_dir, settings.scratch_root,
           ref_settings.trace, ref_settings.trace_dir)
    settings.trace = ref_settings.trace = True
    settings.trace_dir = str(tmp_path / "port")
    ref_settings.trace_dir = str(tmp_path / "ref")
    settings.scratch_root = str(tmp_path / "port-scratch")
    try:
        cats, outs = [], []
        for D in (dampr_tpu.Dampr, dampr_tpu_torch.Dampr):
            em = (D.memory(list(range(20000)))
                  .map(lambda x: (x % 31, 1))
                  .fold_by(lambda kv: kv[0], operator.add,
                           lambda kv: kv[1])
                  .run(name="obs-mesh"))
            out = dict(em.read())
            assert sum(out.values()) == 20000
            outs.append(out)
            path = em.stats()["trace_file"]
            assert path and os.path.isfile(path)
            with open(path) as f:
                doc = json.load(f)
            cats.append({ev.get("cat") for ev in doc["traceEvents"]
                         if ev.get("ph") in ("X", "i")})
            em.delete()
        assert "collective" in cats[0] and "collective" in cats[1]
        assert outs[1] == outs[0]
    finally:
        (settings.trace, settings.trace_dir, settings.scratch_root,
         ref_settings.trace, ref_settings.trace_dir) = old
