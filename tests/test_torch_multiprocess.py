"""The port's mesh across processes against the JAX package in one process.

The port version of ``tests/test_multiprocess.py``: two OS processes join
a gloo process group (``dampr_tpu_torch.parallel.mesh.init_distributed``
on a localhost port) and form one 8-shard mesh, 4 CPU shards each.  Every
rank drives the same programs on the same seeded inputs; the collectives
cross the processes through host memory.  Each worker prints its results
as JSON, and this process holds them against the JAX package's on its
8-device CPU mesh or its host path: psum, the keyed fold and its
``gather`` variant, the byte exchange (chunked under a budget, the
``gather`` variant), the rings and the SGD step; then DSL pipelines (the
keyed fold, group_by, inner and left joins, sort_by, also under a 256 KiB
exchange budget).  The schedule's ``gather`` sizing is held against the
JAX package's on random shapes.

Every subprocess gets a free port, a gloo timeout (the group's) and a
``communicate`` timeout, so a hang fails its test and nothing else.
"""

import collections
import json
import os
import random
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The seconds a worker pair may take before its test fails.
WORKER_TIMEOUT = 150

_PRELUDE = textwrap.dedent("""
    import json, os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    sys.path.insert(0, @ROOT@)
    from dampr_tpu_torch import settings
    settings.device = "cpu"
    settings.mesh_devices = "cpu*4"
    from dampr_tpu_torch.parallel import mesh as M
    M.GROUP_TIMEOUT_FLOOR_S = 60
    M.init_distributed("localhost:%s" % port, 2, pid)
    assert M.rank_info() == (pid, 2)
    assert settings.device_count_for_auto() == 8
    import numpy as np

    def emit(tag, obj):
        print(tag + "=" + json.dumps(obj), flush=True)
""").replace("@ROOT@", repr(ROOT))

_WORKER = _PRELUDE + textwrap.dedent("""
    from dampr_tpu_torch.ops import hashing
    from dampr_tpu_torch.parallel import (exchange as px, mesh_global_sum,
                                          mesh_keyed_fold, replan, ring, sgd)
    from dampr_tpu_torch.parallel import shuffle
    from dampr_tpu_torch.blocks import Block
    mesh = M.data_mesh()
    assert (mesh.size, mesh.offset, len(mesh.devices)) == (8, 4 * pid, 4)
    info = M.process_info()
    assert info["global_devices"] == 8 and info["multiprocess"]
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 50, size=4096)
    vals = rng.randint(0, 9, size=4096).astype(np.int64)
    h1, h2 = hashing.hash_keys(keys)
    emit("PSUM", mesh_global_sum(mesh, vals))
    fh1, fh2, fv = mesh_keyed_fold(mesh, h1, h2, vals, "sum")
    emit("FOLD", sorted([int(a), int(b), int(v)]
                        for a, b, v in zip(fh1, fh2, fv)))
    # a capacity factor below 1 overflows: the retry doubles it and the
    # psum of the dropped rows agrees on both ranks
    r0 = shuffle.retries
    fh1, fh2, fv = mesh_keyed_fold(mesh, h1, h2, vals, "max",
                                   capacity_factor=0.05)
    emit("FOLDMAX", sorted([int(a), int(b), int(v)]
                           for a, b, v in zip(fh1, fh2, fv)))
    emit("RETRIES", shuffle.retries - r0)

    D = 8
    routed, seq = [], 0
    for src in range(D):
        for tpid in (src, (src + 3) % D, src + D):
            ks = np.array(["k%d_%d" % (tpid, src)], dtype=object)
            vs = np.array([("val", tpid, src)], dtype=object)
            bh1, bh2 = hashing.hash_keys(ks)
            routed.append((seq, src, tpid, Block(ks, vs, bh1, bh2)))
            seq += 1
    received, moved = px.mesh_shuffle_blocks(mesh, routed)
    assert moved > 0
    got = {}
    for rpid, blk in received:
        got.setdefault(str(rpid), []).extend(str(k) for k in blk.keys)
    emit("SHUFFLE", got)

    budget = 1 << 18
    rngb = np.random.RandomState(11)
    blobs = {}
    for s in range(D):
        for d in range(D):
            if (s + d) % 2 == 0:
                n = int(rngb.randint(1, 9000))
                blobs[(s, d)] = rngb.randint(
                    0, 256, size=n).astype(np.uint8).tobytes()
    delivered = px.mesh_blob_exchange(mesh, blobs, budget=budget)
    assert delivered == blobs, "chunked exchange diverged on %d" % pid
    emit("XINFO", {k: px.last_info[k] for k in (
        "steps", "clamped", "peak_inflight_bytes", "bytes")})
    emit("XPLAN", replan.plan_exchange(
        D, {sd: len(b) for sd, b in blobs.items()}, budget=budget,
        gather=True).peak_inflight_bytes)

    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    emit("RSUM", ring.ring_allreduce(mesh, x).tolist())
    emit("RMAX", ring.ring_allreduce(mesh, x * -1, "max").tolist())
    emit("RGATHER", ring.ring_allgather(mesh, x).tolist())
    rs = np.random.RandomState(3)
    X = rs.randn(64, 5).astype(np.float32)
    y = (rs.rand(64) > 0.5).astype(np.float32)
    params, loss = sgd.train_step(mesh, sgd.init_params(5, 0), X, y, 0.5)
    emit("SGD", {"w": params["w"].tolist(), "b": float(params["b"]),
                 "loss": loss})
    emit("STAGED", {"calls": M.cross_rank_calls,
                    "bytes": M.cross_rank_bytes})
    print("PROC_%d_OK" % pid, flush=True)
""")

#: The DSL pipelines both sides run, exec'd verbatim by the workers and
#: by this process with the JAX package's Dampr.
PIPELINES = textwrap.dedent("""
    import operator

    def pipelines(Dampr):
        data = list(range(6000))
        gdata = [(i % 13, i) for i in range(4000)]
        left = [(i % 37, "l%d" % i) for i in range(900)]
        right = [(i % 41, i * 3) for i in range(700)]
        nums = [((i * 2654435761) % 99991) - 50000 for i in range(5000)]
        return {
            "count": Dampr.memory(data, partitions=8).count(
                lambda x: x % 23),
            "fold": Dampr.memory(gdata, partitions=8).fold_by(
                lambda x: x[0], operator.add, value=lambda x: x[1]),
            "group": Dampr.memory(gdata, partitions=8)
                .group_by(lambda x: x[0])
                .reduce(lambda k, vs: sorted(v[1] for v in vs)[:3]),
            "join": Dampr.memory(left, partitions=8)
                .group_by(lambda x: x[0])
                .join(Dampr.memory(right, partitions=8)
                      .group_by(lambda x: x[0]))
                .reduce(lambda l, r: (len(list(l)), sum(v[1] for v in r))),
            "left": Dampr.memory(left, partitions=8)
                .group_by(lambda x: x[0])
                .join(Dampr.memory(right, partitions=8)
                      .group_by(lambda x: x[0]))
                .left_reduce(lambda l, r: (len(list(l)), len(list(r)))),
            "sort": Dampr.memory(nums, partitions=8).sort_by(lambda x: x),
        }
""")

_ENGINE_WORKER = _PRELUDE + textwrap.dedent("""
    from dampr_tpu_torch import Dampr
    from dampr_tpu_torch.parallel import exchange as px
    from dampr_tpu_torch.runner import MTRunner
    settings.scratch_root = os.path.join(os.environ["MP_SCRATCH"],
                                         "rank%d" % pid)
    settings.partitions = 8
    exec(@PIPELINES@)
    out = {}
    for budget in (None, 256 * 1024):
        for name, pipe in pipelines(Dampr).items():
            settings.mesh_fold = "on" if name in ("count", "fold") else "off"
            settings.mesh_exchange = "off" if name in ("count",
                                                       "fold") else "on"
            if budget is not None:
                settings.exchange_hbm_budget = budget
            x0 = px.total_exchanges
            # sort_by's range read exchanges what is past the budget
            kw = {"memory_budget": 1 << 16} if name == "sort" else {}
            runner = MTRunner("mp-%s-%s" % (name, budget),
                              pipe.pmer.graph, **kw)
            res = runner.run([pipe.source])[0]
            st = runner.run_summary
            if name in ("count", "fold"):
                assert st["mesh"]["folds"] >= 1, (name, st["mesh"])
            elif name != "sort":
                assert px.total_exchanges > x0, name
                host = st["mesh"]["exchange"].get("host_staging")
                assert host and host["calls"] > 0, st["mesh"]["exchange"]
            recs = [repr(r) for r in res.read()]
            assert name in ("count", "fold") or px.total_exchanges > x0
            out["%s-%s" % (name, budget)] = (
                recs if name == "sort" else sorted(recs))
    emit("ENGINE", out)
    print("ENGINE_%d_OK" % pid, flush=True)
""").replace("@PIPELINES@", repr(PIPELINES))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(tmp_path, source, ok_marker, env_extra=None):
    """Two rank processes of ``source``; returns each rank's
    ``{tag: value}`` of its emitted JSON lines."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("DAMPR_TPU_TORCH_COORDINATOR", None)
    env.update(env_extra or {})
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(source)
    procs = [subprocess.Popen(
        [sys.executable, script, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    emitted = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (i, out[-2000:], err[-3000:])
        assert ok_marker % i in out, (i, out[-2000:], err[-2000:])
        tags = {}
        for line in out.splitlines():
            tag, eq, payload = line.partition("=")
            if eq and tag.isupper():
                tags[tag] = json.loads(payload)
        emitted.append(tags)
    return emitted


class TestTwoProcessBackend:
    def test_collectives_across_processes(self, tmp_path, mesh8):
        """psum, the keyed fold (with an overflow retry), the byte
        exchange, the rings and the SGD step across two gloo ranks equal
        the JAX package's on its 8-device mesh, on both ranks."""
        from dampr_tpu.ops import hashing
        from dampr_tpu.parallel import (mesh_global_sum, mesh_keyed_fold,
                                        replan, ring, sgd)

        ranks = _spawn_workers(tmp_path, _WORKER, "PROC_%d_OK")
        rng = np.random.RandomState(7)
        keys = rng.randint(0, 50, size=4096)
        vals = rng.randint(0, 9, size=4096).astype(np.int64)
        h1, h2 = hashing.hash_keys(keys)
        fold = sorted([int(a), int(b), int(v)] for a, b, v in zip(
            *mesh_keyed_fold(mesh8, h1, h2, vals, "sum")))
        fmax = sorted([int(a), int(b), int(v)] for a, b, v in zip(
            *mesh_keyed_fold(mesh8, h1, h2, vals, "max")))
        x = np.arange(64, dtype=np.float32).reshape(16, 4)
        rs = np.random.RandomState(3)
        X = rs.randn(64, 5).astype(np.float32)
        y = (rs.rand(64) > 0.5).astype(np.float32)
        params, loss = sgd.train_step(mesh8, sgd.init_params(5, 0), X, y,
                                      0.5)
        want_shuffle = collections.defaultdict(list)
        seq = 0
        for src in range(8):
            for tpid in (src, (src + 3) % 8, src + 8):
                want_shuffle[str(tpid)].append((seq, "k%d_%d" % (tpid, src)))
                seq += 1
        want_shuffle = {k: [n for _s, n in sorted(v)]
                        for k, v in want_shuffle.items()}
        for tags in ranks:
            assert tags["PSUM"] == mesh_global_sum(mesh8, vals) == \
                int(vals.sum())
            assert tags["FOLD"] == fold
            assert tags["FOLDMAX"] == fmax and tags["RETRIES"] >= 1
            assert tags["SHUFFLE"] == want_shuffle
            info = tags["XINFO"]
            assert info["steps"] > 1 and not info["clamped"]
            assert info["peak_inflight_bytes"] <= 1 << 18
            assert info["peak_inflight_bytes"] == tags["XPLAN"]
            assert np.array_equal(np.array(tags["RSUM"], np.float32),
                                  np.asarray(ring.ring_allreduce(mesh8, x)))
            assert np.array_equal(
                np.array(tags["RMAX"], np.float32),
                np.asarray(ring.ring_allreduce(mesh8, x * -1, "max")))
            assert np.array_equal(np.array(tags["RGATHER"], np.float32),
                                  np.asarray(ring.ring_allgather(mesh8, x)))
            np.testing.assert_allclose(tags["SGD"]["w"], params["w"],
                                       rtol=1e-5, atol=1e-7)
            assert abs(tags["SGD"]["loss"] - loss) < 1e-5
            assert tags["STAGED"]["calls"] > 0
        assert ranks[0]["STAGED"] == ranks[1]["STAGED"]

    def test_engine_pipelines_across_processes(self, tmp_path):
        """DSL runs across the two ranks (the mesh fold; group_by, the
        joins and sort_by through the byte exchange; again under a 256 KiB
        exchange budget) read back the JAX package's records of its
        one-process host path."""
        import dampr_tpu
        from dampr_tpu import settings as ref_settings

        ranks = _spawn_workers(
            tmp_path, _ENGINE_WORKER, "ENGINE_%d_OK",
            env_extra={"MP_SCRATCH": str(tmp_path / "scratch")})
        g = {}
        exec(PIPELINES, g)
        saved = (ref_settings.scratch_root, ref_settings.mesh_fold,
                 ref_settings.mesh_exchange, ref_settings.partitions)
        ref_settings.scratch_root = str(tmp_path / "ref")
        ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
        ref_settings.partitions = 8
        try:
            want = {}
            from dampr_tpu.runner import MTRunner

            for name, pipe in g["pipelines"](dampr_tpu.Dampr).items():
                res = MTRunner("ref-" + name, pipe.pmer.graph).run(
                    [pipe.source])[0]
                recs = [repr(r) for r in res.read()]
                want[name] = recs if name == "sort" else sorted(recs)
        finally:
            (ref_settings.scratch_root, ref_settings.mesh_fold,
             ref_settings.mesh_exchange, ref_settings.partitions) = saved
        for tags in ranks:
            got = tags["ENGINE"]
            for name, recs in want.items():
                for budget in ("None", str(256 * 1024)):
                    assert got["%s-%s" % (name, budget)] == recs, (
                        name, budget)


class TestExchangeScheduleGather:
    """The ``gather`` variant's schedule (a third copy of each step's
    buffer in flight) against the JAX package's on random shapes."""

    def _sizes(self, rng, n_dev):
        return {(s, d): rng.randrange(0, rng.choice([10, 1000, 100000]))
                for s in range(n_dev) for d in range(n_dev)
                if rng.random() < 0.6}

    @pytest.mark.parametrize("gather", [False, True])
    def test_schedules_equal_reference(self, gather):
        from dampr_tpu.parallel import replan as ref_replan
        from dampr_tpu_torch.parallel import replan

        rng = random.Random(42 + gather)
        for trial in range(100):
            n_dev = rng.choice([2, 4, 8, 16])
            floor = replan.step_inflight_bytes(n_dev, replan.MIN_CAPACITY,
                                               gather)
            assert floor == ref_replan.step_inflight_bytes(
                n_dev, ref_replan.MIN_CAPACITY, gather)
            budget = rng.randrange(floor, 64 * floor)
            sizes = self._sizes(rng, n_dev)
            a = replan.plan_exchange(n_dev, sizes, budget=budget,
                                     gather=gather)
            b = ref_replan.plan_exchange(n_dev, sizes, budget=budget,
                                         gather=gather)
            assert a.peak_inflight_bytes == b.peak_inflight_bytes <= budget
            assert [(s.capacity, s.cells) for s in a.steps] == [
                (s.capacity, s.cells) for s in b.steps], trial

    def test_gather_holds_a_third_copy(self):
        from dampr_tpu_torch.parallel import replan

        for n_dev in (2, 4, 8):
            c = 1 << 12
            two = replan.step_inflight_bytes(n_dev, c, False)
            three = replan.step_inflight_bytes(n_dev, c, True)
            assert three * 2 == two * 3


class TestProcessGroup:
    def test_incomplete_deployment_raises(self, monkeypatch):
        """A coordinator without the rank's id and count raises; it never
        runs as one process."""
        from dampr_tpu_torch.parallel import mesh

        monkeypatch.setenv("DAMPR_TPU_TORCH_COORDINATOR", "localhost:1")
        monkeypatch.delenv("DAMPR_TPU_TORCH_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("DAMPR_TPU_TORCH_PROCESS_ID", raising=False)
        with pytest.raises(ValueError, match="NUM_PROCESSES"):
            mesh.maybe_init_distributed()
        assert not mesh.is_initialized()

    def test_no_coordinator_is_one_process(self, monkeypatch):
        from dampr_tpu_torch.parallel import mesh

        monkeypatch.delenv("DAMPR_TPU_TORCH_COORDINATOR", raising=False)
        assert mesh.maybe_init_distributed() is False
        assert mesh.process_info()["multiprocess"] is False

    def test_group_timeout_outlasts_the_watchdog(self, monkeypatch):
        from dampr_tpu_torch import settings
        from dampr_tpu_torch.parallel import mesh

        for ms in (0, 6000, 400000):
            monkeypatch.setattr(settings, "exchange_timeout_ms", ms)
            assert mesh.group_timeout_seconds() > ms / 1000.0
